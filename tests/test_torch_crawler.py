"""The port's crawl roles (stract_tpu_torch/crawler/*) and live crawler
(live_index/crawler.py) against the JAX package's, on the CPU.

Tolerance: none — every comparison is exact. Robots answers (allow,
disallow, crawl-delay, sitemaps) on 60 seeded robots.txt files x 40 paths x
4 user agents; FileQueue files byte-equal and read by the other package;
JobExecutor over tests/test_crawler_live.py's fake fetcher and over a seeded
site (robots, 429s, wandering): the same CrawlDatums, discovered URLs and
WARC files byte for byte (the WARC clock and uuid4 pinned in both, as
tests/test_torch_indexer.py pins them); make_crawl_plan and write_plan the
same jobs and queue files; the coordinator, router and worker over sonic,
each package's worker through the other's router and coordinator; the live
crawler's batches on a seeded fake web of feeds, sitemaps and front pages;
and `main.py crawler` roles as processes, each answering one call. No test
sleeps for politeness: sleep_fn is recorded, and every wait is bounded.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

from test_crawler_live import fake_fetch
from test_torch_indexer import pinned, tree_diff

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AGENTS = ("StractTpuBot/1.0", "SomeBot", "otherbot-2", "Mozilla/5.0 (compatible)")


def _mods(name: str):
    import importlib

    return (importlib.import_module(f"stract_tpu.{name}"),
            importlib.import_module(f"stract_tpu_torch.{name}"))


# ---- robots.txt ------------------------------------------------------------------------
def _robots_file(rng) -> tuple:
    segs = ["/", "/a", "/a/b", "/private", "/tmp", "/docs", "/%7Euser", "/img", "/q"]
    pats = segs + ["/*.pdf$", "/a*", "/*?q=", "/docs/$", "", "/a/b$", "*", "/private/ok"]
    lines = []
    for _ in range(int(rng.integers(1, 4))):
        for _ in range(int(rng.integers(1, 3))):
            ua = rng.choice(["*", "StractTpuBot", "stracttpubot", "OtherBot", "somebot"])
            lines.append(f"{rng.choice(['User-agent', 'user-agent', 'USER-AGENT'])}: {ua}")
        for _ in range(int(rng.integers(0, 6))):
            key = rng.choice(["Allow", "Disallow", "disallow", "Crawl-delay", "Noindex"])
            if key == "Crawl-delay":
                val = rng.choice(["1", "2.5", "x", "0", "10"])
            else:
                val = rng.choice(pats)
            comment = " # note" if rng.random() < 0.2 else ""
            lines.append(f"{key}: {val}{comment}")
        if rng.random() < 0.3:
            lines.append(f"Sitemap: https://s{int(rng.integers(9))}.com/sitemap.xml")
        lines.append("")
    paths = [str(rng.choice(segs)) + str(rng.choice(["", "/x", ".pdf", "?q=1", "/", "/ok"]))
             for _ in range(40)]
    return "\n".join(lines), paths


def test_robots_answer_as_in_the_jax_package():
    jax, port = _mods("crawler.robots")
    rng = np.random.default_rng(270)
    allowed = 0
    for _ in range(60):
        text, paths = _robots_file(rng)
        a, b = jax.Robots.parse(text), port.Robots.parse(text)
        assert b.sitemaps == a.sitemaps
        for ua in AGENTS:
            assert b.crawl_delay(ua) == a.crawl_delay(ua), (text, ua)
            for p in paths:
                assert b.is_allowed(ua, p) == a.is_allowed(ua, p), (text, ua, p)
                allowed += a.is_allowed(ua, p)
    assert 0 < allowed < 60 * 40 * len(AGENTS)  # both answers occur


# ---- the file queue --------------------------------------------------------------------
def test_file_queue_files_are_the_jax_packages_and_read_across(tmp_path):
    jax, port = _mods("crawler.file_queue")
    rng = np.random.default_rng(271)
    items = [{"domain": f"d{i}.com", "urls": [f"https://d{i}.com/{k}" for k in
                                                 range(int(rng.integers(0, 5)))],
              "wandering_urls": int(rng.integers(0, 9))} for i in range(40)]
    for mod, name in ((jax, "jax"), (port, "port")):
        q = mod.FileQueue(str(tmp_path / name / "q"))
        q.push(items[0])
        q.push_many(items[1:])
        assert q.pop() == items[0] and q.pop() == items[1]
    assert tree_diff(str(tmp_path / "jax"), str(tmp_path / "port")) == []
    # each package reads on from where the other stopped
    for reader, writer in ((port, "jax"), (jax, "port")):
        q = reader.FileQueue(str(tmp_path / writer / "q"))
        assert len(q) == 38 and q.pop() == items[2]
        rest = [q.pop() for _ in range(37)]
        assert rest == items[3:] and q.pop() is None and len(q) == 0


# ---- the worker ------------------------------------------------------------------------
def _seeded_site(rng, domain: str = "seed.com", external: bool = True) -> dict:
    """A site of 30 pages linking each other (and out, if `external`), a
    robots.txt with a disallowed path and a crawl delay."""
    pages = {f"https://{domain}/robots.txt":
             (200, "User-agent: *\nDisallow: /p/7\nCrawl-delay: 2\n")}
    for i in range(30):
        links = " ".join(f'<a href="/p/{int(j)}">p{int(j)}</a>'
                         for j in rng.choice(30, size=5, replace=False))
        ext = f'<a href="https://ext{i % 4}.org/x">ext</a>' if external else ""
        pages[f"https://{domain}/p/{i}"] = (
            200, f"<html><head><title>page {i}</title></head><body><p>words {i} "
                 f"{' '.join(map(str, rng.integers(0, 99, 8)))}</p>{links} {ext}</body></html>")
    pages[f"https://{domain}/"] = (200, '<html><body><a href="/p/0">0</a><a href="/p/1">1</a>'
                                        '<a href="/p/7">7</a></body></html>')
    return pages


def _fetcher(pages: dict, throttle: str = ""):
    seen = {}

    def fetch(url, timeout=30.0):
        seen[url] = seen.get(url, 0) + 1
        if url == throttle and seen[url] <= 2:
            return 429, "", 3
        status, body = pages.get(url, (404, ""))
        return status, body, 5
    return fetch


def _run_executor(pkg, tmp_path, job_json, fetch):
    import importlib

    worker = importlib.import_module(f"{pkg}.crawler.worker")
    coord = importlib.import_module(f"{pkg}.crawler.coordinator")
    warc = importlib.import_module(f"{pkg}.warc")
    sleeps = []
    path = str(tmp_path / f"{pkg}.warc.gz")
    with pinned():
        w = warc.WarcWriter.open(path)
        ex = worker.JobExecutor(coord.Job.from_json(job_json), fetch_fn=fetch, warc_writer=w,
                                sleep_fn=sleeps.append)
        data = ex.run()
        w.close()
    with open(path, "rb") as fh:
        blob = fh.read()
    return ([dataclasses.astuple(d) for d in data], [u.to_json() for u in ex.discovered],
            blob, sleeps, sorted(ex.crawled))


@pytest.mark.parametrize("case", ["fake fetcher", "seeded site"])
def test_job_executor_crawls_as_in_the_jax_package(tmp_path, case):
    if case == "fake fetcher":
        job = {"domain": "site.com", "urls": ["https://site.com/", "https://site.com/secret"],
               "wandering_urls": 2}
        fetches = (fake_fetch, fake_fetch)
    else:
        pages = _seeded_site(np.random.default_rng(272))
        job = {"domain": "seed.com", "urls": ["https://seed.com/", "https://seed.com/p/3",
                                              "https://seed.com/p/7"], "wandering_urls": 12}
        fetches = tuple(_fetcher(pages, throttle="https://seed.com/p/3") for _ in range(2))
    a = _run_executor("stract_tpu", tmp_path, job, fetches[0])
    b = _run_executor("stract_tpu_torch", tmp_path, job, fetches[1])
    assert b[0] == a[0] and b[1] == a[1] and b[3] == a[3] and b[4] == a[4]
    assert b[2] == a[2]  # the WARC files, byte for byte
    assert gzip.decompress(b[2]).count(b"WARC/1.0") == len(a[0]) > 1
    disallowed = "https://site.com/secret" if case == "fake fetcher" else "https://seed.com/p/7"
    assert disallowed not in [d[0] for d in a[0]] and a[1]


def test_crawl_plans_are_the_jax_packages(tmp_path):
    jax, port = _mods("crawler.planner")
    rng = np.random.default_rng(273)
    hosts = [f"h{i}.com" for i in range(60)]
    cent = {h: float(rng.random() ** 3) for h in hosts if rng.random() < 0.8}
    known = {h: [f"https://{h}/{k}" for k in range(int(rng.integers(0, 40)))] for h in hosts}
    for budget, wander in ((500, 0.2), (40, 0.5), (5_000, 0.0)):
        a = [j.to_json() for j in jax.make_crawl_plan(cent, known, budget, wander)]
        b = [j.to_json() for j in port.make_crawl_plan(cent, known, budget, wander)]
        assert a == b and len(a) == sum(1 for h in hosts if known[h])
    jobs_a = jax.make_crawl_plan(cent, known, 500)
    jobs_b = port.make_crawl_plan(cent, known, 500)
    pa = jax.write_plan(jobs_a, str(tmp_path / "jax"))
    pb = port.write_plan(jobs_b, str(tmp_path / "port"))
    assert [os.path.basename(p) for p in pa] == [os.path.basename(p) for p in pb]
    assert tree_diff(str(tmp_path / "jax"), str(tmp_path / "port")) == []


def test_wander_prioritiser_pops_as_in_the_jax_package():
    jax, port = _mods("crawler.wander_prioritiser")
    rng = np.random.default_rng(274)
    a, b = jax.WanderPrioritiser(), port.WanderPrioritiser()
    for _ in range(300):
        url = f"https://{rng.choice(['x.com', 'www.x.com', 'sub.x.com', 'y.org'])}/" \
              f"{int(rng.integers(30))}"
        w = float(rng.choice([1.0, 0.5, 2.0]))
        a.observe(url, w)
        b.observe(url, w)
    assert [b.pop_best("x.com") for _ in range(40)] == [a.pop_best("x.com") for _ in range(40)]
    assert b.pop_best("y.org") == a.pop_best("y.org")


def _crawl_over_sonic(tmp_path, worker_pkg: str, roles_pkg: str, site: str) -> dict:
    """A worker of `worker_pkg` drains a coordinator of `roles_pkg` through
    a router of `roles_pkg`, over sonic → {domain: WARC bytes}."""
    import importlib

    crawler = importlib.import_module(f"{roles_pkg}.crawler")
    sonic = importlib.import_module(f"{roles_pkg}.distributed.sonic")
    worker = importlib.import_module(f"{worker_pkg}.crawler.worker")
    wsonic = importlib.import_module(f"{worker_pkg}.distributed.sonic")
    warc = importlib.import_module(f"{worker_pkg}.warc")
    root = tmp_path / f"{worker_pkg}-{site}"
    out = root / "warc"
    out.mkdir(parents=True)
    web = {**_seeded_site(np.random.default_rng(275), external=False),
           **{u: fake_fetch(u)[:2] for u in ("https://site.com/robots.txt", "https://site.com/",
                                             "https://site.com/a", "https://site.com/b")}}
    urls = {"seed.com": ["https://seed.com/", "https://seed.com/p/4"],
            "site.com": ["https://site.com/"]}[site]
    coord = crawler.CrawlCoordinator(str(root / "jobs"), str(root / "disc"))
    coord.add_jobs([crawler.Job(site, urls, 6), crawler.Job("seed.com", ["https://seed.com/p/9"])])
    csrv = sonic.serve_in_thread(coord)
    rsrv = sonic.serve_in_thread(crawler.Router([csrv.addr]))
    try:
        with pinned():
            w = worker.WorkerThread(wsonic.RemoteClient(rsrv.addr, timeout=60),
                                    fetch_fn=_fetcher(web),
                                    warc_factory=lambda d: warc.WarcWriter.open(
                                        str(out / f"{len(os.listdir(out))}-{d}")),
                                    sleep_fn=lambda s: None)
            assert w.run() == 2
        assert coord.new_job() is None and coord.remaining() == 0
    finally:
        rsrv.stop()
        csrv.stop()
    return {d: (out / d).read_bytes() for d in sorted(os.listdir(out))}


def test_workers_crawl_through_the_other_packages_router_and_coordinator(tmp_path):
    """Each package's worker through the other package's router and
    coordinator: every job done, the same WARC files byte for byte."""
    a = _crawl_over_sonic(tmp_path, "stract_tpu", "stract_tpu_torch", "seed.com")
    b = _crawl_over_sonic(tmp_path, "stract_tpu_torch", "stract_tpu", "seed.com")
    assert list(a) == ["0-seed.com", "1-seed.com"] and b == a
    assert gzip.decompress(a["0-seed.com"]).count(b"WARC/1.0") > 3


def test_a_worker_that_discovers_external_links_fails_in_both_packages(tmp_path):
    """A gap of the reference kept by the port: WorkerThread sends the
    discovered external links to the router as `add_urls`, which the router
    does not serve, so the job's crawl ends in an ApplicationError (the JAX
    package's tests crawl pages without such links)."""
    import importlib

    for worker_pkg, roles_pkg in (("stract_tpu", "stract_tpu_torch"),
                                  ("stract_tpu_torch", "stract_tpu")):
        sonic = importlib.import_module(f"{worker_pkg}.distributed.sonic")
        with pytest.raises(sonic.ApplicationError, match="add_urls"):
            _crawl_over_sonic(tmp_path, worker_pkg, roles_pkg, "site.com")


# ---- the live crawler ------------------------------------------------------------------
def _fake_web(rng, n_sites: int = 6) -> dict:
    """Seeded sites, each with an RSS or Atom feed, a sitemap (every third a
    sitemapindex over two urlsets, raw `&` in some locs) and a front page."""
    web = {}
    for s in range(n_sites):
        host = f"live{s}.com"
        urls = [f"https://{host}/n/{k}" for k in range(12)]
        for k, u in enumerate(urls):
            web[u] = (200, f"<html><head><title>live {s} story {k}</title></head><body><p>fresh "
                           f"news {' '.join(map(str, rng.integers(0, 50, 6)))}</p>"
                           f'<a href="/n/{(k + 1) % 12}">next</a></body></html>')
        items = "".join(f"<item><title>s{k}</title><link>{u}</link></item>" for k, u in
                        enumerate(urls[:4]))
        atom = "".join(f'<entry><title>s{k}</title><link href="{u}"/></entry>' for k, u in
                       enumerate(urls[:4]))
        web[f"https://{host}/feed.xml"] = (200, (
            f'<rss version="2.0"><channel><title>{host}</title>{items}</channel></rss>'
            if s % 2 == 0 else f'<feed xmlns="http://www.w3.org/2005/Atom">{atom}</feed>'))
        locs = [u + ("?a=1&b=2" if k % 5 == 0 else "") for k, u in enumerate(urls[4:10])]
        for u in locs[0::5]:  # the page a raw & in a loc leads to, as recover mode reads it
            web[u.replace("&b", "")] = web[u.split("?")[0]]
        if s % 3 == 0:
            for part in (0, 1):
                web[f"https://{host}/sm{part}.xml"] = (200, "<urlset>" + "".join(
                    f"<url><loc>{u}</loc></url>" for u in locs[part::2]) + "</urlset>")
            web[f"https://{host}/sitemap.xml"] = (200, "<sitemapindex>" + "".join(
                f"<sitemap><loc>https://{host}/sm{p}.xml</loc></sitemap>" for p in (0, 1))
                + "</sitemapindex>")
        else:
            web[f"https://{host}/sitemap.xml"] = (200, "<urlset>" + "".join(
                f"<url><loc>{u}</loc><lastmod>2024-01-01</lastmod></url>" for u in locs)
                + "</urlset>")
        web[f"https://{host}/"] = (200, "<html><body>" + "".join(
            f'<a href="{u}">x</a>' for u in urls[8:]) + '<a href="https://else.org/">e</a>'
            "</body></html>")
    return web


def _live_crawl(pkg: str, tmp_path, web: dict) -> list:
    import importlib

    lc = importlib.import_module(f"{pkg}.live_index.crawler")
    kv = importlib.import_module(f"{pkg}.kv")
    now = [1_700_000_000.0]
    batches = []
    db = kv.Db.open(str(tmp_path / f"{pkg}-crawled"))
    crawler = lc.LiveCrawler(lambda u: (*web.get(u, (404, "")), 1), batches.append,
                             crawled_db=db, clock=lambda: now[0])
    for s in range(6):
        crawler.add_site(f"live{s}.com", feeds=[f"https://live{s}.com/feed.xml"],
                         sitemaps=[f"https://live{s}.com/sitemap.xml"])
    counts = []
    for dt in (0, 700, 1900, 3700):
        now[0] += dt
        counts.append(crawler.tick())
    return batches, counts, {s: dataclasses.astuple(c) for s, c in crawler.checkers.items()}


def test_live_crawler_batches_as_in_the_jax_package(tmp_path):
    web = _fake_web(np.random.default_rng(276))
    a = _live_crawl("stract_tpu", tmp_path, web)
    b = _live_crawl("stract_tpu_torch", tmp_path, web)
    assert b == a
    batches, counts, _ = a
    # 12 pages a site; a sitemapindex's urlsets are read at the next sitemap
    # check (an hour on), and the crawled db dedups what comes again
    assert counts == [68, 0, 0, 10]
    urls = [u for batch in batches for u, _ in batch]
    assert any(u.endswith("?a=1=2") for u in urls)  # a raw & in a loc, as recover mode reads it


# ---- the roles as processes --------------------------------------------------------------
def _start(args, cwd) -> tuple:
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.Popen([sys.executable, "-m", "stract_tpu_torch.main", *args], cwd=cwd,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    line = proc.stdout.readline()  # the role's address, or its one line of output
    return proc, line.strip()


def _addr(line: str) -> tuple:
    import ast

    return tuple(ast.literal_eval(line.split("rpc=", 1)[1].strip()))


def test_main_crawler_roles_as_processes(tmp_path):
    """`main.py crawler coordinator | router | worker | plan CONFIG`: the
    coordinator serves its queue (one `remaining` call), the router answers
    `new_job` from it, the worker drains it and exits, plan prints."""
    from stract_tpu_torch.crawler import Job
    from stract_tpu_torch.crawler.file_queue import FileQueue
    from stract_tpu_torch.distributed.sonic import RemoteClient

    FileQueue(str(tmp_path / "jobs")).push_many([Job("nowhere.invalid", []).to_json()])
    cfg = tmp_path / "crawler.toml"
    cfg.write_text(f'queue_path = "{tmp_path / "jobs"}"\n'
                   f'discovered_path = "{tmp_path / "disc"}"\n'
                   f'warc_output_dir = "{tmp_path / "warc"}"\n')
    procs = []
    try:
        coord, line = _start(["crawler", "coordinator", str(cfg)], REPO)
        procs.append(coord)
        c_addr = _addr(line)
        assert RemoteClient(c_addr, timeout=60).send("remaining", None) == 1
        cfg.write_text(cfg.read_text() + f'coordinator_addrs = ["{c_addr[0]}:{c_addr[1]}"]\n')
        router, line = _start(["crawler", "router", str(cfg)], REPO)
        procs.append(router)
        r_addr = _addr(line)
        cfg.write_text(cfg.read_text() + f'router_addr = "{r_addr[0]}:{r_addr[1]}"\n')
        out = subprocess.run([sys.executable, "-m", "stract_tpu_torch.main", "crawler", "worker",
                              str(cfg)], cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
                             capture_output=True, text=True, timeout=300)
        assert out.returncode == 0 and "crawled 1 jobs" in out.stdout, out.stdout + out.stderr
        assert RemoteClient(r_addr, timeout=60).send("new_job", None) is None
        plan = subprocess.run([sys.executable, "-m", "stract_tpu_torch.main", "crawler", "plan",
                               str(cfg)], cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
                              capture_output=True, text=True, timeout=300)
        assert plan.returncode == 0 and "make_crawl_plan" in plan.stdout
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.communicate(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.communicate(timeout=15)
