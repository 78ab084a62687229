"""Crawl worker — the port of stract_tpu/crawler/worker.py
(role of reference crawler/worker.rs:64-306 WorkerThread +
JobExecutor: per-site fetch loop with robots.txt, politeness delays, 429
backoff, wander-prioritization of discovered urls, WARC output).

Fetching is pluggable (`fetch_fn(url) → (status, html, elapsed_ms)`) so tests
run without a network and production can swap an aiohttp fetcher."""

from __future__ import annotations

import time
import urllib.parse
from dataclasses import dataclass

from ..warc import WarcWriter
from .coordinator import Job, UrlToInsert
from .robots import Robots
from .wander_prioritiser import WanderPrioritiser

USER_AGENT = "StractTpuBot"
DEFAULT_POLITENESS_DELAY = 1.0   # seconds between fetches on one site
MAX_POLITENESS_DELAY = 180.0
MAX_URL_SLOWDOWN_RETRIES = 3


def default_fetch(url: str, timeout: float = 30.0):
    import urllib.request

    t0 = time.perf_counter()
    req = urllib.request.Request(url, headers={"User-Agent": USER_AGENT})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            body = resp.read().decode("utf-8", errors="replace")
            return resp.status, body, int((time.perf_counter() - t0) * 1000)
    except Exception:  # noqa: BLE001 — any fetch failure is a skip
        return 0, "", int((time.perf_counter() - t0) * 1000)


@dataclass
class CrawlDatum:
    url: str
    status: int
    body: str
    fetch_time_ms: int


class JobExecutor:
    """Executes one site-exclusive job (reference worker.rs:174)."""

    def __init__(self, job: Job, fetch_fn=default_fetch, warc_writer: WarcWriter | None = None,
                 politeness_delay: float = DEFAULT_POLITENESS_DELAY, sleep_fn=time.sleep):
        self.job = job
        self.fetch = fetch_fn
        self.warc = warc_writer
        self.delay = politeness_delay
        self.sleep = sleep_fn
        self.wander = WanderPrioritiser()
        self.crawled: set[str] = set()
        self.discovered: list[UrlToInsert] = []
        self.robots: Robots | None = None

    def _load_robots(self) -> None:
        url = f"https://{self.job.domain}/robots.txt"
        status, body, _ = self.fetch(url)
        self.robots = Robots.parse(body) if status == 200 else Robots.parse("")

    def allowed(self, url: str) -> bool:
        if self.robots is None:
            return True
        path = urllib.parse.urlparse(url).path or "/"
        return self.robots.is_allowed(USER_AGENT, path)

    def _process_url(self, url: str) -> CrawlDatum | None:
        """Fetch with politeness + 429 backoff (reference worker.rs:306)."""
        if url in self.crawled or not self.allowed(url):
            return None
        self.crawled.add(url)
        delay = self.delay
        if self.robots is not None:
            rd = self.robots.crawl_delay(USER_AGENT)
            if rd:
                delay = min(max(delay, rd), MAX_POLITENESS_DELAY)
        for attempt in range(MAX_URL_SLOWDOWN_RETRIES):
            status, body, ms = self.fetch(url)
            if status == 429:
                delay = min(delay * 2 or 1.0, MAX_POLITENESS_DELAY)
                self.sleep(delay)
                continue
            self.sleep(delay)
            if status == 200 and body:
                return CrawlDatum(url, status, body, ms)
            return None
        return None

    def run(self) -> list[CrawlDatum]:
        self._load_robots()
        out = []
        for url in self.job.urls:
            datum = self._process_url(url)
            if datum is None:
                continue
            out.append(datum)
            if self.warc is not None:
                self.warc.write_record(datum.url, datum.body)
            self._discover(datum)

        # wander within budget: crawl-time discovered urls on the same site
        wandered = 0
        while wandered < self.job.wandering_urls:
            url = self.wander.pop_best(self.job.domain)
            if url is None:
                break
            datum = self._process_url(url)
            if datum is None:
                continue
            wandered += 1
            out.append(datum)
            if self.warc is not None:
                self.warc.write_record(datum.url, datum.body)
            self._discover(datum)
        return out

    def _discover(self, datum: CrawlDatum) -> None:
        from ..webpage.html import Html

        html = Html.parse(datum.body, datum.url)
        for link in html.links()[:100]:
            dest_host = urllib.parse.urlparse(link.destination).netloc.lower().removeprefix("www.")
            if dest_host == self.job.domain or dest_host.endswith("." + self.job.domain):
                self.wander.observe(link.destination)
            else:
                self.discovered.append(UrlToInsert(link.destination, 1.0))


class WorkerThread:
    """Pulls jobs from the router until the plan is exhausted
    (reference worker.rs:100 WorkerThread::run)."""

    def __init__(self, router_client, fetch_fn=default_fetch, warc_factory=None, sleep_fn=time.sleep):
        self.router = router_client
        self.fetch_fn = fetch_fn
        self.warc_factory = warc_factory
        self.sleep_fn = sleep_fn

    def run(self, max_jobs: int | None = None) -> int:
        done = 0
        while max_jobs is None or done < max_jobs:
            job_json = self.router.send("new_job", None) if hasattr(self.router, "send") else self.router.new_job()
            if job_json is None:
                break
            job = Job.from_json(job_json)
            warc = self.warc_factory(job.domain) if self.warc_factory else None
            ex = JobExecutor(job, fetch_fn=self.fetch_fn, warc_writer=warc, sleep_fn=self.sleep_fn)
            ex.run()
            if warc is not None:
                warc.close()
            if ex.discovered and hasattr(self.router, "send"):
                self.router.send("add_urls", {"urls": [u.to_json() for u in ex.discovered]})
            done += 1
        return done
