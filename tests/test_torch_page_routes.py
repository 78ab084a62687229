"""The coordinator's page in the port against the JAX package's on the CPU,
past the search route:

- ApiSearcher.search_websites (the object path: search_initial, the
  BucketCollector merge, the optics residual, recall, page, retrieve,
  precision) gives the JAX package's WebsitesResult JSON, with and without
  an optic residual, and without a residual the port's batched page
  (search_many) for the same query (a residual's boosts and downranks score
  the object path and the block path apart, in the JAX package as in the
  port: each path is held to its JAX counterpart);
- sidebar_for asks the entity sidebar first and falls through to the
  StackOverflow search only when it answers None;
- the user counts (and the port's /metrics gauges that read them), the
  improvement log (its LeakyQueue, in memory as the JAX coordinator's), the
  OpenAPI spec and the docs page;
- the routes the port added (host and page links with the 1,024-link cap,
  scheme stripping and 400 without a key; knows; the entity image; the
  improvement routes; health; docs; the UI and static files with the `..`
  refusal; CORS) answer as the JAX app does, through aiohttp's TestClient.

Pages are compared as tests/test_torch_slice.py compares them (scores rtol
1e-3 / atol 1e-3, ties at the cut as sets; titles and snippets equal).
"""

from __future__ import annotations

import asyncio
import json
import os

import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from test_torch_slice import REQUESTS, _assert_pages_match, jax_searcher, port_searcher

from stract_tpu_torch import bench_corpus as bc_port

DOCS = 2000
OPTICS = [
    None,
    # a boost and a content downrank: the residual runs over retrieved fields
    'Rule { Matches { Site("|site3.com|") }, Action(Boost(5)) };\n'
    'Rule { Matches { Content("w7") }, Action(Downrank(2)) };',
    # a site group in the device plan beside a residual title rule
    'DiscardNonMatching; Rule { Matches { Site("|site1.com|") } };\n'
    'Rule { Matches { Title("w2") }, Action(Boost(3)) };',
]


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch-page"))
    return bc_port.ensure_corpus(root, DOCS, seed=11, log=lambda *a: None)


@pytest.mark.parametrize("optic", OPTICS, ids=["plain", "residual", "site-group"])
def test_search_websites_matches_jax_and_the_batched_page(index_dir, optic):
    from stract_tpu.searcher.query import SearchQuery as JaxSQ
    from stract_tpu_torch.searcher.query import SearchQuery

    bodies = [{**r, "optic": optic} if optic else r for r in REQUESTS]
    jax_api, api = jax_searcher(index_dir), port_searcher(index_dir)
    want = [jax_api.search_websites(JaxSQ.from_json(b)).to_json() for b in bodies]
    got = [api.search_websites(SearchQuery.from_json(b)).to_json() for b in bodies]
    batched = [p.to_json() for p in api.search_many([SearchQuery.from_json(b) for b in bodies])]
    jax_batched = [p.to_json() for p in jax_api.search_many([JaxSQ.from_json(b)
                                                             for b in bodies])]
    for pj, pp, pb, pjb in zip(want, got, batched, jax_batched):
        _assert_pages_match(pj, pp)
        _assert_pages_match(pjb, pb)
        if optic is None:  # a residual's boosts score the two paths apart in both packages
            _assert_pages_match(pb, pp)
        assert pp["searchDurationMs"] == pj["searchDurationMs"] == 0.0
    assert sum(len(p["webpages"]) for p in got) > 10


class _Entities:
    """A sidebar manager that answers for one query."""

    def sidebar(self, query):
        return {"type": "entity", "value": {"title": "w1"}} if query == "w1" else None


def test_sidebar_asks_the_entity_sidebar_first(index_dir):
    from stract_tpu.searcher.api import ApiSearcher as JaxApi
    from stract_tpu_torch.searcher.api import ApiSearcher

    jax_api, port = jax_searcher(index_dir), port_searcher(index_dir)
    jax_api = JaxApi(jax_api.searcher, sidebar_manager=_Entities())
    port = ApiSearcher(port.searcher, sidebar_manager=_Entities())
    seen = []
    port.stackoverflow_sidebar = lambda q: seen.append(q)  # the fall-through's caller
    assert port.sidebar_for("w1") == jax_api.sidebar_for("w1") == _Entities().sidebar("w1")
    assert port.sidebar_for("w2 w3") is None and seen == ["w2 w3"]
    assert ApiSearcher(port.searcher).sidebar_for("w2 w3") is jax_api.sidebar_for("w2 w3") \
        is None


def test_user_count_matches_jax():
    from stract_tpu.api.user_count import UserCount as JaxCount
    from stract_tpu_torch.api.user_count import UserCount

    rng = np.random.default_rng(4)
    users = [f"10.0.{i % 250}.{i % 7}" for i in rng.integers(0, 5000, 3000)] + [""]
    out = []
    for cls in (JaxCount, UserCount):
        c = cls(precision=10)
        reads = [(c.daily_active(), c.monthly_active())]
        for i, u in enumerate(users):
            c.observe(u, now=1.7e9 + 30 * i)  # crosses a day boundary
            if i % 500 == 0:
                reads.append((c.daily_active(), c.monthly_active()))
        out.append(reads + [(c.daily_active(), c.monthly_active())])
    assert out[0] == out[1]
    assert out[1][-1][1] > out[1][-1][0] > 0


def test_user_counts_are_read_in_metrics(index_dir):
    """Each search observes its client (X-Forwarded-For, else the peer);
    /metrics reads the daily and monthly counts as its active_users gauges.
    An empty query is refused before it is counted."""
    from stract_tpu_torch.api.server import build_app

    async def run():
        async with TestClient(TestServer(build_app(port_searcher(index_dir),
                                                   max_concurrency=2))) as client:
            lines = []
            for users in ((), ("10.0.0.1", "10.0.0.2", "10.0.0.1", "10.0.0.3")):
                for user in users:
                    resp = await client.post("/beta/api/search", json={"query": "rust"},
                                             headers={"X-Forwarded-For": user})
                    assert resp.status == 200
                resp = await client.post("/beta/api/search", json={"query": " "},
                                         headers={"X-Forwarded-For": "10.0.0.9"})
                assert resp.status == 400
                text = await (await client.get("/metrics")).text()
                lines.append(sorted(x for x in text.splitlines()
                                    if x.startswith("active_users")))
            return lines
    assert asyncio.run(run()) == [['active_users{window="daily"} 0',
                                   'active_users{window="monthly"} 0'],
                                  ['active_users{window="daily"} 3',
                                   'active_users{window="monthly"} 3']]


def test_improvement_log_matches_jax():
    """The queue drops its oldest events past maxsize; store answers a
    32-hex-digit qid; the log holds the same events as the JAX package's
    log without a path (its coordinator passes none), and nothing more."""
    from stract_tpu.api import improvement as imp_jax
    from stract_tpu_torch.api import improvement as imp_port

    for mod in (imp_jax, imp_port):
        q = mod.LeakyQueue(maxsize=3)
        for i in range(5):
            q.push(i)
        assert q.drain() == [2, 3, 4] and q.drain() == []
    held = []
    for mod in (imp_jax, imp_port):
        log = mod.ImprovementLog()
        qid = log.store("rust", ["https://rust-lang.org/"])
        assert len(qid) == 32 and int(qid, 16) >= 0
        log.log(qid, "https://rust-lang.org/")
        events = log.queue.drain()
        assert events[0]["qid"] == events[1]["qid"] == qid
        held.append([{k: v for k, v in e.items() if k not in ("qid", "ts")} for e in events])
    assert held[0] == held[1] == [{"query": "rust", "urls": ["https://rust-lang.org/"]},
                                  {"click": "https://rust-lang.org/"}]
    assert not hasattr(imp_port.ImprovementLog(), "path")


def test_docs_match_jax():
    from stract_tpu.api import docs as docs_jax
    from stract_tpu_torch.api import docs as docs_port

    assert docs_port.openapi_spec() == docs_jax.openapi_spec()
    assert docs_port.docs_html() == docs_jax.docs_html()
    assert "/beta/api/webgraph/page/ingoing" in docs_port.openapi_spec()["paths"]


# ---- the routes ----------------------------------------------------------------------
HUB = "https://hub.example/"


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """A page graph whose hub has 1,500 backlinks (past the 1,024-link cap),
    and a host graph with rel flags, both written by the JAX package."""
    from stract_tpu.webgraph.edge import Edge, RelFlags
    from stract_tpu.webgraph.store import WebgraphBuilder

    root = tmp_path_factory.mktemp("torch-page-graphs")
    pb = WebgraphBuilder()
    for i in range(1500):
        pb.insert(Edge(f"https://p{i}.example/a", HUB, RelFlags.NOFOLLOW if i % 3 else
                       RelFlags.NONE))
    for i in range(2):
        pb.insert(Edge(HUB, f"https://p{i}.example/a"))
    pb.build(str(root / "pages"))
    hb = WebgraphBuilder(host_graph=True)
    hb.insert(Edge("blog.io", "rust-lang.org", RelFlags.NONE))
    hb.insert(Edge("news.site.com", "rust-lang.org", RelFlags.NOFOLLOW))
    hb.insert(Edge("rust-lang.org", "python.org", RelFlags.NONE))
    hb.build(str(root / "hosts"))
    return str(root / "pages"), str(root / "hosts")


def _app(pkg: str, index_dir: str, graphs, images: str | None):
    import importlib

    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    api = jax_searcher(index_dir) if pkg == "stract_tpu" else port_searcher(index_dir)
    store = mod("image_store").ImageStore(images) if images else None
    return mod("api.server").build_app(
        api, similar_hosts=mod("ranking.inbound_similarity").InboundSimilarity(
            mod("webgraph.store").Webgraph(graphs[1])),
        page_graph=mod("webgraph.store").Webgraph(graphs[0]), image_store=store,
        max_concurrency=4)


ROUTES = [
    ("post", f"/beta/api/webgraph/page/ingoing?page={HUB}", None),
    ("post", "/beta/api/webgraph/page/outgoing", {"page": HUB}),
    ("post", "/beta/api/webgraph/page/outgoing?page=https://nowhere.example/", None),
    ("post", "/beta/api/webgraph/host/ingoing?host=https://rust-lang.org/", None),
    ("post", "/beta/api/webgraph/host/outgoing", {"host": "rust-lang.org"}),
    ("post", "/beta/api/webgraph/host/ingoing", None),
    ("post", "/beta/api/webgraph/page/ingoing", {"other": 1}),
    ("get", "/beta/api/webgraph/host/knows?host=rust-lang.org", None),
    ("get", "/beta/api/webgraph/host/knows?host=unknown.org", None),
    ("get", "/beta/api/entity_image?imageId=ent1", None),
    ("get", "/beta/api/entity_image?image_id=ent1", None),
    ("get", "/beta/api/entity_image?imageId=nope", None),
    ("get", "/beta/api/entity_image", None),
    ("get", "/beta/api/autosuggest/browser?q=rust", None),
    ("post", "/improvement/click", {"qid": "q1", "click": "https://rust-lang.org/"}),
    ("get", "/health", None),
    ("get", "/beta/api/docs/openapi.json", None),
    ("get", "/beta/api/docs", None),
    ("get", "/about", None),
    ("get", "/privacy", None),
    ("get", "/static/optic.js", None),
    ("get", "/static/missing.js", None),
    ("options", "/beta/api/search", None),
]


def _answers(app) -> list:
    async def run():
        out = []
        async with TestClient(TestServer(app)) as client:
            for method, path, body in ROUTES:
                resp = await getattr(client, method)(path, json=body)
                data = await resp.read()
                cors = resp.headers.get("Access-Control-Allow-Origin")
                out.append((resp.status, resp.content_type, cors,
                            json.loads(data) if resp.content_type == "application/json"
                            else data))
            resp = await client.post("/improvement/store", json={"query": "q", "urls": []})
            out.append((resp.status, len(await resp.text())))
        return out
    return asyncio.run(run())


def test_page_routes_answer_as_the_jax_packages(index_dir, graphs, tmp_path):
    from stract_tpu.image_store import ImageStore

    ImageStore(str(tmp_path / "img")).insert("ent1", b"\x89PNGfake-image-bytes")
    want = _answers(_app("stract_tpu", index_dir, graphs, str(tmp_path / "img")))
    got = _answers(_app("stract_tpu_torch", index_dir, graphs, str(tmp_path / "img")))
    assert got == want
    by_path = dict(zip([p for _, p, _ in ROUTES], got))
    edges = by_path[f"/beta/api/webgraph/page/ingoing?page={HUB}"][3]
    assert len(edges) == 1024 and all(e["to"] == HUB for e in edges)
    assert by_path["/beta/api/webgraph/host/ingoing"][0] == 400
    assert {e["from"] for e in by_path["/beta/api/webgraph/host/ingoing?host="
                                       "https://rust-lang.org/"][3]} == {"blog.io",
                                                                         "news.site.com"}
    assert by_path["/beta/api/entity_image?imageId=ent1"][:2] == (200, "image/webp")
    assert by_path["/beta/api/entity_image?imageId=nope"][0] == 404
    assert all(cors == "*" for _, _, cors, _ in got[:-1])
    assert got[-1] == (200, 32)


def test_page_routes_without_their_services(index_dir):
    """No graphs and no image store: empty link lists, unknown hosts, 404
    images, as the JAX package answers; `..` never leaves frontend/."""
    from stract_tpu.api.server import build_app as jax_app
    from stract_tpu_torch.api.server import build_app

    paths = [("post", "/beta/api/webgraph/page/ingoing?page=x"),
             ("post", "/beta/api/webgraph/host/outgoing?host=x"),
             ("get", "/beta/api/webgraph/host/knows?host=x"),
             ("get", "/beta/api/entity_image?imageId=x"),
             ("get", "/beta/api/autosuggest/browser?q=x"),
             ("get", "/static/..%2Fapi%2Fserver.py"), ("get", "/static/%2E%2E"),
             ("get", "/search?q=rust"), ("get", "/explore"), ("get", "/settings")]

    async def run(app):
        out = []
        async with TestClient(TestServer(app)) as client:
            for method, path in paths:
                resp = await getattr(client, method)(path)
                out.append((resp.status, await resp.read()))
        return out
    want = asyncio.run(run(jax_app(jax_searcher(index_dir), max_concurrency=2)))
    got = asyncio.run(run(build_app(port_searcher(index_dir), max_concurrency=2)))
    assert got == want
    assert [s for s, _ in got[:6]] == [200, 200, 200, 404, 200, 404]
    with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "stract_tpu_torch", "frontend", "index.html"), "rb") as fh:
        assert got[-1][1] == fh.read()
