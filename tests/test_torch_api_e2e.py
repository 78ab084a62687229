"""tests/test_api_e2e.py's scenarios through an app of each package on the
CPU: the same index, entity index, host and page graphs, image store,
spell checker and autosuggest queries (all written by the JAX package,
whose `InvertedIndex.insert` the port does not have yet), driven over
aiohttp's TestClient in the same order. Every route answers with the same
status, content type and JSON or text; only the search durations and the
improvement qid (32 hex digits in each) may differ, a page's scores and
ranking signals agree as tests/test_torch_slice.py holds them (rtol 1e-3 /
atol 1e-3: the port's pass 2 reads q16 rows), and /metrics adds the port's
kernel launch and active user gauges to the JAX package's metrics. The port's frontend/ is
the JAX package's, byte for byte.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import os
import re

import pytest
from aiohttp.test_utils import TestClient, TestServer

from test_api_e2e import build_test_app
from test_torch_slice import _assert_pages_match

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_app(tmp_path):
    """The port's app over the files build_test_app wrote under tmp_path,
    wired as build_test_app wires the JAX package's."""
    from stract_tpu_torch.api.server import build_app
    from stract_tpu_torch.autosuggest import Autosuggest
    from stract_tpu_torch.entity_index import EntityIndex
    from stract_tpu_torch.entity_index.index import SidebarManager
    from stract_tpu_torch.image_store import ImageStore
    from stract_tpu_torch.index.inverted import InvertedIndex
    from stract_tpu_torch.ranking.inbound_similarity import InboundSimilarity
    from stract_tpu_torch.searcher.api import ApiSearcher
    from stract_tpu_torch.searcher.distributed import LocalShardedSearcher
    from stract_tpu_torch.searcher.local import LocalSearcher
    from stract_tpu_torch.spell import SpellChecker, StupidBackoff, TermFreqs
    from stract_tpu_torch.webgraph.store import Webgraph
    from stract_tpu_torch.widgets import WidgetManager

    freqs, lm = TermFreqs(), StupidBackoff()
    for _ in range(5):
        freqs.observe_text("rust programming language systems")
        lm.observe_text("rust programming language systems")
    api = ApiSearcher(
        LocalShardedSearcher([LocalSearcher(InvertedIndex(str(tmp_path / "api_idx"), "cpu"),
                                            shard_id=0)]),
        spell_checker=SpellChecker(freqs, lm), widget_manager=WidgetManager(),
        sidebar_manager=SidebarManager(EntityIndex(str(tmp_path / "api_ent"))))
    return build_app(api, autosuggest=Autosuggest.from_queries(["rust tutorial", "rust lang"]),
                     similar_hosts=InboundSimilarity(Webgraph(str(tmp_path / "api_hostgraph"))),
                     page_graph=Webgraph(str(tmp_path / "api_pagegraph")),
                     image_store=ImageStore(str(tmp_path / "api_images")))


# (method, path, json body) in test_api_e2e.py's order, plus the routes it
# reaches only through the UI
SCENARIOS = [
    ("post", "/beta/api/search", {"query": "rust programming"}),
    ("post", "/beta/api/search", {"query": "!g rust"}),
    ("post", "/beta/api/search", {"query": " "}),
    ("post", "/beta/api/widget", {"query": "2+2*3"}),
    ("post", "/beta/api/search/sidebar", {"query": "rust programming"}),
    ("post", "/beta/api/search/sidebar", {"query": "python"}),
    ("post", "/beta/api/search/spellcheck", {"query": "rust programing"}),
    ("get", "/beta/api/autosuggest?q=rust", None),
    ("get", "/metrics", None),
    ("get", "/health", None),
    ("get", "/beta/api/docs/openapi.json", None),
    ("get", "/", None),
    ("post", "/beta/api/search", {"query": "rust", "return_ranking_signals": True}),
    ("post", "/improvement/click", {"qid": "q1", "click": "url"}),
    ("post", "/improvement/store", {"query": "rust", "urls": ["https://rust-lang.org/"]}),
    ("post", "/beta/api/webgraph/host/ingoing?host=rust-lang.org", None),
    ("post", "/beta/api/webgraph/host/outgoing", {"host": "https://rust-lang.org/"}),
    ("post", "/beta/api/webgraph/page/ingoing?page=https://rust-lang.org/", None),
    ("post", "/beta/api/webgraph/page/outgoing?page=https://blog.io/post", None),
    ("post", "/beta/api/webgraph/host/ingoing", None),
    ("get", "/beta/api/webgraph/host/knows?host=rust-lang.org", None),
    ("post", "/beta/api/hosts/export",
     {"hostRankings": {"liked": ["a.com"], "disliked": [], "blocked": ["b.com"]}}),
    ("post", "/beta/api/explore/export",
     {"chosenHosts": ["rust-lang.org"], "similarHosts": ["crates.io"]}),
    ("post", "/beta/api/webgraph/host/similar", {"hosts": ["rust-lang.org"], "topN": 3}),
    ("get", "/beta/api/entity_image?imageId=ent1", None),
    ("get", "/beta/api/entity_image?imageId=nope", None),
    ("get", "/beta/api/autosuggest/browser?q=rust", None),
    ("post", "/beta/api/search", {"q": 1}),
    ("get", "/search?q=rust", None),
    ("get", "/explore", None),
    ("get", "/settings", None),
    ("get", "/about", None),
    ("get", "/webmasters", None),
    ("get", "/privacy", None),
    ("get", "/static/app.js", None),
    ("get", "/static/style.css", None),
    ("get", "/static/optic.js", None),
    ("get", "/static/index.html", None),
    ("get", "/static/../conftest.py", None),
    ("get", "/static/opensearch.xml", None),
    ("get", "/beta/api/docs", None),
    ("get", "/metrics", None),
]


def _metric_lines(text: str, port: bool) -> list:
    """The metrics' lines without the latency histogram's values (timings)
    and, for the port, without its kernel launch and active user gauges."""
    out = []
    for line in text.splitlines():
        if port and ("kernel_launches" in line or "active_users" in line):
            continue
        if line.startswith("search_latency_seconds"):
            line = re.sub(r" [0-9.e+-]+$", " <value>", line)
        out.append(line)
    return out


def _walk(app, port: bool) -> list:
    async def run():
        out = []
        async with TestClient(TestServer(app)) as client:
            for method, path, body in SCENARIOS:
                resp = await getattr(client, method)(path, json=body)
                data = await resp.read()
                if resp.content_type == "application/json":
                    data = json.loads(data)
                    if isinstance(data, dict) and "searchDurationMs" in data:
                        data["searchDurationMs"] = None
                elif path == "/improvement/store":
                    assert re.fullmatch(rb"[0-9a-f]{32}", data), data
                    data = b"<qid>"
                elif path == "/metrics":
                    data = _metric_lines(data.decode(), port)
                out.append((method, path, resp.status, resp.content_type,
                            resp.headers.get("Access-Control-Allow-Origin"), data))
        return out
    return asyncio.run(run())


def test_api_end_to_end_answers_as_the_jax_packages(tmp_path):
    want = _walk(build_test_app(tmp_path), port=False)
    got = _walk(port_app(tmp_path), port=True)
    assert [g[:5] for g in got] == [w[:5] for w in want]
    for g, w in zip(got, want):
        if isinstance(w[5], dict) and w[5].get("type") == "websites":
            _assert_pages_match(w[5], g[5])
            g[5]["webpages"] = [{**x, "score": None, "rankingSignals": None}
                                for x in g[5]["webpages"]]
            w[5]["webpages"] = [{**x, "score": None, "rankingSignals": None}
                                for x in w[5]["webpages"]]
        assert g[5] == w[5], g[:2]
    answers = {(m, p, json.dumps(b)): g for (m, p, b), g in zip(SCENARIOS, got)}
    search = answers[("post", "/beta/api/search", '{"query": "rust programming"}')][5]
    assert search["webpages"][0]["url"] == "https://rust-lang.org/"
    assert answers[("post", "/beta/api/search/sidebar", '{"query": "rust programming"}')][5][
        "sidebar"]["type"] == "entity"
    assert [s[2] for s in got].count(404) == 2 and [s[2] for s in got].count(400) == 3
    assert any("kernel_launches" in line for line in _walk(port_app(tmp_path), False)[8][5])


@pytest.mark.parametrize("name", sorted(os.listdir(os.path.join(REPO, "stract_tpu", "frontend"))))
def test_frontend_is_the_jax_packages_byte_for_byte(name):
    paths = [os.path.join(REPO, pkg, "frontend", name) for pkg in ("stract_tpu",
                                                                   "stract_tpu_torch")]
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    assert sorted(os.listdir(os.path.dirname(paths[1]))) == \
        sorted(os.listdir(os.path.dirname(paths[0])))
    assert importlib.import_module("stract_tpu_torch.api.server").FRONTEND == \
        os.path.dirname(paths[1])
