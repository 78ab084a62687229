"""The port's whole search slice against the JAX package's on the CPU:
ApiSearcher(LocalShardedSearcher([LocalSearcher(index)])) on one index
directory gives the same result page through both packages, and the port's
HTTP route serves it. Plus the import guard: the port loads with jax blocked.

Tolerance: page scores are signals @ coefficients over the page's signal
rows, which the port always takes through the q16 pass 2 (the JAX package's
single-query path keeps f32), so scores agree to rtol 1e-3 / atol 1e-3 and
pages are compared as url sets above the last score (ties may reorder).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest

from stract_tpu_torch import bench_corpus as bc_port

from torch_parity import assert_topk_match

DOCS = 2000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REQUESTS = [
    {"query": "w1 w2", "return_ranking_signals": True},
    {"query": "w3"},
    {"query": "w7 w120", "signalCoefficients": {"host_centrality": 3.0}},
    {"query": "w2 w9 -w30"},
    {"query": "w0 w4", "page": 1, "num_results": 5},
    {"query": "w15 zzznothing"},
]


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch-slice"))
    return bc_port.ensure_corpus(root, DOCS, seed=11, log=lambda *a: None)


def jax_searcher(path):
    from stract_tpu.index import InvertedIndex
    from stract_tpu.searcher import LocalSearcher
    from stract_tpu.searcher.api import ApiSearcher
    from stract_tpu.searcher.distributed import LocalShardedSearcher

    return ApiSearcher(LocalShardedSearcher([LocalSearcher(InvertedIndex(path))]))


def port_searcher(path):
    from stract_tpu_torch.main import build_searcher

    return build_searcher(path, "cpu")


def _pages(searcher, sq_cls):
    return [searcher.search(sq_cls.from_json(r)).to_json() for r in REQUESTS]


def _assert_pages_match(pj, pp):
    assert pj["type"] == pp["type"] == "websites"
    assert pj["numHits"] == pp["numHits"]
    assert pj["hasMoreResults"] == pp["hasMoreResults"]
    wj, wp = pj["webpages"], pp["webpages"]
    assert len(wj) == len(wp)
    ids = {w["url"]: i for i, w in enumerate(wj + wp)}
    assert_topk_match(np.array([ids[w["url"]] for w in wj]), np.array([w["score"] for w in wj]),
                      np.array([ids[w["url"]] for w in wp]), np.array([w["score"] for w in wp]),
                      -1, 1e-3, 1e-3)
    by_url = {w["url"]: w for w in wj}
    for w in wp:
        if w["url"] in by_url:
            ref = by_url[w["url"]]
            assert (w["title"], w["snippet"]) == (ref["title"], ref["snippet"])
            for name, v in ref.get("rankingSignals", {}).items():
                assert abs(w["rankingSignals"].get(name, 0.0) - v) <= 1e-3 * max(1.0, abs(v))


def test_result_pages_match_jax(index_dir):
    from stract_tpu.searcher.query import SearchQuery as JaxSQ
    from stract_tpu_torch.searcher.query import SearchQuery

    pages_j = _pages(jax_searcher(index_dir), JaxSQ)
    pages_p = _pages(port_searcher(index_dir), SearchQuery)
    for pj, pp in zip(pages_j, pages_p):
        _assert_pages_match(pj, pp)
    assert sum(len(p["webpages"]) for p in pages_p) > 20
    assert pages_p[0]["webpages"][0]["rankingSignals"]
    assert pages_p[-1]["webpages"] == []


def test_http_route_serves_the_page(index_dir):
    from stract_tpu_torch.api.server import build_app
    from stract_tpu_torch.main import ServerThread
    from stract_tpu_torch.searcher.query import SearchQuery

    searcher = port_searcher(index_dir)
    direct = searcher.search(SearchQuery.from_json(REQUESTS[0])).to_json()
    server = ServerThread(build_app(searcher, max_concurrency=4))
    try:
        req = urllib.request.Request(
            server.url + "/beta/api/search", data=json.dumps(REQUESTS[0]).encode(),
            headers={"content-type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200
            body = json.loads(resp.read())
        bad = urllib.request.Request(server.url + "/beta/api/search", data=b"{}",
                                     headers={"content-type": "application/json"},
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(bad, timeout=60)
        assert err.value.code == 400
        with urllib.request.urlopen(server.url + "/metrics", timeout=60) as resp:
            metrics = resp.read().decode()
    finally:
        server.stop()
    assert [w["url"] for w in body["webpages"]] == [w["url"] for w in direct["webpages"]]
    assert 'search_requests_total{status="ok"} 1' in metrics
    assert "kernel_launches" in metrics


def test_port_imports_without_jax():
    """Every module of stract_tpu_torch imports with jax, flax and optax
    blocked (a subprocess, so this test's own jax import does not count)."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax'): sys.modules[m] = None\n"
        "import importlib, pkgutil, stract_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(stract_tpu_torch.__path__,"
        " 'stract_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_cuda_device_without_a_card_raises(index_dir):
    """device="cuda" on a machine without a card raises; nothing falls back
    to the CPU."""
    import torch

    from stract_tpu_torch.index.inverted import InvertedIndex

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    idx = InvertedIndex(index_dir, device="cuda")
    with pytest.raises((RuntimeError, AssertionError)):
        idx.device_segment_for(idx.segments[0])
