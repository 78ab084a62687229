"""The port's whole search slice against the JAX package's on the CPU:
ApiSearcher(LocalShardedSearcher([LocalSearcher(index)])) on one index
directory gives the same result page through both packages, and the port's
HTTP route serves it; the same with the ranking pipeline on (dual encoder
in recall, cross encoder in precision, a forest in both). Plus the import
guard: the port loads with jax blocked.

Tolerance: page scores are signals @ coefficients over the page's signal
rows, which the port always takes through the q16 pass 2 (the JAX package's
single-query path keeps f32), so scores agree to rtol 1e-3 / atol 1e-3 and
pages are compared as url sets above the last score (ties may reorder).

Pipeline on: the models' signals carry the encoders' bf16 differences
(embedding similarities within 2e-2, cross-encoder scores within 1e-2, as
in test_torch_models.py), which adds 0.01 * 2 * 2e-2 + 0.17 * 2 * 1e-2 to
a score's tolerance (atol 5e-3 in all). The forest walks the same leaves
unless a row's two feature vectors (its signals in the two packages, equal
within the tolerances above) lie on two sides of a split threshold: such a
row flips a leaf (lambda_mart moves by a leaf value times 10), so its
lambda_mart and score are not compared, and a page holding one is compared
on the rows both pages share, not on its membership.
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


def jax_searcher(path, pipeline=None):
    from stract_tpu.index import InvertedIndex
    from stract_tpu.searcher import LocalSearcher
    from stract_tpu.searcher.api import ApiSearcher
    from stract_tpu.searcher.distributed import LocalShardedSearcher

    return ApiSearcher(LocalShardedSearcher([LocalSearcher(InvertedIndex(path))]), pipeline)


def port_searcher(path, **models):
    from stract_tpu_torch.main import build_searcher

    return build_searcher(path, "cpu", **models)


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
        with urllib.request.urlopen(req, timeout=180) as resp:  # six workers share the cores
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


def test_port_imports_without_jax(index_dir, tmp_path):
    """Every module of stract_tpu_torch imports with jax, flax, optax and the
    JAX package stract_tpu blocked, and with them blocked the port runs a
    search through its ApiSearcher on the CPU (the lazy imports of the
    search route included) and the centrality jobs on a tiny graph (a
    subprocess, so this test's own imports do not count)."""
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'stract_tpu'): sys.modules[m] = None\n"
        "import importlib, pkgutil, stract_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(stract_tpu_torch.__path__,"
        " 'stract_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "from stract_tpu_torch.main import build_searcher, run_centrality\n"
        "from stract_tpu_torch.searcher.query import SearchQuery\n"
        "from stract_tpu_torch.webgraph.store import write_graph\n"
        f"api = build_searcher({index_dir!r}, 'cpu')\n"
        "page = api.search(SearchQuery.from_json({'query': 'w1 w2',"
        " 'return_ranking_signals': True})).to_json()\n"
        "assert page['webpages'] and page['webpages'][0]['rankingSignals']\n"
        f"g = write_graph({str(tmp_path / 'g')!r}, ['a', 'b', 'c', 'd'], [0, 1, 2, 0], [1, 2, 3, 2])\n"
        f"cfg = {str(tmp_path / 'c.toml')!r}\n"
        "open(cfg, 'w').write(f'webgraph_path = \"{g.path}\"\\n"
        f"output_path = \"{tmp_path / 'out'}\"\\nnum_samples = 3\\n')\n"
        "for mode in ('harmonic', 'approx-harmonic'):\n"
        "    assert len(run_centrality(mode, cfg, device='cpu')) == 4\n"
        "print(len(names), len([m for m in sys.modules if m.startswith('stract_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr
    walked, loaded = map(int, out.stdout.split()[-2:])
    assert walked >= 60 and loaded >= walked


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


# ---- pipeline on ------------------------------------------------------------------------
MODEL_TOL = {"title_embedding_similarity": 2e-2, "keyword_embedding_similarity": 2e-2,
             "cross_encoder_snippet": 1e-2, "cross_encoder_title": 1e-2}
PIPE_SCORE_ATOL = 5e-3


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """A 2,000-doc corpus with embedding columns written once by the port's
    writer; tiny JAX encoders (random, seeded) saved for the port to load; a
    forest trained on the pipeline-off signal rows of sampled queries,
    graded as tools/train_bench_lambdamart.py grades them."""
    from stract_tpu.models.bert import BertConfig
    from stract_tpu.models.dual_encoder import DualEncoder as JaxDual
    from stract_tpu.models.wordpiece import WordPieceTokenizer
    from stract_tpu.ranking.models.cross_encoder import CrossEncoderModel as JaxCross
    from stract_tpu.ranking.models.lambdamart import LambdaMART as JaxLM
    from stract_tpu_torch.index.embeddings import write_embedding_columns
    from stract_tpu_torch.index.segment import Segment
    from stract_tpu.searcher.query import SearchQuery as JaxSQ
    from stract_tpu_torch.models.dual_encoder import DualEncoder
    from stract_tpu_torch.ranking.models.lambdamart import signal_matrix

    root = tmp_path_factory.mktemp("torch-pipeline")
    path = bc_port.ensure_corpus(str(root), DOCS, seed=11, log=lambda *a: None)
    seg = Segment(os.path.join(path, "segments", "seg-bench"))
    texts = [seg.stored_doc(d)["title"] + " " + seg.stored_doc(d)["clean_text"]
             for d in range(0, DOCS, 7)]
    tok = WordPieceTokenizer.build(texts + [r["query"] for r in REQUESTS], vocab_size=1024)
    dual_dir, cross_dir = str(root / "dual"), str(root / "cross")
    jdual = JaxDual.random_init(BertConfig.tiny(), tok, seed=1)
    jdual.save(dual_dir)
    jcross = JaxCross.random_init(BertConfig.tiny(), tok, seed=2)
    jcross.save(cross_dir)

    off = jax_searcher(path)  # f32 signal rows: thresholds fall between exact values
    X, y = [], []
    for q in bc_port.sample_queries(np.random.default_rng(5), 12):
        page = off.search(JaxSQ.from_json(
            {"query": q, "numResults": 20, "returnRankingSignals": True})).to_json()
        X.append(signal_matrix(page["webpages"]))
        for w in page["webpages"]:
            hits = sum(t in w["title"].split() for t in q.split())
            y.append(2.0 ** (3.0 if hits == 2 else 2.0 if hits else 1.0) - 1.0)
    jlm = JaxLM.train(np.concatenate(X), np.asarray(y), num_trees=10, max_depth=3)
    forest_path = str(root / "forest.json")
    with open(forest_path, "w") as fh:
        fh.write(jlm.to_json())

    stats = write_embedding_columns(path, DualEncoder.load(dual_dir, device="cpu"), batch=512)
    assert stats == {"docs": DOCS, "dim": 64, "seconds": stats["seconds"]}
    return {"path": path, "dual": dual_dir, "cross": cross_dir, "forest": forest_path,
            "jax": (jdual, jcross, jlm)}


def _sig_tol(name: str, v: float) -> float:
    return MODEL_TOL.get(name, 1e-3 * max(1.0, abs(v)))


def _assert_pipeline_pages_match(pj, pp, forest) -> bool:
    """→ True when the pages' membership was compared (no row flipped a
    leaf of the forest)."""
    from stract_tpu_torch.ranking.models.lambdamart import signal_matrix

    assert pj["type"] == pp["type"] == "websites"
    assert pj["numHits"] == pp["numHits"]
    assert pj["hasMoreResults"] == pp["hasMoreResults"]
    wj, wp = pj["webpages"], pp["webpages"]
    assert len(wj) == len(wp)
    by_url = {w["url"]: i for i, w in enumerate(wj)}
    shared = [(by_url[w["url"]], ip) for ip, w in enumerate(wp) if w["url"] in by_url]
    Xj = signal_matrix([wj[i] for i, _ in shared])
    Xp = signal_matrix([wp[i] for _, i in shared])
    flips = forest.split_between(Xj, Xp)
    for (ij, ip), flip in zip(shared, flips):
        w, ref = wp[ip], wj[ij]
        assert (w["title"], w["snippet"]) == (ref["title"], ref["snippet"])
        names = set(w["rankingSignals"]) | set(ref["rankingSignals"])
        for name in names - {"lambda_mart"}:
            a, b = w["rankingSignals"].get(name, 0.0), ref["rankingSignals"].get(name, 0.0)
            assert abs(a - b) <= _sig_tol(name, b), (name, a, b)
        if not flip:
            a = w["rankingSignals"].get("lambda_mart", 0.0)
            b = ref["rankingSignals"].get("lambda_mart", 0.0)
            assert abs(a - b) <= 1e-5 * max(1.0, abs(b)), ("lambda_mart", a, b)
            assert abs(w["score"] - ref["score"]) <= PIPE_SCORE_ATOL + 1e-3 * abs(ref["score"])
    if flips.any():
        return False
    assert {w["url"] for w in wj} == {w["url"] for w in wp}
    ids = {w["url"]: i for i, w in enumerate(wj)}
    assert_topk_match(np.array([ids[w["url"]] for w in wj]), np.array([w["score"] for w in wj]),
                      np.array([ids[w["url"]] for w in wp]), np.array([w["score"] for w in wp]),
                      -1, 1e-3, PIPE_SCORE_ATOL)
    return True


def test_pipeline_on_pages_match_jax(pipeline):
    from stract_tpu.ranking.pipeline import PrecisionStage, RankingPipeline, RecallStage
    from stract_tpu.searcher.query import SearchQuery as JaxSQ
    from stract_tpu_torch.ranking.models.lambdamart import LambdaMART
    from stract_tpu_torch.searcher.query import SearchQuery

    jdual, jcross, jlm = pipeline["jax"]
    jpipe = RankingPipeline(RecallStage(dual_encoder=jdual, lambdamart=jlm),
                            PrecisionStage(cross_encoder=jcross, lambdamart=jlm))
    port = port_searcher(pipeline["path"], dual_encoder=pipeline["dual"],
                         cross_encoder=pipeline["cross"], lambdamart=pipeline["forest"])
    assert port.pipeline.recall.lambdamart is port.pipeline.precision.lambdamart
    reqs = [{**r, "return_ranking_signals": True} for r in REQUESTS]
    pages_j = [jax_searcher(pipeline["path"], jpipe).search(JaxSQ.from_json(r)).to_json()
               for r in reqs]
    pages_p = [port.search(SearchQuery.from_json(r)).to_json() for r in reqs]
    forest = LambdaMART.load(pipeline["forest"], device="cpu")
    strict = [_assert_pipeline_pages_match(pj, pp, forest) for pj, pp in zip(pages_j, pages_p)]
    assert all(strict), strict  # these seeds flip no leaf; a flip must be looked at
    full = [p for p in pages_p if p["webpages"]]
    assert len(full) >= 4
    # every model wrote its signal on the page rows
    sigs = full[0]["webpages"][0]["rankingSignals"]
    for name in ("title_embedding_similarity", "cross_encoder_title", "lambda_mart"):
        assert name in sigs, name


def test_phase1_prefetches_query_embeddings_once(pipeline):
    """The coordinator queues the query embeddings once per batch in phase 1
    and phase 2 hands them to the recall stage, which then embeds nothing."""
    from stract_tpu_torch.searcher.query import SearchQuery

    port = port_searcher(pipeline["path"], dual_encoder=pipeline["dual"])
    dual = port.pipeline.recall.dual_encoder
    calls = []
    real_async = dual.embed_async
    dual.embed_async = lambda texts, **kw: calls.append(("async", list(texts))) or \
        real_async(texts, **kw)
    dual.embed = lambda texts: calls.append(("embed", list(texts)))
    sqs = [SearchQuery.from_json(b) for b in (
        {"query": "w1 w2"}, {"query": "!g w3"}, {"query": "w3"},
        {"query": "w0", "page": 40}, {"query": "w7 w120"})]
    state = port.search_phase1(sqs)
    assert calls == [("async", ["w1 w2", "w3", "w7 w120"])]
    results = port.search_phase2(state)
    assert calls == [("async", ["w1 w2", "w3", "w7 w120"])]
    assert results[1].to_json()["type"] == "bang"
    assert all(results[i].to_json()["webpages"] for i in (0, 2, 4))
