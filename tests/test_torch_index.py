"""Parity of the port's index layer with the JAX package's on the CPU: one
index directory, opened by both (segment reader, DeviceSegment tensors,
search_arrays_batch with stage B fused and unfused, pass-2 signal rows), and
the corpus writer, which must write the same bytes.

Tolerances: stage-B scores rtol 1e-5 (f32 sums in another order), compared
as doc sets above the top-k cut (tie order differs); pass-2 rows within two
q16 steps of the row's absmax (the port's pass 2 is always the q16 path, the
JAX single-query path is unquantised f32, and each side may round a value at
a midpoint either way).
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from stract_tpu import bench_corpus as bc_jax
from stract_tpu.index import InvertedIndex as JaxIndex
from stract_tpu.index import inverted as inv_jax
from stract_tpu.index.device import DeviceSegment as JaxDeviceSegment
from stract_tpu.index.segment import Segment as JaxSegment
from stract_tpu.ranking.computer import QueryContext as JaxContext
from stract_tpu_torch import bench_corpus as bc_port
from stract_tpu_torch.index import inverted as inv_port
from stract_tpu_torch.index.device import DeviceSegment
from stract_tpu_torch.index.inverted import InvertedIndex
from stract_tpu_torch.index.segment import Segment
from stract_tpu_torch.ranking.computer import QueryContext

from conftest import make_doc
from torch_parity import assert_topk_match

NOW = 1.7e9
BENCH_DOCS = 2000


@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch-bench"))
    return bc_port.ensure_corpus(root, BENCH_DOCS, seed=3, log=lambda *a: None)


@pytest.fixture(scope="module")
def small_dir(tmp_path_factory):
    from test_index_search import CORPUS

    idx = JaxIndex(str(tmp_path_factory.mktemp("torch-small")))
    for d in CORPUS + [make_doc("https://rust.news/", "Rust news", "rust weekly news digest")]:
        idx.insert(d)
    idx.commit()
    return idx.path


def _ctx_pair(raw, terms, **kw):
    return (JaxContext(raw=raw, simple_terms=list(terms), current_ts=NOW, **kw),
            QueryContext(raw=raw, simple_terms=list(terms), current_ts=NOW, **kw))


BENCH_QUERIES = [
    ("w1 w2", ["w1", "w2"], {}),
    ("w0 w45", ["w0", "w45"], {}),
    ("w3", ["w3"], {}),
    ("w7 w120", ["w7", "w120"], {"coefficients": {"host_centrality": 3.0}}),
    ("w2 w9 w30", ["w2", "w9", "w30"], {}),
]
SMALL_QUERIES = [
    ("rust programming", ["rust", "programming"], {}),
    ("programming", ["programming"], {}),
    ("cooking pasta", ["cooking", "pasta"], {}),
    ("rust", ["rust"], {"coefficients": {"tracker_score": -2.0}}),
    ("zzzmissing rust", ["zzzmissing", "rust"], {}),
]


def _compare_search(jidx, pidx, queries, top_k=64):
    pairs = [_ctx_pair(r, t, **kw) for r, t, kw in queries]
    res_j = jidx.search_arrays_batch([j for j, _ in pairs], top_k=top_k)
    res_p = pidx.search_arrays_batch([p for _, p in pairs], top_k=top_k)
    n = 0
    for (sj, dj, scj), (sp, dp, scp) in zip(res_j, res_p):
        assert len(dj) == len(dp)
        assert (sj == 0).all() and (sp == 0).all()
        assert_topk_match(dj, scj, dp, scp, -1, 1e-5, 1e-5)
        n += len(dp)
    return pairs, res_j, res_p, n


def test_segment_reader_matches(bench_dir):
    path = os.path.join(bench_dir, "segments", "seg-bench")
    sj, sp = JaxSegment(path), Segment(path)
    assert sp.num_docs == sj.num_docs == BENCH_DOCS
    for name in ("term_hashes", "term_starts", "term_lens", "postings_docs", "postings_tfs",
                 "field_lens"):
        np.testing.assert_array_equal(getattr(sp, name), getattr(sj, name))
    for d in (0, 7, BENCH_DOCS - 1):
        assert sp.stored_doc(d) == sj.stored_doc(d)
    assert sp.value_dict("site") == sj.value_dict("site")
    np.testing.assert_array_equal(sp.column("pre_computed_score"), sj.column("pre_computed_score"))


@pytest.mark.parametrize("which", ["bench", "small"])
def test_device_segment_bit_equal(which, bench_dir, small_dir):
    path = bench_dir if which == "bench" else small_dir
    seg = JaxIndex(path).segments[0]
    dj = JaxDeviceSegment(seg)
    dp = DeviceSegment(Segment(seg.path), "cpu")
    for name in dj.arrays._fields:
        a = np.asarray(getattr(dj.arrays, name))
        t = getattr(dp.arrays, name)
        assert isinstance(t, torch.Tensor)
        b = t.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                      np.atleast_1d(b).view(np.uint8), err_msg=name)
    np.testing.assert_array_equal(dj.impact_starts, dp.impact_starts)
    np.testing.assert_array_equal(dj.impact_lens, dp.impact_lens)
    if which == "bench":
        assert len(dp.impact_lens) and int(np.max(dp.impact_lens)) > 0


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("mode", ["driver", "scan"])
def test_search_arrays_batch_matches_jax(bench_dir, monkeypatch, fused, mode):
    """Both stage-B forms, in driver mode (candidates = the rarest group's
    postings) and in scan mode (stage A with impact prefixes: the driver
    budget is lowered so the 2000-doc corpus takes the scan path)."""
    monkeypatch.setattr(inv_jax, "FUSED_SIGNALS", fused)
    monkeypatch.setattr(InvertedIndex, "fused", property(lambda self: fused))
    if mode == "scan":
        monkeypatch.setattr(inv_jax, "DRIVER_MAX", 16)
        monkeypatch.setattr(inv_port, "DRIVER_MAX", 16)
    jidx, pidx = JaxIndex(bench_dir), InvertedIndex(bench_dir, device="cpu")
    pairs, _, res_p, n = _compare_search(jidx, pidx, BENCH_QUERIES)
    assert n > 0
    for _, p in pairs:
        assert bool(p.__dict__.get("_fused_sigs")) == fused


@pytest.mark.parametrize("fused", [False, True])
def test_small_index_scenarios_match_jax(small_dir, monkeypatch, fused):
    """The scenarios of test_index_search.py (AND semantics, single term,
    custom static coefficients, a missing term) on an index written by the
    JAX package."""
    monkeypatch.setattr(inv_jax, "FUSED_SIGNALS", fused)
    monkeypatch.setattr(InvertedIndex, "fused", property(lambda self: fused))
    jidx, pidx = JaxIndex(small_dir), InvertedIndex(small_dir, device="cpu")
    _, _, res_p, _ = _compare_search(jidx, pidx, SMALL_QUERIES, top_k=10)
    urls = [r["url"] for r in pidx.retrieve(
        [inv_port.DocPointer(int(s), int(d)) for s, d in zip(res_p[0][0], res_p[0][1])])]
    assert "https://rust-lang.org/" in urls and "https://python.org/about" not in urls
    assert len(res_p[4][1]) == 0  # a missing required term matches nothing


@pytest.mark.parametrize("fused", [False, True])
def test_compute_signals_arrays_many_matches_jax(bench_dir, monkeypatch, fused):
    monkeypatch.setattr(inv_jax, "FUSED_SIGNALS", fused)
    monkeypatch.setattr(InvertedIndex, "fused", property(lambda self: fused))
    jidx, pidx = JaxIndex(bench_dir), InvertedIndex(bench_dir, device="cpu")
    pairs, res_j, res_p, _ = _compare_search(jidx, pidx, BENCH_QUERIES[:3])
    items_j, items_p = [], []
    for (cj, cp), (sj, dj, _), (sp, dp, _) in zip(pairs, res_j, res_p):
        docs = np.intersect1d(dj[:10], dp[:10]).astype(np.int64)  # both pages, same rows
        segs = np.zeros(len(docs), np.int64)
        items_j.append((cj, segs, docs))
        items_p.append((cp, segs, docs))
    sig_j = jidx.compute_signals_arrays_many(items_j)
    sig_p = pidx.compute_signals_arrays_many(items_p)
    # the pointer-list form is the same pass
    ptrs = [[inv_port.DocPointer(0, int(d)) for d in docs] for _, _, docs in items_p]
    fresh = [_ctx_pair(r, t, **kw)[1] for r, t, kw in BENCH_QUERIES[:3]]
    for c, (cp, _, _) in zip(fresh, items_p):
        c.__dict__.update({k: v for k, v in cp.__dict__.items() if k.startswith("_")})
    for a, b in zip(pidx.compute_signals_batch_many(list(zip(fresh, ptrs))), sig_p):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(sig_j, sig_p):
        assert a.shape == b.shape and a.shape[0] > 0
        step = np.maximum(np.abs(a).max(axis=0, keepdims=True), 1e-30) / 32767.0
        assert (np.abs(a - b) <= 2.01 * step).all(), np.abs(a - b).max()


def test_count_phrases_and_retrieve_match_jax(small_dir):
    jidx, pidx = JaxIndex(small_dir), InvertedIndex(small_dir, device="cpu")
    cj, cp = _ctx_pair("rust programming", ["rust", "programming"])
    assert pidx.estimate_count(cp) == jidx.estimate_count(cj)
    segs = np.zeros(jidx.num_docs, np.int64)
    docs = np.arange(jidx.num_docs, dtype=np.int64)
    for phrase in (["programming", "language"], ["rust", "weekly"], ["pasta", "rust"]):
        np.testing.assert_array_equal(pidx.filter_phrases_arr(segs, docs, [phrase]),
                                      jidx.filter_phrases_arr(segs, docs, [phrase]))
    ptrs_p = [inv_port.DocPointer(0, d) for d in range(jidx.num_docs)]
    ptrs_j = [inv_jax.DocPointer(0, d) for d in range(jidx.num_docs)]
    assert pidx.retrieve(ptrs_p, ["rust"]) == jidx.retrieve(ptrs_j, ["rust"])
    names = ["host_node_id", "site_hash1"]
    cols_p = pidx.gather_columns_arr(segs, docs, names)
    cols_j = jidx.gather_columns_arr(segs, docs, names)
    for n in names:
        np.testing.assert_array_equal(cols_p[n], cols_j[n])


def test_bench_corpus_bytes_match_jax(tmp_path):
    """The port's corpus writer writes the JAX package's bytes, file by file."""
    pj, pp = str(tmp_path / "jax"), str(tmp_path / "port")
    bc_jax.build_corpus_segment(pj, BENCH_DOCS, seed=5, log=lambda *a: None)
    bc_port.build_corpus_segment(pp, BENCH_DOCS, seed=5, log=lambda *a: None)
    files = sorted(os.path.relpath(os.path.join(d, f), pj)
                   for d, _, fs in os.walk(pj) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), pp)
                           for d, _, fs in os.walk(pp) for f in fs)
    assert "postings_docs.bin" in files and "stored.bin" in files
    for f in files:
        with open(os.path.join(pj, f), "rb") as a, open(os.path.join(pp, f), "rb") as b:
            assert a.read() == b.read(), f
    rng_a, rng_b = np.random.default_rng(1), np.random.default_rng(1)
    assert bc_port.sample_queries(rng_a, 20) == bc_jax.sample_queries(rng_b, 20)
