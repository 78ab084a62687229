"""The shard search's other configurations, the port against the JAX package
on the CPU: q8 posting rows, block-max UB scoring in stage A, the device
factor join (alone, in stage B and in pass 2), pass 2 from the slots' L-row
prefixes, the verify budget, and the dense rerank. The JAX package reads its
configuration from module constants and one environment variable, set here
with monkeypatch before its index is built; the port takes arguments.

Tolerances, and why:
  - factors_join is integer work: bit-equal to the JAX package's and, on q16
    rows, to the host join;
  - stage A with UB: candidate sets above the cut, scores rtol 1e-5 and
    atol 5e-3: UB folds +U into every entry and takes n*U back out of the
    per-doc sum, on top of the f32 cumsum differences of stage A (running
    sums ~2e3 here);
  - joined stage B and signals: the same f32 arithmetic over bit-equal
    factors: scores rtol 1e-6 (rtol 1e-5 where sums over slots run in another
    order), q16 rows within one step;
  - K12 (prefix signals): max abs 1e-5;
  - rerank: scores atol 1e-6, indices equal unless scores tie within that;
  - the slice: as tests/test_torch_index.py and tests/test_torch_slice.py.
The `cuda`-marked tests that hold each new kernel against its plain version
on a card are in tests/test_torch_scoring.py.
"""

from __future__ import annotations

import json
import os
import shutil
import urllib.request

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stract_tpu.index import InvertedIndex as JaxIndex
from stract_tpu.index import inverted as inv_jax
from stract_tpu.index.device import DeviceSegment as JaxDeviceSegment
from stract_tpu.ops import dense_rerank as RJ
from stract_tpu.ops import scoring as OJ
from stract_tpu_torch import bench_corpus as bc_port
from stract_tpu_torch.index import inverted as inv_port
from stract_tpu_torch.index.device import DeviceSegment, segment_arrays_from_numpy
from stract_tpu_torch.index.inverted import InvertedIndex
from stract_tpu_torch.index.segment import Segment
from stract_tpu_torch.ops import dense_rerank as RT
from stract_tpu_torch.ops import kernels
from stract_tpu_torch.ops import scoring as OT

from test_torch_index import BENCH_QUERIES, SMALL_QUERIES, _compare_search, _ctx_pair
from torch_parity import (assert_topk_match, doc_only, driver_candidates, host_factors,
                          query_batch, rich_fixture, row_layout_of, ub_inputs)

CONFIGS = {
    "q8": dict(row_layout="q8"),
    "join": dict(device_join=True),
    "q8_join": dict(row_layout="q8", device_join=True),
    "ub": dict(ub_lambda=0.5),
    "verify_c": dict(verify_c=1024),
}


def jx(tup):
    return type(tup)(*[jnp.asarray(x) for x in tup])


def set_jax_config(monkeypatch, row_layout="q16", device_join=False, ub_lambda=0.0, verify_c=0):
    """The JAX package under the configuration the port takes as arguments."""
    if row_layout == "q8":
        monkeypatch.setenv("STRACT_TPU_ROW_LAYOUT", "q8")
    else:
        monkeypatch.delenv("STRACT_TPU_ROW_LAYOUT", raising=False)
    monkeypatch.setattr(inv_jax, "DEVICE_JOIN", device_join)
    monkeypatch.setattr(inv_jax, "UB_LAMBDA", ub_lambda)
    monkeypatch.setattr(JaxIndex, "VERIFY_C", verify_c)


@pytest.fixture
def fixture():
    rng = np.random.default_rng(11)
    seg, starts, dfs, impact, L = rich_fixture(rng)
    return rng, seg, starts, dfs, impact, L


# ---- K11: the join alone ---------------------------------------------------------
@pytest.mark.parametrize("row_layout", ["q16", "q8"])
def test_factors_join_matches_jax_and_host(fixture, row_layout):
    rng, seg, starts, dfs, impact, L = fixture
    qs, _ = query_batch(rng, seg, starts, dfs, impact)
    qs = doc_only(qs)
    cands = driver_candidates(rng, seg, qs.starts.shape[0], 256)
    cands[1] = cands[1][::-1]  # the join does not need sorted candidates
    seg_l = row_layout_of(seg, row_layout)
    seg_t = segment_arrays_from_numpy(seg_l, device="cpu")
    f_j = np.asarray(OJ.factors_join(jx(seg_l), jnp.asarray(qs.starts), jnp.asarray(qs.lens),
                                     jnp.asarray(cands)))
    f_t = OT.factors_join(seg_t, qs.starts, qs.lens, cands)
    assert f_t.dtype == torch.int32 and tuple(f_t.shape) == f_j.shape
    np.testing.assert_array_equal(f_t.numpy(), f_j)
    assert (f_j != 0).any() and (f_j < 0).any()  # negative packed words are joined too
    pads = np.broadcast_to((cands == int(seg.num_docs))[:, None, :], f_j.shape)
    assert pads.any() and (f_t.numpy()[pads] == 0).all()  # pad candidates find nothing
    if row_layout == "q16":
        np.testing.assert_array_equal(f_t.numpy(), host_factors(seg, qs, cands))
    # single-query form
    f1_j = np.asarray(OJ.factors_join(jx(seg_l), jnp.asarray(qs.starts[0]),
                                      jnp.asarray(qs.lens[0]), jnp.asarray(cands[0])))
    f1_t = OT.factors_join(seg_t, qs.starts[0], qs.lens[0], cands[0])
    np.testing.assert_array_equal(f1_t.numpy(), f1_j)
    np.testing.assert_array_equal(f1_t.numpy(), f_t.numpy()[0])


# ---- K11 inside stage B and pass 2 -------------------------------------------------
@pytest.mark.parametrize("row_layout", ["q16", "q8"])
@pytest.mark.parametrize("default_static", [True, False])
def test_score_driver_joined_matches_jax(fixture, row_layout, default_static):
    rng, seg, starts, dfs, impact, L = fixture
    qs, _ = query_batch(rng, seg, starts, dfs, impact, default_static=default_static)
    qs = doc_only(qs)
    cands = driver_candidates(rng, seg, qs.starts.shape[0], 512)
    seg_l = row_layout_of(seg, row_layout)
    seg_t = segment_arrays_from_numpy(seg_l, device="cpu")
    nd = int(seg.num_docs)
    d_j, s_j = OJ.score_driver_joined_batch(jx(seg_l), jx(qs), jnp.asarray(cands),
                                            default_static, 128)
    d_t, s_t = OT.score_driver_joined_batch(seg_t, qs, cands, default_static, 128)
    assert tuple(d_t.shape) == (qs.starts.shape[0], 128) and d_t.dtype == torch.int32
    for b in range(qs.starts.shape[0]):
        assert_topk_match(np.asarray(d_j[b]), np.asarray(s_j[b]), d_t[b].numpy(),
                          s_t[b].numpy(), nd, 1e-5, 1e-5)
    assert np.isfinite(s_t.numpy()).any()
    if row_layout == "q16":  # the joined verify is the host-joined verify
        d_h, s_h = OT.score_driver_batch(seg_t, qs, host_factors(seg, qs, cands), cands,
                                         default_static, 128)
        assert torch.equal(d_h, d_t) and torch.equal(s_h, s_t)
    q1 = OJ.QuerySlots(*[x[0] for x in qs])
    d1_j, s1_j = OJ.score_driver_joined(jx(seg_l), jx(q1), jnp.asarray(cands[0]),
                                        default_static, 128)
    d1_t, s1_t = OT.score_driver_joined(seg_t, q1, cands[0], default_static, 128)
    assert_topk_match(np.asarray(d1_j), np.asarray(s1_j), d1_t.numpy(), s1_t.numpy(), nd,
                      1e-5, 1e-5)


@pytest.mark.parametrize("row_layout", ["q16", "q8"])
def test_compute_signals_joined_forms_match_jax(fixture, row_layout):
    rng, seg, starts, dfs, impact, L = fixture
    qs, aggs = query_batch(rng, seg, starts, dfs, impact)
    qs = doc_only(qs)
    cands = driver_candidates(rng, seg, qs.starts.shape[0], 128)
    seg_l = row_layout_of(seg, row_layout)
    seg_t = segment_arrays_from_numpy(seg_l, device="cpu")
    sig_j = np.asarray(OJ.compute_signals_joined_batch(jx(seg_l), jx(qs), jx(aggs),
                                                       jnp.asarray(cands)))
    sig_t = OT.compute_signals_joined_batch(seg_t, qs, aggs, cands)
    assert sig_t.dtype == torch.float32 and tuple(sig_t.shape) == sig_j.shape
    np.testing.assert_allclose(sig_t.numpy(), sig_j, rtol=1e-6, atol=1e-7)
    assert (sig_j != 0).any()
    q_j, scl_j = OJ.compute_signals_joined_batch_q16(jx(seg_l), jx(qs), jx(aggs),
                                                     jnp.asarray(cands))
    q_t, scl_t = OT.compute_signals_joined_batch_q16(seg_t, qs, aggs, cands)
    assert q_t.dtype == torch.int16
    np.testing.assert_allclose(scl_t.numpy(), np.asarray(scl_j), rtol=1e-5, atol=1e-35)
    assert np.abs(q_t.numpy().astype(np.int32) - np.asarray(q_j).astype(np.int32)).max() <= 1
    q1 = OJ.QuerySlots(*[x[0] for x in qs])
    a1 = OJ.QueryAggregates(*[x[0] for x in aggs])
    s1_j = np.asarray(OJ.compute_signals_joined(jx(seg_l), jx(q1), jx(a1),
                                                jnp.asarray(cands[0])))
    s1_t = OT.compute_signals_joined(seg_t, q1, a1, cands[0])
    np.testing.assert_allclose(s1_t.numpy(), s1_j, rtol=1e-6, atol=1e-7)
    if row_layout == "q16":  # on q16 rows the join is the host join
        q_h, scl_h = OT.compute_signals_from_factors_batch_q16(
            seg_t, qs, aggs, host_factors(seg, qs, cands), cands)
        assert torch.equal(q_h, q_t) and torch.equal(scl_h, scl_t)


# ---- K12: pass 2 from the slots' prefixes -------------------------------------------
@pytest.mark.parametrize("row_layout", ["q16", "q8"])
def test_compute_signals_prefix_matches_jax(fixture, row_layout):
    """Slot 6 of every query is a tf-ordered impact range: the search over it
    finds whatever the reference's steps find."""
    rng, seg, starts, dfs, impact, L = fixture
    qs, aggs = query_batch(rng, seg, starts, dfs, impact)
    assert (qs.lens[:, 6] > 0).all()
    cands = driver_candidates(rng, seg, qs.starts.shape[0], 128)
    # candidates that sit in the impact slot, so its unsorted rows are searched
    post = np.asarray(seg.postings)
    for b in range(qs.starts.shape[0]):
        s, l = int(qs.starts[b, 6]), int(qs.lens[b, 6])
        cands[b, :40] = post[s: s + min(l, 40), 0]
    seg_l = row_layout_of(seg, row_layout)
    seg_t = segment_arrays_from_numpy(seg_l, device="cpu")
    for Lq in (64, L):
        sig_j = np.asarray(OJ.compute_signals_batch(jx(seg_l), jx(qs), jx(aggs),
                                                    jnp.asarray(cands), Lq))
        sig_t = OT.compute_signals_batch(seg_t, qs, aggs, cands, Lq)
        assert tuple(sig_t.shape) == sig_j.shape
        assert np.abs(sig_t.numpy() - sig_j).max() <= 1e-5
        assert (sig_j != 0).any()
    q1 = OJ.QuerySlots(*[x[0] for x in qs])
    a1 = OJ.QueryAggregates(*[x[0] for x in aggs])
    s1_j = np.asarray(OJ.compute_signals(jx(seg_l), jx(q1), jx(a1), jnp.asarray(cands[0]), L))
    s1_t = OT.compute_signals(seg_t, q1, a1, cands[0], L)
    assert np.abs(s1_t.numpy() - s1_j).max() <= 1e-5


def test_prefix_lookup_follows_the_reference_on_unsorted_rows():
    """The tile search alone, on rows in random order, against the JAX one."""
    rng = np.random.default_rng(3)
    B, P, L, K = 2, 4, 37, 64  # L not a power of two: steps = ceil(log2 L) + 1
    docs = rng.integers(0, 50, (B, P, L)).astype(np.int32)
    facs = rng.integers(1, 1 << 20, (B, P, L)).astype(np.int32)
    cand = rng.integers(0, 51, (B, K)).astype(np.int32)
    got = OT._slot_factor_lookup(torch.as_tensor(docs), torch.as_tensor(facs),
                                 torch.as_tensor(cand), L).numpy()
    for b in range(B):
        ref = np.asarray(OJ._slot_factor_lookup(jnp.asarray(docs[b]), jnp.asarray(facs[b]),
                                                jnp.asarray(cand[b]), L))
        np.testing.assert_array_equal(got[b], ref)


# ---- K1 on q8 rows and with UB ----------------------------------------------------
@pytest.mark.parametrize("row_layout", ["q16", "q8"])
@pytest.mark.parametrize("lam", [0.5, 1.0])
def test_stage_a_ub_plain_matches_jax(fixture, row_layout, lam):
    rng, seg, starts, dfs, impact, L = fixture
    qs, _ = query_batch(rng, seg, starts, dfs, impact)
    ub, total = ub_inputs(rng, qs)
    ub, total = ub * np.float32(lam), total * np.float32(lam)
    seg_l = row_layout_of(seg, row_layout)
    seg_t = segment_arrays_from_numpy(seg_l, device="cpu")
    K, nd = 128, int(seg.num_docs)
    d_j, s_j = OJ.score_candidates_batch(jx(seg_l), jx(qs), L, K, True, soft_required=True,
                                         ub_entry=jnp.asarray(ub), ub_total=jnp.asarray(total))
    d_t, s_t = OT.score_candidates_batch(seg_t, qs, L, K, True, soft_required=True,
                                         ub_entry=ub, ub_total=total)
    for b in range(qs.starts.shape[0]):
        assert_topk_match(np.asarray(d_j[b]), np.asarray(s_j[b]), d_t[b].numpy(),
                          s_t[b].numpy(), nd, 1e-5, 5e-3)
    # the bounds moved the scores: UB is not a no-op on this fixture
    _, s_0 = OT.score_candidates_batch(seg_t, qs, L, K, True, soft_required=True)
    assert not torch.allclose(s_0, s_t)
    # single-query form
    q1 = OJ.QuerySlots(*[x[0] for x in qs])
    d1_j, s1_j = OJ.score_candidates(jx(seg_l), jx(q1), L, K, True, soft_required=True,
                                     ub_entry=jnp.asarray(ub[0]),
                                     ub_total=jnp.float32(total[0]))
    d1_t, s1_t = OT.score_candidates(seg_t, q1, L, K, True, soft_required=True,
                                     ub_entry=ub[0], ub_total=np.float32(total[0]))
    assert_topk_match(np.asarray(d1_j), np.asarray(s1_j), d1_t.numpy(), s1_t.numpy(), nd,
                      1e-5, 5e-3)


# ---- the index layer -------------------------------------------------------------
@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch-configs"))
    return bc_port.ensure_corpus(root, 2000, seed=3, log=lambda *a: None)


@pytest.fixture(scope="module")
def small_dir(tmp_path_factory):
    from conftest import make_doc
    from test_index_search import CORPUS

    idx = JaxIndex(str(tmp_path_factory.mktemp("torch-configs-small")))
    for d in CORPUS + [make_doc("https://rust.news/", "Rust news", "rust weekly news digest")]:
        idx.insert(d)
    idx.commit()
    return idx.path


def test_q8_device_segment_bit_equal_and_cache_bytes(bench_dir, tmp_path, monkeypatch):
    """DeviceSegment(row_layout="q8") holds the JAX package's arrays bit for
    bit, each package writes the same device_postings_q8.bin, and the UB side
    (impact_bound_f1 in the scan's currency) agrees in both layouts."""
    dirs = {}
    for who in ("jax", "port"):
        dirs[who] = str(tmp_path / who)
        shutil.copytree(bench_dir, dirs[who])
        cache = os.path.join(dirs[who], "segments", "seg-bench", "device_postings_q8.bin")
        if os.path.exists(cache):
            os.remove(cache)
    monkeypatch.setenv("STRACT_TPU_ROW_LAYOUT", "q8")
    seg_j = JaxIndex(dirs["jax"]).segments[0]
    dj = JaxDeviceSegment(seg_j)
    dp = DeviceSegment(Segment(os.path.join(dirs["port"], "segments", "seg-bench")), "cpu",
                       row_layout="q8")
    assert tuple(dp.arrays.postings.shape)[1] == 2
    for name in dj.arrays._fields:
        a, b = np.asarray(getattr(dj.arrays, name)), getattr(dp.arrays, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(np.atleast_1d(a).view(np.uint8),
                                      np.atleast_1d(b).view(np.uint8), err_msg=name)
    files = [os.path.join(d, "segments", "seg-bench", "device_postings_q8.bin")
             for d in dirs.values()]
    with open(files[0], "rb") as fa, open(files[1], "rb") as fb:
        assert fa.read() == fb.read()
    # reopening reads the cache back
    dp2 = DeviceSegment(Segment(os.path.join(dirs["port"], "segments", "seg-bench")), "cpu",
                        row_layout="q8")
    assert torch.equal(dp2.arrays.postings, dp.arrays.postings)
    terms = np.nonzero(dp.impact_lens > 0)[0]
    assert len(terms)
    monkeypatch.delenv("STRACT_TPU_ROW_LAYOUT")
    dj16 = JaxDeviceSegment(seg_j)
    dp16 = DeviceSegment(Segment(seg_j.path), "cpu")
    for a, b in ((dj, dp), (dj16, dp16)):
        for ti in list(terms[:5]) + [int(np.nonzero(dp.impact_lens == 0)[0][0])]:
            for Lq in (0, 1, 128, 5000):
                assert a.impact_bound_f1(int(ti), Lq) == b.impact_bound_f1(int(ti), Lq)
    assert dj.impact_bound_f1(int(terms[0]), 128) % 257 == 0  # the widened q8 currency
    with pytest.raises(ValueError):
        DeviceSegment(Segment(seg_j.path), "cpu", row_layout="q4")


@pytest.mark.parametrize("row_layout", ["q16", "q8"])
@pytest.mark.parametrize("lam", [0.5, 1.0])
def test_augment_with_impact_bounds_match_jax(bench_dir, monkeypatch, row_layout, lam):
    from stract_tpu.ranking.computer import build_slots as build_j
    from stract_tpu_torch.ranking.computer import build_slots as build_p

    set_jax_config(monkeypatch, row_layout=row_layout, ub_lambda=lam)
    jidx = JaxIndex(bench_dir)
    pidx = InvertedIndex(bench_dir, device="cpu", row_layout=row_layout, ub_lambda=lam)
    sj, sp = jidx.segments[0], pidx.segments[0]
    dj, dp = jidx.device_segment_for(sj), pidx.device_segment_for(sp)
    seen_bound = 0
    for raw, terms, kw in BENCH_QUERIES:
        cj, cp = _ctx_pair(raw, terms, **kw)
        qj, _ = build_j(cj, sj, jidx.num_docs, jidx.region_scores())
        qp, _ = build_p(cp, sp, pidx.num_docs, pidx.region_scores())
        for Lq in (128, None):
            aj, ubj, tj = jidx._augment_with_impact(sj, dj, qj, Lq)
            ap, ubp, tp = pidx._augment_with_impact(sp, dp, qp, Lq, lam)
            for f in aj._fields:
                np.testing.assert_array_equal(np.asarray(getattr(aj, f)),
                                              np.asarray(getattr(ap, f)), err_msg=f)
            np.testing.assert_array_equal(ubj, ubp)
            assert tj == tp
            seen_bound += int((ubp > 0).sum())
    assert seen_bound > 0


def _searchers(path, monkeypatch, **cfg):
    set_jax_config(monkeypatch, **cfg)
    return JaxIndex(path), InvertedIndex(path, device="cpu", **cfg)


@pytest.mark.parametrize("mode", ["driver", "scan"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_search_arrays_batch_under_config_matches_jax(bench_dir, monkeypatch, config, mode):
    cfg = CONFIGS[config]
    if mode == "scan":  # the 2000-doc corpus takes the scan path only with a low budget
        monkeypatch.setattr(inv_jax, "DRIVER_MAX", 16)
        monkeypatch.setattr(inv_port, "DRIVER_MAX", 16)
    jidx, pidx = _searchers(bench_dir, monkeypatch, **cfg)
    pairs, _, res_p, n = _compare_search(jidx, pidx, BENCH_QUERIES)
    assert n > 0
    for _, p in pairs:  # the joined path keeps no factor and no fused-signal cache
        assert not p.__dict__.get("_fused_sigs")
        assert bool(p.__dict__.get("_p1_factors")) == (not cfg.get("device_join", False))
    if config == "q8":  # the host join reads exact q16 rows: the q16 layout's results
        res_16 = InvertedIndex(bench_dir, device="cpu").search_arrays_batch(
            [_ctx_pair(r, t, **kw)[1] for r, t, kw in BENCH_QUERIES], top_k=64)
        for (_, d8, s8), (_, d16, s16) in zip(res_p, res_16):
            assert_topk_match(d16, s16, d8, s8, -1, 1e-6, 1e-6)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_search_initial_under_config_matches_jax(bench_dir, small_dir, monkeypatch, config):
    cfg = CONFIGS[config]
    for path, queries in ((bench_dir, BENCH_QUERIES), (small_dir, SMALL_QUERIES)):
        jidx, pidx = _searchers(path, monkeypatch, **cfg)
        found = 0
        for raw, terms, kw in queries:
            cj, cp = _ctx_pair(raw, terms, **kw)
            pj, sj = jidx.search_initial(cj, top_k=32)
            pp, sp = pidx.search_initial(cp, top_k=32)
            assert len(pj) == len(pp)
            assert all(isinstance(p, inv_port.DocPointer) for p in pp)
            assert_topk_match(np.array([p.doc for p in pj]), np.array(sj),
                              np.array([p.doc for p in pp]), np.array(sp), -1, 1e-5, 1e-5)
            found += len(pp)
        assert found > 0
    # the batch form is the same search
    (ptrs, scores), = pidx.search_initial_batch([_ctx_pair(*SMALL_QUERIES[0][:2])[1]], top_k=32)
    ptrs1, scores1 = pidx.search_initial(_ctx_pair(*SMALL_QUERIES[0][:2])[1], top_k=32)
    assert ptrs == ptrs1 and scores == scores1


@pytest.mark.parametrize("config", list(CONFIGS))
def test_compute_signals_under_config_match_jax(bench_dir, monkeypatch, config):
    """compute_signals_arrays_many with several queries (the q16 batch form),
    with one (the single form) and compute_signals over pointers."""
    cfg = CONFIGS[config]
    jidx, pidx = _searchers(bench_dir, monkeypatch, **cfg)
    pairs, res_j, res_p, _ = _compare_search(jidx, pidx, BENCH_QUERIES[:3])
    items_j, items_p = [], []
    for (cj, cp), (_, dj, _), (_, dp, _) in zip(pairs, res_j, res_p):
        docs = np.intersect1d(dj[:10], dp[:10]).astype(np.int64)
        segs = np.zeros(len(docs), np.int64)
        items_j.append((cj, segs, docs))
        items_p.append((cp, segs, docs))

    def close(a, b, steps):
        assert a.shape == b.shape and a.shape[0] > 0
        step = np.maximum(np.abs(a).max(axis=0, keepdims=True), 1e-30) / 32767.0
        assert (np.abs(a - b) <= steps * step).all(), np.abs(a - b).max()

    for a, b in zip(jidx.compute_signals_arrays_many(items_j),
                    pidx.compute_signals_arrays_many(items_p)):
        close(a, b, 2.01)
    one_j = jidx.compute_signals_arrays_many(items_j[:1])[0]
    one_p = pidx.compute_signals_arrays_many(items_p[:1])[0]
    # the joined single form is f32 on both sides; the host-joined one is the
    # port's q16 path against the JAX package's f32
    close(one_j, one_p, 0.01 if cfg.get("device_join") else 2.01)
    ptrs_j = [inv_jax.DocPointer(0, int(d)) for d in items_j[0][2]]
    ptrs_p = [inv_port.DocPointer(0, int(d)) for d in items_p[0][2]]
    sig_j = jidx.compute_signals(items_j[0][0], ptrs_j)
    sig_p = pidx.compute_signals(items_p[0][0], ptrs_p)
    close(sig_j, sig_p, 0.01 if cfg.get("device_join") else 2.01)
    np.testing.assert_array_equal(sig_p, one_p)


def test_q16_device_join_equals_host_join_through_the_index(bench_dir):
    """With q16 rows the device join changes no result: the same docs and
    scores as the host join, bit for bit."""
    ctxs = lambda: [_ctx_pair(r, t, **kw)[1] for r, t, kw in BENCH_QUERIES]  # noqa: E731
    host = InvertedIndex(bench_dir, device="cpu").search_arrays_batch(ctxs(), top_k=64)
    join = InvertedIndex(bench_dir, device="cpu", device_join=True).search_arrays_batch(
        ctxs(), top_k=64)
    for (_, dh, sh), (_, dj, sj) in zip(host, join):
        np.testing.assert_array_equal(dh, dj)
        np.testing.assert_array_equal(sh, sj)
    with pytest.raises(ValueError):
        InvertedIndex(bench_dir, device="cpu", row_layout="q12")


def test_http_page_under_q8_device_join_matches_jax(bench_dir, monkeypatch):
    """One page over HTTP from build_app(build_searcher(row_layout="q8",
    device_join=True)) against the JAX coordinator's under the same switches."""
    from stract_tpu.searcher.query import SearchQuery as JaxSQ
    from stract_tpu_torch.api.server import build_app
    from stract_tpu_torch.main import ServerThread, build_searcher

    from test_torch_slice import REQUESTS, _assert_pages_match, jax_searcher

    set_jax_config(monkeypatch, row_layout="q8", device_join=True)
    searcher = build_searcher(bench_dir, "cpu", row_layout="q8", device_join=True)
    index = searcher.searcher.searchers[0].index
    assert index.row_layout == "q8" and index.device_join and not index.fused
    assert tuple(index.device_segment_for(index.segments[0]).arrays.postings.shape)[1] == 2
    jax_api = jax_searcher(bench_dir)
    server = ServerThread(build_app(searcher, max_concurrency=4))
    try:
        for body in REQUESTS[:3]:
            req = urllib.request.Request(
                server.url + "/beta/api/search", data=json.dumps(body).encode(),
                headers={"content-type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=120) as resp:
                assert resp.status == 200
                page = json.loads(resp.read())
            _assert_pages_match(jax_api.search(JaxSQ.from_json(body)).to_json(), page)
            assert page["webpages"]
        with urllib.request.urlopen(server.url + "/metrics", timeout=60) as resp:
            metrics = resp.read().decode()
    finally:
        server.stop()
    for name in ("stage_a_q8", "stage_b_joined", "signals_joined", "dense_rerank"):
        assert f'kernel="{name}"' in metrics


def test_serve_arguments_reach_the_index(monkeypatch):
    """main.py serve --row-layout/--device-join/--ub-lambda/--verify-c/
    --merge-kernel are build_searcher's arguments."""
    from stract_tpu_torch import main as M
    from stract_tpu_torch.api import server as server_mod

    seen = {}
    monkeypatch.setattr(M, "build_searcher", lambda *a: seen.setdefault("args", a))
    monkeypatch.setattr(server_mod, "build_app", lambda s: s)
    monkeypatch.setattr(M.web, "run_app", lambda *a, **k: None)
    M.main(["serve", "--index", "X", "--device", "cpu", "--row-layout", "q8", "--device-join",
            "--ub-lambda", "0.5", "--verify-c", "1024", "--merge-kernel"])
    assert seen["args"] == ("X", "cpu", "", "", "", "q8", True, 0.5, 1024, True)
    seen.clear()
    M.main(["serve", "--index", "X"])  # the defaults are the default configuration
    assert seen["args"][5:] == ("q16", False, 0.0, 0, False)
    with pytest.raises(SystemExit):
        M.main(["serve", "--index", "X", "--row-layout", "q4"])


# ---- K10: the dense rerank --------------------------------------------------------
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_rerank_topk_matches_jax(dtype):
    rng = np.random.default_rng(5)
    B, K, H, k = 3, 96, 64, 20
    emb = rng.normal(0, 1, (B, K, H)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=2, keepdims=True)
    emb[:, 5] = 0  # a zero row scores its base alone
    emb[0, 7] = emb[0, 8]  # two rows that tie when their bases do
    emb = emb.astype(dtype)
    q = rng.normal(0, 1, (B, H)).astype(np.float32)
    base = rng.normal(0, 0.1, (B, K)).astype(np.float32)
    base[0, 7] = base[0, 8] = 5.0
    for weight in (0.01, 1.0):
        i_j, s_j = RJ.rerank_topk_batch(jnp.asarray(emb), jnp.asarray(q), jnp.asarray(base),
                                        weight, k)
        i_t, s_t = RT.rerank_topk_batch(torch.as_tensor(emb), q, base, weight, k)
        assert i_t.dtype == torch.int32 and tuple(i_t.shape) == (B, k)
        np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=0, atol=1e-6)
        for b in range(B):  # indices equal unless two scores tie within the tolerance
            sj = np.asarray(s_j[b])
            for pos, (a, c) in enumerate(zip(np.asarray(i_j[b]), i_t[b].numpy())):
                assert a == c or (np.abs(sj - sj[pos]) <= 2e-6).sum() > 1
        assert list(i_t[0, :2].numpy()) == [7, 8]  # ties go to the lower index
    zero_total = base[:, 5]
    full = RT.rerank_topk_batch(torch.as_tensor(emb), q, base, 1.0, K)
    for b in range(B):
        pos = int((full[0][b] == 5).nonzero()[0])
        assert abs(float(full[1][b, pos]) - float(zero_total[b])) <= 1e-7
    i1_j, s1_j = RJ.rerank_topk(jnp.asarray(emb[1]), jnp.asarray(q[1]), jnp.asarray(base[1]),
                                1.0, k)
    i1_t, s1_t = RT.rerank_topk(torch.as_tensor(emb[1]), q[1], base[1], 1.0, k)
    np.testing.assert_allclose(s1_t.numpy(), np.asarray(s1_j), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(i1_t.numpy(), np.asarray(i1_j))


# ---- wrappers: argument checks, dispatch, live launch structs ----------------------
def test_new_kernel_arguments_are_checked(monkeypatch):
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    f32 = lambda *s: torch.zeros(s, dtype=torch.float32)  # noqa: E731

    class Seg:
        postings = i32(64, 4)

    q = type("Q", (), {"starts": i32(2, 16)})()
    with pytest.raises(ValueError):  # rows are [Ptot, 3] or [Ptot, 2]
        kernels.factors_join(Seg, i32(2, 16), i32(2, 16), i32(2, 8), i32(2, 16, 8))
    Seg.postings = i32(64, 2)
    with pytest.raises(ValueError):  # out of the wrong shape
        kernels.factors_join(Seg, i32(2, 16), i32(2, 16), i32(2, 8), i32(2, 8, 16))
    with pytest.raises(ValueError):  # more candidates than one block sorts
        kernels.stage_b_joined(Seg, q, i32(2, 8192), True, 1.0, 1, None, None, None)
    with pytest.raises(ValueError):  # k > Kd
        kernels.stage_b_joined(Seg, q, i32(2, 128), True, 1.0, 256, None, None, None)
    aggs = type("A", (), {"nsig": 46})()
    with pytest.raises(ValueError):  # f32 rows or q16 rows, not both, not neither
        kernels.signals_search(Seg, q, aggs, i32(2, 8), 1.0)
    with pytest.raises(ValueError):  # q16 rows need their scales
        kernels.signals_search(Seg, q, aggs, i32(2, 8), 1.0,
                               out_q=torch.zeros((2, 46, 8), dtype=torch.int16))
    with pytest.raises(ValueError):  # a prefix search needs its step count
        kernels.signals_search(Seg, q, aggs, i32(2, 8), 1.0, L=128, steps=0,
                               out_f32=f32(2, 46, 8))
    with pytest.raises(ValueError):  # UB takes both arrays
        kernels.stage_a(Seg, q, 128, 128, 4096, True, True, 1.0, *[None] * 7, ub_entry=f32(2, 16))
    with pytest.raises(ValueError):  # i32 rows are not embeddings
        kernels.dense_rerank(i32(2, 8, 4), f32(2, 4), f32(2, 8), 1.0, 4, None, None)
    with pytest.raises(ValueError):  # k > K
        kernels.dense_rerank(f32(2, 8, 4), f32(2, 4), f32(2, 8), 1.0, 16, None, None)
    with pytest.raises(ValueError):  # wider rows than the block stages
        kernels.dense_rerank(f32(1, 8, 2048), f32(1, 2048), f32(1, 8), 1.0, 4, None, None)
    for name in ("stage_a_q8", "stage_a_ub", "factors_join", "stage_b_joined", "signals_joined",
                 "signals_prefix", "dense_rerank"):
        assert name in kernels.LAUNCHES


def test_new_entry_points_dispatch_on_cuda_tensors_and_keep_structs_live(fixture, monkeypatch):
    """A CUDA segment reaches the kernel wrappers, never a plain version, and
    at each launch every raw address handed over (the UB arrays, the
    aggregation struct, the rerank's inputs) belongs to a live tensor.
    Stand-in launches, so it runs without a card."""
    import gc
    import warnings

    rng, seg, starts, dfs, impact, L = fixture
    qs, aggs = query_batch(rng, seg, starts, dfs, impact)
    cands = driver_candidates(rng, seg, qs.starts.shape[0], 128)
    ub, total = ub_inputs(rng, qs)
    seg_t = segment_arrays_from_numpy(seg, device="cpu")
    seen = []

    def live(*tensors_or_ptrs):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            alive = {o.data_ptr() for o in gc.get_objects() if isinstance(o, torch.Tensor)}
        return all((t.data_ptr() if isinstance(t, torch.Tensor) else t) in alive
                   for t in tensors_or_ptrs)

    def agg_live(a):
        return live(*[getattr(a, f) for f in ("bm25", "bm25f", "idf", "cov", "static_of_sig")])

    monkeypatch.setattr(kernels, "stage_a", lambda *a: seen.append(
        ("stage_a", live(a[-2], a[-1], *a[1]))))
    monkeypatch.setattr(kernels, "factors_join", lambda seg, s, l, c, out: seen.append(
        ("factors_join", live(s, l, c, out))))
    monkeypatch.setattr(kernels, "stage_b_joined", lambda seg, q, cand, *rest: seen.append(
        ("stage_b_joined", live(cand, *q))))
    monkeypatch.setattr(kernels, "signals_search", lambda seg, q, a, cand, *rest, **kw: seen.append(
        ("signals_search", agg_live(a) and live(cand, *q))))
    monkeypatch.setattr(kernels, "dense_rerank", lambda e, qe, b, *rest: seen.append(
        ("dense_rerank", live(e, qe, b))))
    for name in ("score_candidates_batch_plain", "factors_join_plain",
                 "score_driver_joined_batch_plain", "compute_signals_joined_batch_plain",
                 "compute_signals_batch_plain"):
        monkeypatch.setattr(OT, name, lambda *a, **k: seen.append(("plain", False)))
    monkeypatch.setattr(RT, "rerank_topk_batch_plain", lambda *a: seen.append(("plain", False)))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    OT.score_candidates_batch(seg_t, qs, L, 128, True, True, ub_entry=ub, ub_total=total)
    OT.factors_join(seg_t, qs.starts, qs.lens, cands)
    OT.score_driver_joined_batch(seg_t, qs, cands, True, 64)
    OT.compute_signals_joined_batch(seg_t, qs, aggs, cands)
    OT.compute_signals_joined_batch_q16(seg_t, qs, aggs, cands)
    OT.compute_signals_batch(seg_t, qs, aggs, cands, L)
    RT.rerank_topk_batch(torch.zeros((2, 8, 4)), np.zeros((2, 4), np.float32),
                         np.zeros((2, 8), np.float32), 1.0, 4)
    assert [n for n, _ in seen] == ["stage_a", "factors_join", "stage_b_joined",
                                    "signals_search", "signals_search", "signals_search",
                                    "dense_rerank"]
    assert all(ok for _, ok in seen), seen
