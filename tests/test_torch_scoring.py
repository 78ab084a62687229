"""Parity of the port's three device programs (stract_tpu_torch/ops/scoring.py)
with the JAX package's on the CPU: stage A (candidate scan), stage B (verify,
fused with q16 signals) and pass 2 (q16 signals). The same numpy inputs go to
both packages; the JAX SegmentArrays are carried across with
segment_arrays_from_numpy. Tests marked `cuda` hold each CUDA kernel against
its plain version and run only where there is a card and nvcc.

Tolerances, and why:
  - top-k tie order differs between jax.lax.top_k and torch.topk: docs are
    compared as sets above the k-th score (torch_parity.assert_topk_match);
  - stage-A scores: rtol 1e-5 and atol 2e-3 — JAX takes per-doc sums as
    differences of one f32 cumsum over up to B*P*L entries, whose absolute
    error grows with the running sum (~1e3 here, f32 eps 6e-8 per add);
  - stage-B scores: rtol 1e-5 (f32 sums over P <= 64 terms in another order);
  - q16 signals: +-1 step (a value within an ulp of a rounding midpoint may
    round either way);
  - freshness stays f32 on both sides ((now - ts) // 3600 in f32).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stract_tpu.ops import scoring as OJ
from stract_tpu_torch.index.device import quantize_rows_q8, segment_arrays_from_numpy
from stract_tpu_torch.ops import dense_rerank as RT
from stract_tpu_torch.ops import kernels
from stract_tpu_torch.ops import scoring as OT

from torch_parity import (assert_topk_match, assert_topk_runs_match, doc_only,
                          driver_candidates, host_factors, query_batch, rich_fixture,
                          row_layout_of, ub_inputs)

A_RTOL, A_ATOL = 1e-5, 2e-3
B_RTOL, B_ATOL = 1e-5, 1e-5


def jx(tup):
    return type(tup)(*[jnp.asarray(x) for x in tup])


@pytest.fixture
def fixture():
    rng = np.random.default_rng(7)
    seg, starts, dfs, impact, L = rich_fixture(rng)
    return rng, seg, starts, dfs, impact, L


def _compare_stage_a(seg_np, qs, L, K, ds, soft):
    d_j, s_j = OJ.score_candidates_batch(jx(seg_np), jx(qs), L, K, ds, soft_required=soft)
    seg_t = segment_arrays_from_numpy(seg_np, device="cpu")
    d_t, s_t = OT.score_candidates_batch(seg_t, qs, L, K, ds, soft_required=soft)
    assert d_t.dtype == torch.int32 and s_t.dtype == torch.float32
    assert tuple(d_t.shape) == (qs.starts.shape[0], K)
    nd = int(seg_np.num_docs)
    found = 0
    for b in range(qs.starts.shape[0]):
        assert_topk_match(np.asarray(d_j[b]), np.asarray(s_j[b]), d_t[b].numpy(),
                          s_t[b].numpy(), nd, A_RTOL, A_ATOL)
        found += int(np.isfinite(s_t[b].numpy()).sum())
    assert found > 0


@pytest.mark.parametrize("default_static", [True, False])
@pytest.mark.parametrize("soft_required", [True, False])
def test_stage_a_plain_matches_jax(fixture, default_static, soft_required):
    rng, seg, starts, dfs, impact, L = fixture
    qs, _ = query_batch(rng, seg, starts, dfs, impact, default_static=default_static)
    _compare_stage_a(seg, qs, L, 128, default_static, soft_required)


def test_stage_a_q8_rows_plain_matches_jax(fixture):
    rng, seg, starts, dfs, impact, L = fixture
    qs, _ = query_batch(rng, seg, starts, dfs, impact)
    rows = np.asarray(seg.postings)
    seg8 = seg._replace(postings=quantize_rows_q8(rows))
    _compare_stage_a(seg8, qs, L, 128, True, True)


@pytest.mark.parametrize("default_static", [True, False])
def test_stage_b_plain_matches_jax(fixture, default_static):
    rng, seg, starts, dfs, impact, L = fixture
    qs, _ = query_batch(rng, seg, starts, dfs, impact, default_static=default_static)
    qs = doc_only(qs)
    cands = driver_candidates(rng, seg, qs.starts.shape[0], 512)
    facs = host_factors(seg, qs, cands)
    out_k = 128
    d_j, s_j = OJ.score_driver_batch(jx(seg), jx(qs), jnp.asarray(facs), jnp.asarray(cands),
                                     default_static, out_k)
    seg_t = segment_arrays_from_numpy(seg, device="cpu")
    d_t, s_t = OT.score_driver_batch(seg_t, qs, facs, cands, default_static, out_k)
    assert tuple(d_t.shape) == (qs.starts.shape[0], out_k)
    for b in range(qs.starts.shape[0]):
        assert_topk_match(np.asarray(d_j[b]), np.asarray(s_j[b]), d_t[b].numpy(),
                          s_t[b].numpy(), int(seg.num_docs), B_RTOL, B_ATOL)


def _assert_sig_match(docs_j, sig_j, scale_j, docs_t, sig_t, scale_t, num_docs):
    """Dequantised signal columns of the same doc differ by at most one q16
    step; scales agree to rtol 1e-5 (columns are matched by doc: the fused
    columns follow the top-k order, whose ties may differ)."""
    np.testing.assert_allclose(scale_t, scale_j, rtol=1e-5, atol=1e-35)
    col_j = {int(d): i for i, d in enumerate(docs_j) if d < num_docs}
    shared = 0
    for i, d in enumerate(docs_t):
        if d < num_docs and int(d) in col_j:
            diff = np.abs(sig_t[:, i] - sig_j[:, col_j[int(d)]])
            assert (diff <= 1.001 * scale_j + 1e-30).all(), diff.max()
            shared += 1
    return shared


@pytest.mark.parametrize("default_static", [True, False])
def test_stage_b_fused_signals_plain_matches_jax(fixture, default_static):
    rng, seg, starts, dfs, impact, L = fixture
    qs, aggs = query_batch(rng, seg, starts, dfs, impact, default_static=default_static)
    qs = doc_only(qs)
    cands = driver_candidates(rng, seg, qs.starts.shape[0], 512)
    facs = host_factors(seg, qs, cands)
    out_k, sig_k = 128, 64
    packed = OJ.score_driver_batch_with_signals(
        jx(seg), jx(qs), jnp.asarray(facs), jnp.asarray(cands), jx(aggs), default_static,
        out_k, sig_k)
    d_j, s_j, sig_j = OJ.unpack_stageb(packed, out_k, 46, sig_k)
    seg_t = segment_arrays_from_numpy(seg, device="cpu")
    res = OT.score_driver_batch_with_signals(seg_t, qs, facs, cands, aggs, default_static,
                                             out_k, sig_k)
    d_t, s_t, sig_t = OT.unpack_stageb(res, out_k, 46, sig_k)
    assert tuple(res[2].shape) == (qs.starts.shape[0], 46, sig_k) and res[2].dtype == torch.int16
    shared = 0
    for b in range(qs.starts.shape[0]):
        assert_topk_match(d_j[b], s_j[b], d_t[b], s_t[b], int(seg.num_docs), B_RTOL, B_ATOL)
        scale_j = np.maximum(np.abs(sig_j[b]).max(axis=1), 1e-30) / 32767.0
        shared += _assert_sig_match(d_j[b][:sig_k], sig_j[b], scale_j,
                                    d_t[b][:sig_k], sig_t[b], res[3][b].numpy(),
                                    int(seg.num_docs))
    assert shared > 0


def test_pass2_signals_q16_plain_matches_jax(fixture):
    rng, seg, starts, dfs, impact, L = fixture
    qs, aggs = query_batch(rng, seg, starts, dfs, impact)
    qs = doc_only(qs)
    cands = driver_candidates(rng, seg, qs.starts.shape[0], 128)
    facs = host_factors(seg, qs, cands)
    q_j, scl_j = OJ.compute_signals_from_factors_batch_q16(
        jx(seg), jx(qs), jx(aggs), jnp.asarray(facs), jnp.asarray(cands))
    seg_t = segment_arrays_from_numpy(seg, device="cpu")
    q_t, scl_t = OT.compute_signals_from_factors_batch_q16(seg_t, qs, aggs, facs, cands)
    assert q_t.dtype == torch.int16 and tuple(q_t.shape) == tuple(np.asarray(q_j).shape)
    np.testing.assert_allclose(scl_t.numpy(), np.asarray(scl_j), rtol=1e-5, atol=1e-35)
    diff = np.abs(q_t.numpy().astype(np.int32) - np.asarray(q_j).astype(np.int32))
    assert diff.max() <= 1
    assert (np.asarray(q_j) != 0).any()


def test_single_query_forms_match_jax(fixture):
    """score_candidates / score_driver / compute_signals_from_factors: the
    port runs them through the batch path with B = 1."""
    rng, seg, starts, dfs, impact, L = fixture
    qs, aggs = query_batch(rng, seg, starts, dfs, impact, B=1)
    q1 = OJ.QuerySlots(*[x[0] for x in qs])
    a1 = OJ.QueryAggregates(*[x[0] for x in aggs])
    seg_t = segment_arrays_from_numpy(seg, device="cpu")
    nd = int(seg.num_docs)
    d_j, s_j = OJ.score_candidates(jx(seg), jx(q1), L, 128, True, soft_required=True)
    d_t, s_t = OT.score_candidates(seg_t, q1, L, 128, True, soft_required=True)
    assert_topk_match(np.asarray(d_j), np.asarray(s_j), d_t.numpy(), s_t.numpy(), nd,
                      A_RTOL, A_ATOL)
    qd = OJ.QuerySlots(*[x[0] for x in doc_only(qs)])
    cand = driver_candidates(rng, seg, 1, 128)[0]
    facs = host_factors(seg, doc_only(qs), cand[None])[0]
    d_j, s_j = OJ.score_driver(jx(seg), jx(qd), jnp.asarray(facs), jnp.asarray(cand))
    d_t, s_t = OT.score_driver(seg_t, qd, facs, cand)
    assert_topk_match(np.asarray(d_j), np.asarray(s_j), d_t.numpy(), s_t.numpy(), nd,
                      B_RTOL, B_ATOL)
    sig_j = np.asarray(OJ.compute_signals_from_factors(jx(seg), jx(qd), jx(a1),
                                                       jnp.asarray(facs), jnp.asarray(cand)))
    sig_t = OT.compute_signals_from_factors(seg_t, qd, a1, facs, cand)
    # the port's single form is the q16 path dequantised: one step of the row scale
    step = np.maximum(np.abs(sig_j).max(axis=1, keepdims=True), 1e-30) / 32767.0
    assert (np.abs(sig_t - sig_j) <= 1.001 * step).all()


def test_unpack_stageb_contract():
    docs = torch.tensor([[3, 5, 9]], dtype=torch.int32)
    scores = torch.tensor([[2.0, 1.0, float("-inf")]])
    sq = torch.ones((1, 46, 2), dtype=torch.int16)
    scale = torch.full((1, 46), 0.5)
    d, s = OT.unpack_stageb((docs, scores), 2)
    assert d.tolist() == [[3, 5]] and s.tolist() == [[2.0, 1.0]]
    d, s, sig = OT.unpack_stageb((docs, scores, sq, scale), 2, 46, 2)
    assert sig.shape == (1, 46, 2) and (sig == 0.5).all()


def test_cuda_tensors_never_take_the_plain_path(fixture, monkeypatch):
    """The dispatch keys on where the segment lies: a CUDA segment calls the
    kernel wrapper, never the plain version (checked with stand-ins, so it
    runs without a card)."""
    rng, seg, starts, dfs, impact, L = fixture
    seg_t = segment_arrays_from_numpy(seg, device="cpu")
    called = []
    monkeypatch.setattr(OT, "score_candidates_batch_plain",
                        lambda *a, **k: called.append("plain"))
    monkeypatch.setattr(kernels, "stage_a", lambda *a, **k: called.append("kernel"))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    qs, _ = query_batch(rng, seg, starts, dfs, impact)
    OT.score_candidates_batch(seg_t, qs, L, 128, True, True)
    assert called == ["kernel"]


def test_kernel_arguments_are_checked(monkeypatch):
    """Every kernel argument is checked before a launch: a CPU tensor, a wrong
    dtype or a wrong shape raises instead of reaching the kernel."""
    with pytest.raises(ValueError):
        kernels._ptr(torch.zeros(4), torch.float32)  # lies on the CPU
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    t = torch.zeros((2, 3), dtype=torch.int32)
    assert kernels._ptr(t, torch.int32, (2, 3)) == t.data_ptr()
    with pytest.raises(ValueError):
        kernels._ptr(t, torch.float32)
    with pytest.raises(ValueError):
        kernels._ptr(t, torch.int32, (3, 2))
    with pytest.raises(ValueError):
        kernels._ptr(t.t(), torch.int32)  # not contiguous
    with pytest.raises(ValueError):
        kernels.stage_b(None, None, None, None, torch.zeros((1, 8192), dtype=torch.int32),
                        True, 1.0, 1, 0, None, None, None, None)


def test_launch_structs_point_into_live_tensors(fixture, monkeypatch):
    """At the launch of K2 and K3, and of pass 2 with the join or the prefix
    search inside, every address in their aggregation struct belongs to a
    tensor that is still alive (tests/test_torch_configs.py holds the other
    new entry points' arrays to the same). A table made inside the
    struct's builder and dropped before the launch is free memory that
    another thread's allocation may take and write first; the kernel then
    indexed the static columns with that data (the illegal address of
    pipeline-on serving, where two batcher threads allocate at once). Stand-in
    launches, so it runs without a card."""
    import gc
    import warnings

    rng, seg, starts, dfs, impact, L = fixture
    qs, aggs = query_batch(rng, seg, starts, dfs, impact)
    qs = doc_only(qs)
    cands = driver_candidates(rng, seg, qs.starts.shape[0], 128)
    facs = host_factors(seg, qs, cands)
    seg_t = segment_arrays_from_numpy(seg, device="cpu")
    seen = []

    def launch(a):
        with warnings.catch_warnings():  # isinstance touches deprecated module attributes
            warnings.simplefilter("ignore")
            live = {o.data_ptr() for o in gc.get_objects() if isinstance(o, torch.Tensor)}
        seen.append({f: getattr(a, f) in live
                     for f in ("bm25", "bm25f", "idf", "cov", "static_of_sig")})
    monkeypatch.setattr(kernels, "signals_q16", lambda seg, q, a, *rest: launch(a))
    monkeypatch.setattr(kernels, "stage_b", lambda seg, q, a, *rest: launch(a))
    monkeypatch.setattr(kernels, "signals_search", lambda seg, q, a, *rest, **kw: launch(a))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    OT.compute_signals_from_factors_batch_q16(seg_t, qs, aggs, facs, cands)
    OT.score_driver_batch_with_signals(seg_t, qs, facs, cands, aggs, True, 64, 32)
    OT.compute_signals_joined_batch_q16(seg_t, qs, aggs, cands)
    OT.compute_signals_joined(seg_t, OJ.QuerySlots(*[x[0] for x in qs]),
                              OJ.QueryAggregates(*[x[0] for x in aggs]), cands[0])
    OT.compute_signals_batch(seg_t, qs, aggs, cands, L)
    assert len(seen) == 5 and all(all(s.values()) for s in seen), seen


# ---- on the card ----------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    kernels.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("default_static", [True, False])
@pytest.mark.parametrize("soft_required", [True, False])
def test_stage_a_kernel_matches_plain(fixture, default_static, soft_required):
    dev = _card()
    rng, seg, starts, dfs, impact, L = fixture
    qs, _ = query_batch(rng, seg, starts, dfs, impact, default_static=default_static)
    seg_c = segment_arrays_from_numpy(seg, device=dev)
    d_k, s_k = OT.score_candidates_batch(seg_c, qs, L, 128, default_static, soft_required)
    q_c = OT.to_tensors(qs, dev)
    d_p, s_p = OT.score_candidates_batch_plain(seg_c, q_c, L, 128, default_static,
                                               soft_required)
    for b in range(qs.starts.shape[0]):
        assert_topk_match(d_p[b].cpu().numpy(), s_p[b].cpu().numpy(), d_k[b].cpu().numpy(),
                          s_k[b].cpu().numpy(), int(seg.num_docs), A_RTOL, A_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("default_static", [True, False])
def test_stage_b_kernel_matches_plain(fixture, default_static):
    dev = _card()
    rng, seg, starts, dfs, impact, L = fixture
    qs, aggs = query_batch(rng, seg, starts, dfs, impact, default_static=default_static)
    qs = doc_only(qs)
    cands = driver_candidates(rng, seg, qs.starts.shape[0], 512)
    facs = host_factors(seg, qs, cands)
    seg_c = segment_arrays_from_numpy(seg, device=dev)
    res_k = OT.score_driver_batch_with_signals(seg_c, qs, facs, cands, aggs, default_static,
                                               128, 64)
    res_p = OT.score_driver_batch_plain(
        seg_c, OT.to_tensors(qs, dev), torch.as_tensor(facs, device=dev),
        torch.as_tensor(cands, device=dev), default_static, 128,
        OT.to_tensors(aggs, dev), 64)
    d_k, s_k, sig_k = OT.unpack_stageb(res_k, 128, 46, 64)
    d_p, s_p, sig_p = OT.unpack_stageb(res_p, 128, 46, 64)
    for b in range(qs.starts.shape[0]):
        assert_topk_match(d_p[b], s_p[b], d_k[b], s_k[b], int(seg.num_docs), B_RTOL, B_ATOL)
        _assert_sig_match(d_p[b][:64], sig_p[b], res_p[3][b].cpu().numpy(), d_k[b][:64],
                          sig_k[b], res_k[3][b].cpu().numpy(), int(seg.num_docs))


@pytest.mark.cuda
def test_signals_kernel_matches_plain(fixture):
    dev = _card()
    rng, seg, starts, dfs, impact, L = fixture
    qs, aggs = query_batch(rng, seg, starts, dfs, impact)
    qs = doc_only(qs)
    cands = driver_candidates(rng, seg, qs.starts.shape[0], 128)
    facs = host_factors(seg, qs, cands)
    seg_c = segment_arrays_from_numpy(seg, device=dev)
    q_k, scl_k = OT.compute_signals_from_factors_batch_q16(seg_c, qs, aggs, facs, cands)
    q_p, scl_p = OT.compute_signals_from_factors_batch_q16_plain(
        seg_c, OT.to_tensors(qs, dev), OT.to_tensors(aggs, dev),
        torch.as_tensor(facs, device=dev), torch.as_tensor(cands, device=dev))
    torch.testing.assert_close(scl_k, scl_p, rtol=1e-5, atol=1e-35)
    assert (q_k.int() - q_p.int()).abs().max().item() <= 1


# ---- on the card: the other configurations' kernels -------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("row_layout", ["q16", "q8"])
@pytest.mark.parametrize("ub", [False, True])
def test_stage_a_q8_ub_kernel_matches_plain(fixture, row_layout, ub):
    dev = _card()
    rng, seg, starts, dfs, impact, L = fixture
    qs, _ = query_batch(rng, seg, starts, dfs, impact)
    ube, ubt = ub_inputs(rng, qs) if ub else (None, None)
    seg_c = segment_arrays_from_numpy(row_layout_of(seg, row_layout), device=dev)
    n = dict(kernels.LAUNCHES)
    d_k, s_k = OT.score_candidates_batch(seg_c, qs, L, 128, True, True, ube, ubt)
    name = "stage_a_ub" if ub else "stage_a_q8" if row_layout == "q8" else "stage_a"
    assert kernels.LAUNCHES[name] == n[name] + 1
    t = lambda x: None if x is None else torch.as_tensor(x, device=dev)  # noqa: E731
    d_p, s_p = OT.score_candidates_batch_plain(seg_c, OT.to_tensors(qs, dev), L, 128, True,
                                               True, t(ube), t(ubt))
    for b in range(qs.starts.shape[0]):
        assert_topk_match(d_p[b].cpu().numpy(), s_p[b].cpu().numpy(), d_k[b].cpu().numpy(),
                          s_k[b].cpu().numpy(), int(seg.num_docs), 1e-5, 5e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("row_layout", ["q16", "q8"])
def test_join_kernels_match_plain(fixture, row_layout):
    """stract_factors_join bit-equal; joined stage B and joined pass 2 against
    their plain versions (f32 rows rtol 1e-5, q16 rows within one step)."""
    dev = _card()
    rng, seg, starts, dfs, impact, L = fixture
    qs, aggs = query_batch(rng, seg, starts, dfs, impact)
    qs = doc_only(qs)
    cands = driver_candidates(rng, seg, qs.starts.shape[0], 512)
    seg_c = segment_arrays_from_numpy(row_layout_of(seg, row_layout), device=dev)
    q_c, a_c = OT.to_tensors(qs, dev), OT.to_tensors(aggs, dev)
    c_c = torch.as_tensor(cands, device=dev)
    f_k = OT.factors_join(seg_c, qs.starts, qs.lens, cands)
    f_p = OT.factors_join_plain(seg_c.postings, q_c.starts, q_c.lens, c_c)
    assert torch.equal(f_k, f_p) and bool((f_k != 0).any())
    d_k, s_k = OT.score_driver_joined_batch(seg_c, qs, cands, True, 128)
    d_p, s_p = OT.score_driver_joined_batch_plain(seg_c, q_c, c_c, True, 128)
    for b in range(qs.starts.shape[0]):
        assert_topk_match(d_p[b].cpu().numpy(), s_p[b].cpu().numpy(), d_k[b].cpu().numpy(),
                          s_k[b].cpu().numpy(), int(seg.num_docs), 1e-5, 1e-5)
    sig_p = OT.compute_signals_joined_batch_plain(seg_c, q_c, a_c, c_c)
    sig_k = OT.compute_signals_joined_batch(seg_c, qs, aggs, cands)
    torch.testing.assert_close(sig_k, sig_p, rtol=1e-5, atol=1e-6)
    q_k, scl_k = OT.compute_signals_joined_batch_q16(seg_c, qs, aggs, cands)
    q_p, scl_p = OT.quantize_signals(sig_p)
    torch.testing.assert_close(scl_k, scl_p, rtol=1e-5, atol=1e-35)
    assert (q_k.int() - q_p.int()).abs().max().item() <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("row_layout", ["q16", "q8"])
def test_prefix_signals_kernel_matches_plain(fixture, row_layout):
    dev = _card()
    rng, seg, starts, dfs, impact, L = fixture
    qs, aggs = query_batch(rng, seg, starts, dfs, impact)
    cands = driver_candidates(rng, seg, qs.starts.shape[0], 128)
    post = np.asarray(seg.postings)
    for b in range(qs.starts.shape[0]):
        s, l = int(qs.starts[b, 6]), int(qs.lens[b, 6])
        cands[b, :40] = post[s: s + min(l, 40), 0]
    seg_c = segment_arrays_from_numpy(row_layout_of(seg, row_layout), device=dev)
    for Lq in (37, 64, L):
        sig_k = OT.compute_signals_batch(seg_c, qs, aggs, cands, Lq)
        sig_p = OT.compute_signals_batch_plain(seg_c, OT.to_tensors(qs, dev),
                                               OT.to_tensors(aggs, dev),
                                               torch.as_tensor(cands, device=dev), Lq)
        torch.testing.assert_close(sig_k, sig_p, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_dense_rerank_kernel_matches_plain(dtype):
    dev = _card()
    g = torch.Generator().manual_seed(2)
    B, K, H, k = 4, 1000, 384, 20
    emb = torch.nn.functional.normalize(torch.randn((B, K, H), generator=g), dim=2)
    emb[:, 3] = 0
    emb = emb.to(dev, dtype)
    q = torch.randn((B, H), generator=g).to(dev)
    base = (0.1 * torch.randn((B, K), generator=g)).to(dev)
    i_k, s_k = RT.rerank_topk_batch(emb, q, base, 1.0, k)
    i_p, s_p = RT.rerank_topk_batch_plain(emb, q, base, 1.0, k)
    torch.testing.assert_close(s_k, s_p, rtol=0, atol=2e-6)
    assert (i_k == i_p).float().mean().item() > 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("row_layout", ["q16", "q8"])
@pytest.mark.parametrize("default_static,ub", [(True, False), (False, False), (True, True)])
def test_stage_a_merge_kernel_matches_plain(fixture, row_layout, default_static, ub):
    """K13: the network's keys and payloads bit-equal to the plain merge's
    (rows with tf-ordered impact slots included), and the candidates of the
    tail at stage A's tolerance, compared as multisets of (doc, score)."""
    dev = _card()
    rng, seg, starts, dfs, impact, L = fixture
    qs, _ = query_batch(rng, seg, starts, dfs, impact, default_static=default_static)
    u, t = ub_inputs(rng, qs) if ub else (None, None)
    seg_c = segment_arrays_from_numpy(row_layout_of(seg, row_layout), device=dev)
    net_k = OT.stage_a_network(seg_c, qs, L, u)
    q_c = OT.to_tensors(qs, dev)
    u_c = None if u is None else torch.as_tensor(u, device=dev)
    keys, contrib, aux, _ = OT._stage_a_entries(seg_c, q_c, L, u_c)
    kp, (cp, ap) = OT.merge_sorted_tiles_plain(keys, contrib, aux)
    assert torch.equal(net_k[0], kp) and torch.equal(net_k[2], ap)
    assert torch.equal(net_k[1].view(torch.int32), cp.view(torch.int32))
    d_k, s_k = OT.score_candidates_batch(seg_c, qs, L, 128, default_static, True, u, t,
                                         merge=True)
    t_c = None if t is None else torch.as_tensor(t, device=dev)
    d_p, s_p = OT.score_candidates_batch_plain(seg_c, q_c, L, 128, default_static, True, u_c,
                                               t_c, merge=True)
    for b in range(qs.starts.shape[0]):
        assert_topk_runs_match(d_p[b].cpu().numpy(), s_p[b].cpu().numpy(),
                               d_k[b].cpu().numpy(), s_k[b].cpu().numpy(), int(seg.num_docs),
                               A_RTOL, A_ATOL)
