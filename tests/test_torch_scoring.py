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


def _without_padding(seg, L):
    """The fixture's segment without the L pad rows behind its last list."""
    return seg._replace(postings=np.asarray(seg.postings)[:-L])


def _clamped_windows(seg, qs, L):
    """→ (the used slots whose L-row window the clamp to n_rows - L moves
    onto the rows before their list, whether one such window holds a doc
    twice)."""
    post = np.asarray(seg.postings)
    n = post.shape[0]
    lens = np.minimum(np.asarray(qs.lens), L)
    moved = (lens > 0) & (np.asarray(qs.starts).astype(np.int64) > n - L)
    twice = False
    for b, p in zip(*np.nonzero(moved)):
        docs = post[max(n - L, 0): max(n - L, 0) + lens[b, p], 0]
        twice |= len(np.unique(docs)) < len(docs)
    return moved, twice


def test_stage_a_plain_matches_jax_on_clamped_windows(fixture):
    """A slot whose window the clamp moved reads the rows before its list,
    other lists' rows, so a doc may stand twice in one slot: both packages
    sum both rows (here: the segment without its tail padding, L = 512, past
    the last impact prefix)."""
    rng, seg, starts, dfs, impact, L = fixture
    qs, _ = query_batch(rng, seg, starts, dfs, impact)
    seg_n = _without_padding(seg, L)
    moved, twice = _clamped_windows(seg_n, qs, 512)
    assert moved.any() and twice
    _compare_stage_a(seg_n, qs, 512, 128, True, True)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("entries,B,form", [
    (0, 32, "block"), (500, 32, "block"), (4522, 256, "block"), (6613, 32, "cluster"),
    (4522, 1, "cluster"), (43690, 32, "cluster"), (43691, 32, "global"), (65536, 4, "global"),
    (65536, 64, "global"), (200000, 32, "global")])
def test_stage_a_plan_sizes_the_table_from_entries(entries, B, form, sms):
    """K1's table: the least power of two of at least 3E/2 (and 64) slots; the
    blocks a query needs to hold it in shared memory beside the sort
    buffers, more while the launch fits the card's SMs (an H100 SXM's 132, a
    PCIe card's 114) and each block keeps STAGE_A_MIN_PART slots; global
    memory past MAX_CLUSTER blocks, its select over MAX_CLUSTER blocks."""
    K = 4096
    plan = kernels.stage_a_plan(entries, B, K, sms)
    T, c = plan.slots, plan.cluster
    assert plan.form == form and plan.entries == entries
    assert T & (T - 1) == 0 and 2 * T >= 3 * entries and T >= 64
    assert T == 64 or 2 * (T // 2) < 3 * entries
    assert c in (1, 2, 4, 8) and (c == 1) == (form == "block") or form == "global"
    fits = lambda blocks: (T // blocks * kernels.STAGE_A_SLOT_BYTES + 8 * K  # noqa: E731
                           <= kernels.STAGE_A_DYN_SMEM)
    if form == "global":  # the select over 8 blocks a query
        assert not fits(kernels.MAX_CLUSTER) and c == kernels.MAX_CLUSTER
    else:
        assert fits(c) and (c == 1 or not fits(c // 2) or B * c <= sms)
        assert c == 1 or T // c >= kernels.STAGE_A_MIN_PART or not fits(c // 2)
        assert B * c <= sms or c == 1 or not fits(c // 2)


@pytest.mark.parametrize("entries,launches", [
    ([4522, 6613, 0], [(None, "cluster")]),
    ([65536, 43691], [(None, "global")]),
    ([4522, 65536, 100, 43691, 43690], [([0, 2, 4], "cluster"), ([1, 3], "global")]),
    ([65536, 1], [([1], "block"), ([0], "global")])])
def test_stage_a_launches_keep_short_queries_on_chip(entries, launches):
    """A batch whose tables all take one kind of memory is one launch planned
    from its largest query; one that mixes them is two, the queries whose
    tables fit shared memory planned apart from the rest, so a long query
    leaves the short ones' tables on chip."""
    got = kernels.stage_a_launches(np.array(entries), 4096, 132)
    assert [(None if r is None else r.tolist(), p.form) for r, p in got] == launches
    for rows, plan in got:
        idx = np.arange(len(entries)) if rows is None else rows
        assert rows is None or rows.dtype == np.int32
        assert plan == kernels.stage_a_plan(max(entries[i] for i in idx), len(idx), 4096, 132)


@pytest.mark.parametrize("on_card", [False, True])
def test_stage_a_counts_entries_from_the_slots_as_passed(fixture, monkeypatch, on_card):
    """score_candidates_batch sizes K1's table from each query's posting
    rows, sum_p min(len_p, L): from numpy slots (the index's) with no read
    of the device (Tensor.cpu refused), from slots already in tensors with
    one copy of their lens. Stand-in launch, so it runs without a card."""
    rng, seg, starts, dfs, impact, L = fixture
    qs, _ = query_batch(rng, seg, starts, dfs, impact)
    want = np.minimum(qs.lens, L).sum(axis=1)
    assert (OT.stage_a_entries(qs.lens, L) == want).all()
    seg_t = segment_arrays_from_numpy(seg, device="cpu")
    seen, copies = [], []
    monkeypatch.setattr(kernels, "stage_a", lambda seg, q, L, K, plan, table, *a:
                        seen.append((plan, table, a[-1])))
    monkeypatch.setattr(kernels, "card_sms", lambda dev: 132)
    if on_card:
        qs = OT.to_tensors(qs, "cpu")
        cpu = torch.Tensor.cpu
        monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k:
                            copies.append(tuple(self.shape)) or cpu(self, *a, **k))
    else:
        monkeypatch.setattr(torch.Tensor, "cpu", lambda self, *a, **k:
                            pytest.fail("the slots' tensors were read back"))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    OT.score_candidates_batch(seg_t, qs, L, 128, True, True)
    assert seen == [(kernels.stage_a_plan(int(want.max()), qs.starts.shape[0], 128, 132), None,
                     None)]
    assert copies == ([tuple(qs.lens.shape)] if on_card else [])


def test_stage_a_scores_a_mixed_batch_in_two_launches(fixture, monkeypatch):
    """A batch of one long query (E past what 8 blocks' shared memory holds)
    among short ones: the short queries' launch keeps its shared-memory
    table, the long one gets a global table of its own, [1, T], and each
    launch names its queries' rows. Stand-in launch."""
    rng, seg, starts, dfs, impact, _ = fixture
    L = 1024
    qs, _ = query_batch(rng, seg, starts, dfs, impact, B=4, P=64)
    lens = np.zeros((4, 64), np.int32)
    lens[:, :6] = 700
    lens[2] = 1024  # E = 65,536
    qs = qs._replace(lens=lens)
    seg = segment_arrays_from_numpy(seg, device="cpu")
    seen = []
    monkeypatch.setattr(kernels, "stage_a", lambda seg, q, L, K, plan, table, *a:
                        seen.append((plan, None if table is None else
                                     [tuple(t.shape) for t in table], a[-1].tolist())))
    monkeypatch.setattr(kernels, "card_sms", lambda dev: 132)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    OT.score_candidates_batch(seg, qs, L, 4096, True, True)
    short, long = kernels.stage_a_plan(4200, 3, 4096, 132), kernels.stage_a_plan(65536, 1, 4096,
                                                                                   132)
    assert short.form == "cluster" and long.form == "global"
    assert seen == [(short, None, [0, 1, 3]), (long, [(1, long.slots)] * 4, [2])]


def test_stage_a_and_b_plans_are_checked_before_a_launch(monkeypatch):
    """K1's plan and table and K2's cluster raise ValueError before the
    library is loaded."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(kernels, "_load", lambda name: pytest.fail("reached the launch"))
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731

    class Seg:
        postings = i32(64, 3)

    q = type("Q", (), {"starts": i32(2, 16)})()
    ok = kernels.stage_a_plan(500, 2, 128, 132)
    big = kernels.StageAPlan(60000, 131072, 4, "cluster")
    glob = big._replace(form="global")
    for plan, table, rows in (
            (ok._replace(cluster=3), None, None), (ok._replace(cluster=16), None, None),
            (ok._replace(slots=1000), None, None), (big, None, None),  # a part past shared memory
            (glob, None, None),  # the global form without its table
            (ok, (i32(2, ok.slots),) * 4, None),  # a table beside shared memory
            (glob, (i32(2, 64),) * 4, None),  # a table's shape
            (glob, (i32(2, glob.slots),) * 4, i32(1)),  # a table of other rows than launched
            (ok, None, i32(1, 2)), (ok, None, i32(3)), (ok, None, i32(0))):  # the rows' shape
        with pytest.raises(ValueError):
            kernels.stage_a(Seg, q, 128, 128, plan, table, True, True, 1.0, None, None,
                            rows=rows)
    for cluster in (3, 16, 8):  # 8 blocks for Kd = 4 columns
        monkeypatch.setattr(kernels, "stage_b_cluster", lambda Kd, c=cluster: c)
        with pytest.raises(ValueError):
            kernels.stage_b(Seg, q, None, None, i32(2, 4), True, 1.0, 4, 0, None, None, None,
                            None)


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
    monkeypatch.setattr(kernels, "card_sms", lambda dev: 132)
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
    """At the launch of K2 and K3 (also after the join, in the joined pass
    2) and of K12, the prefix search, every address in their aggregation
    struct belongs to a tensor that is still alive
    (tests/test_torch_configs.py holds the other
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

    def launch(a, fields=("bm25", "bm25f", "idf", "cov", "static_of_sig")):
        with warnings.catch_warnings():  # isinstance touches deprecated module attributes
            warnings.simplefilter("ignore")
            live = {o.data_ptr() for o in gc.get_objects() if isinstance(o, torch.Tensor)}
        seen.append({f: getattr(a, f) in live for f in fields})
    k3_fields = ("idf", "region_lut", "current_ts", "bm25", "bm25f", "aidf", "cov",
                 "static_of_sig")
    monkeypatch.setattr(kernels, "signals_q16", lambda seg, a, *rest, **kw: launch(a, k3_fields))
    monkeypatch.setattr(kernels, "stage_b", lambda seg, q, a, *rest: launch(a))
    monkeypatch.setattr(kernels, "factors_join", lambda *a: None)
    monkeypatch.setattr(kernels, "signals_prefix", lambda seg, q, a, *rest: launch(a))
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


def _pass2_case(fixture, K: int, P: int):
    """Slots of P (the fixture's 16 slots cut to P, or padded with repeats of
    their terms past it), their aggregates, K candidates (with pad docs) and
    their host-joined factors."""
    rng, seg, starts, dfs, impact, L = fixture
    qs, aggs = query_batch(rng, seg, starts, dfs, impact)
    qs = doc_only(qs)
    idx = np.arange(P) % qs.starts.shape[1]
    qs = qs._replace(**{f: np.ascontiguousarray(getattr(qs, f)[:, idx])
                        for f in ("starts", "lens", "group", "idf", "w_bm25", "w_bm25f",
                                  "w_presence")})
    aggs = type(aggs)(*[np.ascontiguousarray(np.asarray(x)[..., idx]) for x in aggs])
    D, B, pads = int(seg.num_docs), qs.starts.shape[0], K // 10
    cands = np.full((B, K), D, np.int32)  # the last tenth pads
    for b in range(B):
        cands[b, :K - pads] = np.sort(rng.choice(D, K - pads, replace=K - pads > D))
    return seg, qs, aggs, cands, host_factors(seg, qs, cands)


@pytest.mark.parametrize("Kd", [1, 2, 127, 128, 512, 4095, 4096])
def test_join_plan_over_lengths_and_candidates(Kd):
    """K11's plan: a slot no longer than the sample is staged whole, a longer
    one searched from its sample (within JOIN_CAP docs, a block's shared
    memory within 64 KB), an empty one written as zeros, and one of 2^steps
    rows or more (the reference's step count stops short) takes the
    reference's loop."""
    plan = kernels.join_plan(Kd)
    assert 1 <= plan.sample <= kernels.JOIN_CAP and 4 * plan.sample <= 64 * 1024
    n_rows = (1 << 24) + 1
    for length in sorted({0, 1, 2, plan.sample, plan.sample + 1, 1 << 12, 1 << 20, 1 << 24}):
        want = "empty" if length == 0 else "whole" if length <= plan.sample else "sample"
        assert kernels.join_regime(length, n_rows, plan) == want, length
    assert kernels.join_steps(1 << 24) == 24
    assert kernels.join_regime(1 << 24, 1 << 24, plan) == "reference"
    assert kernels.join_regime((1 << 24) - 1, 1 << 24, plan) != "reference"
    assert kernels.join_steps(2) == 1 and kernels.join_regime(2, 2, plan) == "reference"


def test_signals_plan_keeps_the_main_path_on_chip():
    """K3's plan: the main path's P = 16 up to K = 4,096 wholly in shared
    memory; larger K with its values in device memory; P past shared memory
    with its coefficients read where they lie; f32 rows always go out."""
    for K in (1, 128, 512, 4096):
        assert kernels.signals_plan(16, K, True) == kernels.SignalsPlan(True, True)
        assert kernels.signals_plan(16, K, False) == kernels.SignalsPlan(True, False)
    assert kernels.signals_plan(16, 100_000, True) == kernels.SignalsPlan(True, False)
    assert kernels.signals_plan(8192, 128, True) == kernels.SignalsPlan(False, False)


def test_joined_forms_check_before_any_launch(fixture, monkeypatch):
    """The joined stage B refuses what K2 refuses (more than 4,096 candidates,
    k > Kd) before the join launches."""
    rng, seg, starts, dfs, impact, L = fixture
    qs, _ = query_batch(rng, seg, starts, dfs, impact)
    seg_t = segment_arrays_from_numpy(seg, device="cpu")
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(kernels, "factors_join", lambda *a: pytest.fail("the join launched"))
    B = qs.starts.shape[0]
    for Kd in (4097, 8192):
        with pytest.raises(ValueError):
            OT.score_driver_joined_batch(seg_t, qs, np.zeros((B, Kd), np.int32), True, 128)


def test_signals_kernel_arguments_are_checked(monkeypatch):
    """K3's wrapper raises before any build or launch: no candidates, more
    than 65,535 queries, no signal rows; its argument block takes each
    query's rows contiguous, in f32."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(kernels, "_load", lambda name: pytest.fail("built before the checks"))
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    out = lambda K, n=46: (torch.zeros((2, n, K), dtype=torch.int16), torch.zeros((2, n)))  # noqa
    a = kernels.SignalArgs(P=16, nsig=46)
    with pytest.raises(ValueError):
        kernels.signals_q16(None, a, i32(2, 16, 0), i32(2, 0), 1.0, *out(0))
    with pytest.raises(ValueError):
        kernels.signals_q16(None, a, i32(1), i32(65536, 8), 1.0, *out(8))
    with pytest.raises(ValueError):
        kernels.signals_q16(None, kernels.SignalArgs(P=16, nsig=0), i32(2, 16, 8), i32(2, 8),
                            1.0, *out(8, 0))
    rows = [torch.zeros(s) for s in ((2, 16), (2, 16), (2,), (2, 46, 16), (2, 1, 16),
                                     (2, 46, 16), (2, 46, 16))]
    table = torch.zeros(46, dtype=torch.int32)
    kernels.signal_args(rows, table, 1, 2, 3)
    for bad in (torch.zeros((2, 16, 46)).transpose(1, 2), torch.zeros((2, 46, 16)).double()):
        with pytest.raises(ValueError):
            kernels.signal_args(rows[:3] + [bad] + rows[4:], table, 1, 2, 3)


def test_signals_dispatch_uploads_what_the_kernel_reads(fixture, monkeypatch):
    """A CUDA segment's pass 2 reaches signals_q16 once, never its plain
    version. With numpy inputs (the index's) three copies go to the card:
    the factors, the candidates, and one buffer holding every row the
    kernel reads (the argument block's rows its views, one stride); with
    tensors already on the card none, the block pointing at them. Stand-in
    launch, so it runs without a card."""
    seg, qs, aggs, cands, facs = _pass2_case(fixture, 128, 16)
    seg_t = segment_arrays_from_numpy(seg, device="cpu")
    seen, copies = [], []
    to = torch.Tensor.to

    def counted_to(self, *a, **kw):
        copies.append(1)
        return to(self, *a, **kw)
    monkeypatch.setattr(kernels, "signals_q16",
                        lambda seg, a, f, c, fs, q, sc: seen.append((a, f, c, q.shape, sc.shape)))
    monkeypatch.setattr(OT, "compute_signals_from_factors_batch_q16_plain",
                        lambda *a: seen.append("plain"))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(torch.Tensor, "to", counted_to)
    OT.compute_signals_from_factors_batch_q16(seg_t, qs, aggs, facs, cands)
    assert len(seen) == 1 and seen[0] != "plain" and len(copies) == 3, (seen, copies)
    a, f, c, qshape, sshape = seen[0]
    B, P = qs.starts.shape
    width = P + 16 + 1 + 3 * 46 * P + P
    assert list(a.stride) == [width] * 7 and (a.P, a.nsig) == (P, 46)
    assert a.region_lut - a.idf == 4 * P and a.cov - a.idf == 4 * (width - 46 * P)
    assert tuple(f.shape) == (B, P, 128) and qshape == (B, 46, 128) and sshape == (B, 46)
    q_t, a_t = OT.to_tensors(qs, "cpu"), OT.to_tensors(aggs, "cpu")
    seen.clear()
    copies.clear()
    OT.compute_signals_from_factors_batch_q16(seg_t, q_t, a_t, torch.as_tensor(facs),
                                              torch.as_tensor(cands))
    a = seen[0][0]
    assert not copies and (a.idf, a.bm25, a.cov) == (q_t.idf.data_ptr(), a_t.agg_bm25.data_ptr(),
                                                    a_t.agg_cov.data_ptr())


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 128, 512, 4096])
@pytest.mark.parametrize("P", [1, 16, 64])
def test_signals_kernel_matches_plain(fixture, K, P):
    """K3 (2 signal rows a block) against its plain version
    (scales rtol 1e-5, q16 rows within one step), its inputs as the index
    passes them (numpy) and already on the card; two calls bit-equal."""
    dev = _card()
    seg, qs, aggs, cands, facs = _pass2_case(fixture, K, P)
    seg_c = segment_arrays_from_numpy(seg, device=dev)
    n = kernels.LAUNCHES["signals_q16"]
    q_k, scl_k = OT.compute_signals_from_factors_batch_q16(seg_c, qs, aggs, facs, cands)
    q_c, a_c = OT.to_tensors(qs, dev), OT.to_tensors(aggs, dev)
    f_c, c_c = torch.as_tensor(facs, device=dev), torch.as_tensor(cands, device=dev)
    q_2, scl_2 = OT.compute_signals_from_factors_batch_q16(seg_c, q_c, a_c, f_c, c_c)
    assert kernels.LAUNCHES["signals_q16"] == n + 2
    assert torch.equal(q_k, q_2) and torch.equal(scl_k.view(torch.int32), scl_2.view(torch.int32))
    q_p, scl_p = OT.compute_signals_from_factors_batch_q16_plain(seg_c, q_c, a_c, f_c, c_c)
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


# K11's two regimes forced on every slot: each range staged whole, and each
# searched from an 8-doc sample (the probes in device memory below it)
JOIN_REGIMES = {"whole": kernels.JoinPlan(kernels.JOIN_CAP), "sample": kernels.JoinPlan(8)}


@pytest.mark.cuda
@pytest.mark.parametrize("row_layout", ["q16", "q8"])
@pytest.mark.parametrize("regime", ["whole", "sample"])
def test_join_kernels_match_plain(fixture, row_layout, regime, monkeypatch):
    """K11 bit-equal to the plain join in each regime, on candidates with
    duplicates and pad docs, two calls bit-equal; joined stage B equal to K2
    over that join bit for bit (and to its plain version within stage B's
    tolerance); joined pass 2 equal to K3 over it bit for bit, q16 and f32
    rows (and within one q16 step, f32 rtol 1e-5, of the plain version)."""
    dev = _card()
    monkeypatch.setattr(kernels, "join_plan", lambda Kd: JOIN_REGIMES[regime])
    rng, seg, starts, dfs, impact, L = fixture
    qs, aggs = query_batch(rng, seg, starts, dfs, impact)
    qs = doc_only(qs)
    cands = driver_candidates(rng, seg, qs.starts.shape[0], 512)
    cands[:, 5], cands[:, 9] = cands[:, 3], int(seg.num_docs)  # a duplicate, a pad doc
    seg_c = segment_arrays_from_numpy(row_layout_of(seg, row_layout), device=dev)
    n_rows = seg_c.postings.shape[0]
    assert regime in {kernels.join_regime(int(n), n_rows, JOIN_REGIMES[regime])
                      for n in qs.lens.ravel()}
    q_c, a_c = OT.to_tensors(qs, dev), OT.to_tensors(aggs, dev)
    c_c = torch.as_tensor(cands, device=dev)
    f_k = OT.factors_join(seg_c, qs.starts, qs.lens, cands)
    f_p = OT.factors_join_plain(seg_c.postings, q_c.starts, q_c.lens, c_c)
    assert torch.equal(f_k, f_p) and bool((f_k != 0).any())
    assert torch.equal(OT.factors_join(seg_c, q_c.starts, q_c.lens, c_c), f_k)
    n = dict(kernels.LAUNCHES)
    d_k, s_k = OT.score_driver_joined_batch(seg_c, qs, cands, True, 128)
    assert [kernels.LAUNCHES[k] - n[k] for k in ("stage_b_joined", "stage_b")] == [1, 1]
    d_2, s_2 = OT.score_driver_batch(seg_c, q_c, f_p, c_c, True, 128)
    assert torch.equal(d_k, d_2) and torch.equal(s_k.view(torch.int32), s_2.view(torch.int32))
    d_p, s_p = OT.score_driver_joined_batch_plain(seg_c, q_c, c_c, True, 128)
    for b in range(qs.starts.shape[0]):
        assert_topk_match(d_p[b].cpu().numpy(), s_p[b].cpu().numpy(), d_k[b].cpu().numpy(),
                          s_k[b].cpu().numpy(), int(seg.num_docs), 1e-5, 1e-5)
    f32_rows = {}
    for K in (128, 512):
        page = c_c[:, :K].contiguous()
        facs = f_p[:, :, :K].contiguous()
        n = dict(kernels.LAUNCHES)
        q_k, scl_k = OT.compute_signals_joined_batch_q16(seg_c, qs, aggs, page)
        assert [kernels.LAUNCHES[k] - n[k] for k in ("signals_joined", "signals_q16")] == [1, 1]
        q_3, scl_3 = OT.compute_signals_from_factors_batch_q16(seg_c, q_c, a_c, facs, page)
        assert torch.equal(q_k, q_3) and torch.equal(scl_k.view(torch.int32),
                                                     scl_3.view(torch.int32))
        sig_k = OT.compute_signals_joined_batch(seg_c, qs, aggs, page)
        f32_rows[K] = OT._signals_k3(seg_c, q_c, a_c, facs, page, False)
        assert torch.equal(sig_k.view(torch.int32), f32_rows[K].view(torch.int32))
        sig_p = OT.compute_signals_joined_batch_plain(seg_c, q_c, a_c, page)
        torch.testing.assert_close(sig_k, sig_p, rtol=1e-5, atol=1e-6)
        q_p, scl_p = OT.quantize_signals(sig_p)
        torch.testing.assert_close(scl_k, scl_p, rtol=1e-5, atol=1e-35)
        assert (q_k.int() - q_p.int()).abs().max().item() <= 1
    sig1 = OT.compute_signals_joined(seg_c, OJ.QuerySlots(*[x[0] for x in qs]),
                                     OJ.QueryAggregates(*[x[0] for x in aggs]), cands[0, :128])
    assert torch.equal(sig1.view(torch.int32), f32_rows[128][0].view(torch.int32))


@pytest.mark.cuda
def test_join_kernel_keeps_the_references_step_count():
    """A slot whose range is all of 64 rows (a power of two): the reference's
    6 steps stop short of its lower bound, and K11 returns what the
    reference returns there; one row fewer converges, as the searches do."""
    dev = _card()
    docs = np.arange(0, 128, 2, dtype=np.int32)
    post = np.stack([docs, docs + 1000, np.zeros_like(docs)], axis=1)
    postings = torch.as_tensor(post, device=dev)
    seg = type("Seg", (), {"postings": postings})()
    cand = torch.as_tensor(np.arange(0, 130, dtype=np.int32)[None], device=dev)
    for n in (64, 63):
        starts = torch.zeros((1, 1), dtype=torch.int32, device=dev)
        lens = torch.full((1, 1), n, dtype=torch.int32, device=dev)
        out = torch.empty((1, 1, 130), dtype=torch.int32, device=dev)
        kernels.factors_join(seg, starts, lens, cand, out)
        assert torch.equal(out, OT.factors_join_plain(postings, starts, lens, cand))
    assert kernels.join_regime(64, 64, kernels.join_plan(130)) == "reference"


@pytest.mark.cuda
@pytest.mark.parametrize("K, P", [(4100, 16), (300, 6000), (512, 16)])
def test_signals_kernel_takes_any_k_and_p(fixture, K, P):
    """K3 past its shared memory (the values in device memory at K = 4,100;
    the coefficients read where they lie too at P = 6,000) against its plain
    version, and its f32 rows, which quantise to its q16 rows bit for bit."""
    dev = _card()
    seg, qs, aggs, cands, facs = _pass2_case(fixture, K, P)
    seg_c = segment_arrays_from_numpy(seg, device=dev)
    q_c, a_c = OT.to_tensors(qs, dev), OT.to_tensors(aggs, dev)
    f_c, c_c = torch.as_tensor(facs, device=dev), torch.as_tensor(cands, device=dev)
    q_k, scl_k = OT.compute_signals_from_factors_batch_q16(seg_c, q_c, a_c, f_c, c_c)
    q_p, scl_p = OT.compute_signals_from_factors_batch_q16_plain(seg_c, q_c, a_c, f_c, c_c)
    torch.testing.assert_close(scl_k, scl_p, rtol=1e-5, atol=1e-35)
    assert (q_k.int() - q_p.int()).abs().max().item() <= 1
    sig_k = OT._signals_k3(seg_c, q_c, a_c, f_c, c_c, False)
    torch.testing.assert_close(sig_k, OT._signals_tail_plain(seg_c, q_c, a_c, f_c, c_c),
                               rtol=1e-5, atol=1e-6)
    q_f, scl_f = OT.quantize_signals(sig_k)
    assert torch.equal(q_f, q_k) and torch.equal(scl_f.view(torch.int32), scl_k.view(torch.int32))


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
@pytest.mark.parametrize("plan", ["plan", "groups_of_1", "groups_of_3", "unstaged_tile",
                                  "unstaged_coefficients", "one_candidate", "one_block"])
def test_prefix_signals_kernel_matches_plain_over_its_plans(fixture, plan, monkeypatch):
    """K12 over 64 live slots a query at L = 1,024 (64 x 4 KB pass one
    block's staging: prefix_plan takes them in two groups), an impact slot
    among them, and under other plans: one and three prefixes at a time, the
    prefixes read where they lie (group 0), the coefficients read where they
    lie, one candidate a block, and 512 (one block a query, a thread summing
    16 rows). The same rows as the plan's, bit for bit (the same searches
    and sums), and within P12's tolerance of the plain version."""
    dev = _card()
    rng, seg, starts, dfs, impact, _ = fixture
    qs, aggs = query_batch(rng, seg, starts, dfs, impact, P=64)
    B, L = qs.starts.shape[0], 1024
    terms = rng.integers(0, len(dfs), (B, 57))
    qs.starts[:, 7:], qs.lens[:, 7:], qs.idf[:, 7:] = starts[terms], dfs[terms], 1.5
    for b in range(B):
        for p in range(7, 64):
            aggs.agg_bm25[b, 5 + p % 7, p] = aggs.agg_cov[b, 20 + p % 5, p] = 0.25
    cands = driver_candidates(rng, seg, B, 512)
    seg_c = segment_arrays_from_numpy(seg, device=dev)
    plan_of = kernels.prefix_plan
    assert 0 < plan_of(64, L, 512, 46).group < 64
    want = OT.compute_signals_batch(seg_c, qs, aggs, cands, L)
    change = {"plan": {}, "groups_of_1": {"group": 1}, "groups_of_3": {"group": 3},
              "unstaged_tile": {"group": 0}, "unstaged_coefficients": {"staged": False},
              "one_candidate": {"cands": 1},
              "one_block": {"cands": 512, "staged": False, "group": 8}}[plan]
    monkeypatch.setattr(kernels, "prefix_plan", lambda *a: plan_of(*a)._replace(**change))
    got = OT.compute_signals_batch(seg_c, qs, aggs, cands, L)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    sig_p = OT.compute_signals_batch_plain(seg_c, OT.to_tensors(qs, dev), OT.to_tensors(aggs, dev),
                                           torch.as_tensor(cands, device=dev), L)
    torch.testing.assert_close(got, sig_p, rtol=1e-5, atol=1e-5)
    assert bool((got != 0).any())


RERANK_TOL = (1e-6, 2e-6)  # rtol, atol: the dot products' sums in another order


def _rerank_case(B: int, K: int, H: int, dtype, dev, seed: int):
    """Seeded rerank inputs on the card: L2-normalised rows (row 3 zero,
    rows 7 and 8 equal with equal bases: a tie), a query a row, small
    bases."""
    g = torch.Generator().manual_seed(seed)
    emb = torch.nn.functional.normalize(torch.randn((B, K, H), generator=g), dim=2)
    emb[:, 3] = 0
    emb[:, 8] = emb[:, 7]
    base = 0.1 * torch.randn((B, K), generator=g)
    base[:, 8] = base[:, 7]
    return emb.to(dev, dtype), torch.randn((B, H), generator=g).to(dev), base.to(dev)


def _assert_rerank_matches(got, want) -> None:
    """Scores within RERANK_TOL, indices equal except where the plain
    version's score ties with another within that tolerance."""
    (i_k, s_k), (i_p, s_p) = got, want
    torch.testing.assert_close(s_k, s_p, rtol=RERANK_TOL[0], atol=RERANK_TOL[1])
    i_k, i_p, s_p = i_k.cpu().numpy(), i_p.cpu().numpy(), s_p.cpu().numpy()
    for b, pos in zip(*np.nonzero(i_k != i_p)):
        near = np.abs(s_p[b] - s_p[b, pos]) <= RERANK_TOL[1] + RERANK_TOL[0] * abs(s_p[b, pos])
        assert near.sum() > 1, (b, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_dense_rerank_kernel_matches_plain(dtype):
    """K10 at the smoke's shape (32 queries x 1,024 candidates x 384 dims,
    k = 20) against its plain version: scores within rtol 1e-6, atol 2e-6,
    indices equal except ties within that tolerance (the tied rows 7 and 8
    in index order); two calls bit-equal (the tickets left at zero)."""
    dev = _card()
    emb, q, base = _rerank_case(32, 1024, 384, dtype, dev, seed=2)
    for weight in (1.0, 0.01):
        got = RT.rerank_topk_batch(emb, q, base, weight, 20)
        _assert_rerank_matches(got, RT.rerank_topk_batch_plain(emb, q, base, weight, 20))
        again = RT.rerank_topk_batch(emb, q, base, weight, 20)
        assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("K,H", [(5000, 1536), (5000, 1100), (4097, 4100), (10_000, 64),
                                 (1, 384)])
def test_dense_rerank_kernel_takes_any_k_and_h(K, H, dtype):
    """K10 past the old limits of 4,096 candidates and 1,024 dims: k = 1,
    20 and K (every candidate; at K = 10,000 the tiles' lists are read
    where they lie, past shared memory), rows of 16-byte pieces (H = 1,536)
    and of single elements (H = 1,100; 4,100 in f16 and bf16: the query
    staged in two chunks), one candidate; against the plain version as
    above."""
    dev = _card()
    emb, q, base = (_rerank_case(3, K, H, dtype, dev, seed=K + H) if K > 8 else
                    (torch.ones((3, 1, H), device=dev, dtype=dtype),
                     torch.ones((3, H), device=dev), torch.zeros((3, 1), device=dev)))
    for k in sorted({1, min(20, K), K}):
        _assert_rerank_matches(RT.rerank_topk_batch(emb, q, base, 0.5, k),
                               RT.rerank_topk_batch_plain(emb, q, base, 0.5, k))


@pytest.mark.cuda
def test_dense_rerank_kernel_orders_signed_zeros():
    """Totals of -0 and +0 (zero rows, weight -1, bases -0 and +0) come out
    +0 above -0, ties to the lower index, as lax.top_k on the CPU and the
    plain version order them: indices [1, 3, 0, 2]."""
    dev = _card()
    emb = torch.zeros((2, 4, 64), device=dev)
    q = torch.ones((2, 64), device=dev)
    base = torch.tensor([[-0.0, 0.0, -0.0, 0.0]] * 2, device=dev)
    idx, scores = RT.rerank_topk_batch(emb, q, base, -1.0, 4)
    assert idx.tolist() == [[1, 3, 0, 2]] * 2
    assert torch.signbit(scores).tolist() == [[False, False, True, True]] * 2
    assert torch.equal(idx, RT.rerank_topk_batch_plain(emb, q, base, -1.0, 4)[0])


def _merge_case(fixture, form: str, default_static: bool):
    """Slots (B = 3) and L whose queries take K13's `form`: "block" the
    fixture's 16 slots at L = 256 (N = 4,096: one block); "global" 256
    slots (N = 65,536, the main path's), "global_wide" 512 (N = 131,072),
    their slots past the fixture's seven each a term of the fixture, so a
    doc's entries stand in runs across the tiles' boundaries; the third
    query's slots all windows of the longest list, started 0, 1 or 2 rows
    in, so that its runs cross every boundary."""
    rng, seg, starts, dfs, impact, L = fixture
    P = {"block": 16, "global": 256, "global_wide": 512}[form]
    qs, _ = query_batch(rng, seg, starts, dfs, impact, B=3, P=P, default_static=default_static)
    if P > 16:
        terms = rng.integers(0, len(dfs), (3, P - 7))
        st, ln = qs.starts.copy(), qs.lens.copy()
        st[:, 7:], ln[:, 7:] = starts[terms], dfs[terms]
        top = int(np.argmax(dfs))
        st[2], ln[2] = starts[top] + np.arange(P) % 3, dfs[top] - 2
        idf = np.log1p((int(seg.num_docs) - ln + 0.5) / (ln + 0.5)).astype(np.float32)
        extra = lambda w, x: np.where(np.arange(P) < 7, w, x).astype(np.float32)  # noqa: E731
        qs = qs._replace(starts=st, lens=ln, idf=extra(qs.idf, idf),
                         w_bm25=extra(qs.w_bm25, 0.5 * idf), w_bm25f=extra(qs.w_bm25f, 0.1 * idf),
                         w_presence=extra(qs.w_presence, 0.05 * idf + 0.1))
    return rng, seg, qs, L


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["block", "global", "global_wide"])
@pytest.mark.parametrize("row_layout", ["q16", "q8"])
@pytest.mark.parametrize("default_static,ub,soft", [(True, False, True), (False, False, True),
                                                    (False, False, False), (True, True, True)])
def test_stage_a_merge_kernel_matches_plain(fixture, form, row_layout, default_static, ub, soft):
    """K13 in each form (one block; the global form at the main path's N and
    past it): the network's keys and payloads bit-equal to the plain
    merge's (rows with tf-ordered impact slots included), the candidates of
    the tail at stage A's tolerance, compared as multisets of (doc, score);
    two calls give the same bits."""
    dev = _card()
    rng, seg, qs, L = _merge_case(fixture, form, default_static)
    assert kernels.merge_plan(qs.starts.shape[1] * L).form == form.split("_")[0]
    u, t = ub_inputs(rng, qs) if ub else (None, None)
    seg_c = segment_arrays_from_numpy(row_layout_of(seg, row_layout), device=dev)
    net_k = OT.stage_a_network(seg_c, qs, L, u)
    q_c = OT.to_tensors(qs, dev)
    u_c = None if u is None else torch.as_tensor(u, device=dev)
    keys, contrib, aux, _ = OT._stage_a_entries(seg_c, q_c, L, u_c)
    kp, (cp, ap) = OT.merge_sorted_tiles_plain(keys, contrib, aux)
    assert torch.equal(net_k[0], kp) and torch.equal(net_k[2], ap)
    assert torch.equal(net_k[1].view(torch.int32), cp.view(torch.int32))
    tile = kernels.MERGE_TILE
    if form != "block":  # the third query's runs cross every boundary
        assert all(int(kp[2, r * tile - 1]) >> 6 == int(kp[2, r * tile]) >> 6
                   for r in range(1, kp.shape[1] // tile))
    run = lambda: OT.score_candidates_batch(seg_c, qs, L, 128, default_static, soft, u, t,  # noqa
                                            merge=True)
    n = kernels.LAUNCHES["stage_a_merge"]
    (d_k, s_k), (d_2, s_2) = run(), run()
    assert kernels.LAUNCHES["stage_a_merge"] == n + 2
    assert torch.equal(d_k, d_2) and torch.equal(s_k.view(torch.int32), s_2.view(torch.int32))
    if form == "block":
        t_c = None if t is None else torch.as_tensor(t, device=dev)
        plain, atol = (seg_c, q_c, u_c, t_c), A_ATOL
    else:  # the plain version's sums in f64: its f32 cumsum runs over 65,536+ entries
        plain, atol = _plain_f64(seg_c, qs, dev, u, t), 5e-2
    d_p, s_p = OT.score_candidates_batch_plain(*plain[:2], L, 128, default_static, soft,
                                               *plain[2:], merge=True)
    for b in range(qs.starts.shape[0]):
        assert_topk_runs_match(d_p[b].cpu().numpy(), s_p[b].float().cpu().numpy(),
                               d_k[b].cpu().numpy(), s_k[b].cpu().numpy(), int(seg.num_docs),
                               A_RTOL, atol)


# ---- on the card: K1's table forms and select regimes, K2's clusters -------------------
def _long_fixture(seed=11):
    """Lists of 1,100..1,600 docs of 60,000, so full L = 1,024 slots."""
    return rich_fixture(np.random.default_rng(seed), D=60_000, n_terms=80, L=1024, DB=65536,
                        df=(1100, 1600))


def _form_case(form):
    """(seg, slots, L, stage A's tolerance) whose queries' entries give K1 the
    table form `form` at C = 4,096: "block" 7 slots cut to 80 rows;
    "cluster" 7 full slots of 1,024 rows; "global" 64 of them (E = P*L);
    "mixed" the global batch with all but its third query cut to 7 slots
    (two launches); "huge" 256 such slots, lists drawn with repeats (E =
    262,144: the global table's keys too many for shared memory);
    "clamped" the fixture without its tail padding at L = 512, where a
    slot's window reaches back over other lists' rows (a doc twice in one
    slot)."""
    rng = np.random.default_rng(5)
    if form in ("block", "clamped"):
        seg, starts, dfs, impact, L = rich_fixture(rng)
        qs, _ = query_batch(rng, seg, starts, dfs, impact, B=4)
        if form == "block":
            return seg, qs._replace(lens=np.minimum(qs.lens, 80).astype(np.int32)), L, 2e-3
        return _without_padding(seg, L), qs, 512, 2e-3
    seg, starts, dfs, impact, L = _long_fixture()
    P = {"cluster": 16, "huge": 256}.get(form, 64)
    qs, _ = query_batch(rng, seg, starts, dfs, impact, B=4, P=P)
    if form in ("global", "mixed", "huge"):
        terms = np.stack([rng.permutation(len(dfs))[:P] if P <= len(dfs) else
                          rng.integers(0, len(dfs), P) for _ in range(4)])
        lens = dfs[terms].astype(np.int32)
        if form == "mixed":
            lens[[0, 1, 3], 7:] = 0
        qs = qs._replace(starts=starts[terms].astype(np.int32), lens=lens,
                         group=np.where(np.arange(P) < 2, np.arange(P), OT.OPTIONAL_GROUP)
                         .astype(np.int32)[None].repeat(4, 0))
    return seg, qs, L, 5e-2


def _plain_f64(seg_c, qs, dev, ube, ubt):
    """The segment's arrays and the slots for K1's plain version in f64 (its
    sums then round far below the kernel's f32 ones: over 65,536 and more
    live entries a query its f32 cumsum alone approaches atol)."""
    f64 = torch.float64
    q64 = OT.QuerySlots(*[torch.as_tensor(np.asarray(x), device=dev, dtype=torch.int32
                                          if f in ("starts", "lens", "group", "n_required")
                                          else f64) for f, x in zip(qs._fields, qs)])
    t = lambda x: None if x is None else torch.as_tensor(x, device=dev, dtype=f64)  # noqa: E731
    return seg_c._replace(static_cols=seg_c.static_cols.double()), q64, t(ube), t(ubt)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["block", "cluster", "global", "mixed", "huge", "clamped"])
@pytest.mark.parametrize("row_layout", ["q16", "q8"])
@pytest.mark.parametrize("ub", [False, True])
def test_stage_a_kernel_in_every_table_form(form, row_layout, ub):
    """K1 at C = 4,096 in each table form (forced through the entries; "mixed"
    a batch of both, in two launches), on q16 and q8 rows, with and without
    UB, against its plain version; the select's two regimes: fewer valid
    docs than C (every query of "block" and "clamped": every nonzero key
    wins, no radix pass) and more (queries of "cluster" and "global"). Two
    calls give the same scores and docs, bit for bit (ties at the C-th score
    to the lower doc in both regimes)."""
    dev = _card()
    seg, qs, L, atol = _form_case(form)
    C = 4096
    B = qs.starts.shape[0]
    launches = kernels.stage_a_launches(OT.stage_a_entries(qs.lens, L), C, kernels.card_sms(dev))
    want = {"clamped": ["cluster"], "mixed": ["cluster", "global"], "huge": ["global"]}.get(
        form, [form])
    assert [plan.form for _, plan in launches] == want, launches
    if form == "clamped":
        assert _clamped_windows(seg, qs, L)[1]
    rng = np.random.default_rng(3)
    ube, ubt = ub_inputs(rng, qs) if ub else (None, None)
    seg_c = segment_arrays_from_numpy(row_layout_of(seg, row_layout), device=dev)
    d_k, s_k = OT.score_candidates_batch(seg_c, qs, L, C, True, True, ube, ubt)
    d_2, s_2 = OT.score_candidates_batch(seg_c, qs, L, C, True, True, ube, ubt)
    assert torch.equal(s_k.view(torch.int32), s_2.view(torch.int32)) and torch.equal(d_k, d_2)
    if form in ("block", "clamped"):
        t = lambda x: None if x is None else torch.as_tensor(x, device=dev)  # noqa: E731
        plain = (seg_c, OT.to_tensors(qs, dev), t(ube), t(ubt))
    else:  # the plain version's sums in f64
        plain = _plain_f64(seg_c, qs, dev, ube, ubt)
    d_p, s_p = OT.score_candidates_batch_plain(*plain[:2], L, C, True, True, *plain[2:])
    s_p = s_p.float()
    finite = torch.isfinite(s_k).sum(dim=1)
    assert bool((finite < C).all() if form in ("block", "clamped") else (finite == C).any())
    for b in range(B):
        assert_topk_match(d_p[b].cpu().numpy(), s_p[b].cpu().numpy(), d_k[b].cpu().numpy(),
                          s_k[b].cpu().numpy(), int(seg.num_docs), 1e-5, atol)


@pytest.mark.cuda
@pytest.mark.parametrize("T,P", [(524_288, 256), (1_048_576, 512)])
def test_stage_a_global_form_past_the_shared_keys(T, P):
    """K1's global form at tables past the 262,144 slots whose keys fit a
    block's shared memory (the keys then stay in the global table), in an
    optic's plan: two required terms, scoring slots and an excluded group of
    zero-weight slots, P full slots of 1,024 rows a query (E = P*L), soft
    required as the index calls it. Against the plain version in f64 at C =
    4,096; two calls bit-equal."""
    dev = _card()
    rng = np.random.default_rng(P)
    seg, starts, dfs, impact, L = _long_fixture()
    qs, _ = query_batch(rng, seg, starts, dfs, impact, B=4, P=P)
    terms = rng.integers(0, len(dfs), (4, P))
    slot = np.arange(P)
    group = np.where(slot < 2, slot, np.where(slot < P // 2, OT.OPTIONAL_GROUP,
                                              OT.EXCLUDED_GROUP)).astype(np.int32)
    scoring = (group != OT.EXCLUDED_GROUP)[None]
    zero = lambda w: np.where(scoring, w, 0).astype(np.float32)  # noqa: E731
    qs = qs._replace(starts=starts[terms].astype(np.int32), lens=dfs[terms].astype(np.int32),
                     group=group[None].repeat(4, 0), n_required=np.full(4, 2, np.int32),
                     w_bm25=zero(qs.w_bm25), w_bm25f=zero(qs.w_bm25f),
                     w_presence=zero(qs.w_presence))
    C = 4096
    (rows, plan), = kernels.stage_a_launches(OT.stage_a_entries(qs.lens, L), C,
                                             kernels.card_sms(dev))
    assert rows is None and plan.form == "global" and plan.slots == T, plan
    seg_c = segment_arrays_from_numpy(seg, device=dev)
    n = kernels.LAUNCHES["stage_a"]
    d_k, s_k = OT.score_candidates_batch(seg_c, qs, L, C, True, True)
    d_2, s_2 = OT.score_candidates_batch(seg_c, qs, L, C, True, True)
    assert kernels.LAUNCHES["stage_a"] == n + 2
    assert torch.equal(s_k.view(torch.int32), s_2.view(torch.int32)) and torch.equal(d_k, d_2)
    plain = _plain_f64(seg_c, qs, dev, None, None)
    d_p, s_p = OT.score_candidates_batch_plain(*plain[:2], L, C, True, True, *plain[2:])
    s_p = s_p.float()
    assert bool((torch.isfinite(s_k).sum(dim=1) > 0).all())
    for b in range(4):
        assert_topk_match(d_p[b].cpu().numpy(), s_p[b].cpu().numpy(), d_k[b].cpu().numpy(),
                          s_k[b].cpu().numpy(), int(seg.num_docs), 1e-5, 5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("Kd,k", [(1, 1), (300, 200), (1024, 1024), (2048, 512), (4096, 1024)])
@pytest.mark.parametrize("ks", [0, 64])
@pytest.mark.parametrize("P", [16, 64])
def test_stage_b_kernel_at_every_cluster_size(Kd, k, ks, P):
    """K2 over 1, 2 and 4 blocks a query (stage_b_cluster(Kd)), k < Kd and k
    = Kd, unfused and with 64 fused signal columns, 16 and 64 slots, against
    its plain version (docs as sets above the k-th score, rtol 1e-5 / atol
    1e-5, signals within one q16 step); two calls give the same bits."""
    dev = _card()
    rng = np.random.default_rng(Kd + P)
    seg, starts, dfs, impact, L = _long_fixture()
    qs, aggs = query_batch(rng, seg, starts, dfs, impact, B=4, P=P)
    qs = doc_only(qs)
    cands = driver_candidates(rng, seg, 4, Kd)
    facs = host_factors(seg, qs, cands)
    seg_c = segment_arrays_from_numpy(seg, device=dev)
    ks = min(ks, k)
    n = kernels.LAUNCHES["stage_b"]
    def run():
        if ks:
            return OT.score_driver_batch_with_signals(seg_c, qs, facs, cands, aggs, True, k, ks)
        return OT.score_driver_batch(seg_c, qs, facs, cands, True, k)
    res_k, res_2 = run(), run()
    assert kernels.LAUNCHES["stage_b"] == n + 2
    assert all(torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                           y.view(torch.int32) if y.dtype == torch.float32 else y)
               for x, y in zip(res_k, res_2))
    res_p = OT.score_driver_batch_plain(
        seg_c, OT.to_tensors(qs, dev), torch.as_tensor(facs, device=dev),
        torch.as_tensor(cands, device=dev), True, k, OT.to_tensors(aggs, dev), ks)
    if ks:
        d_k, s_k, sig_k = OT.unpack_stageb(res_k, k, 46, ks)
        d_p, s_p, sig_p = OT.unpack_stageb(res_p, k, 46, ks)
    else:
        (d_k, s_k), (d_p, s_p) = OT.unpack_stageb(res_k, k), OT.unpack_stageb(res_p, k)
    for b in range(4):
        assert_topk_match(d_p[b], s_p[b], d_k[b], s_k[b], int(seg.num_docs), B_RTOL, B_ATOL)
        if ks:
            _assert_sig_match(d_p[b][:ks], sig_p[b], res_p[3][b].cpu().numpy(), d_k[b][:ks],
                              sig_k[b], res_k[3][b].cpu().numpy(), int(seg.num_docs))
