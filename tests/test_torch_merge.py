"""K13, stage A through the P-way bitonic merge of its [P, L] tiles, the
port against the JAX package on the CPU: the network itself
(merge_sorted_tiles_plain against merge_sorted_tiles), stage A under the
merge switch (score_candidates_batch(merge=True) against the JAX package's
score_candidates_batch traced with MERGE_KERNEL set), the search through
InvertedIndex(merge_kernel=True) on a corpus with impact-prefix slots, and
the gate (P a power of two >= 2, L a power of two, else the default stage A).
The JAX package reads MERGE_KERNEL when it traces; the `jax_merge` fixture
sets it, clears JAX's caches so the next call traces anew, and counts the
traced calls of merge_sorted_tiles.

Tolerances, and why:
  - the network: keys and payloads bit-equal (a fixed list of compare-
    exchanges on the same inputs; equal keys never swap);
  - stage-A scores: rtol 1e-5, atol 5e-3 (both take per-run sums as
    differences of one f32 cumsum, in other orders; running sums ~2e4 with
    the soft bonus here); results compared as multisets of (doc, score)
    above the cut, since a doc whose entries the network leaves in several
    runs stands in the top-K once per run, and top-k tie order differs;
  - the search: as tests/test_torch_configs.py (rtol 1e-5, atol 1e-5 on
    stage B's exact scores).
The `cuda`-marked test holding the kernel against the plain version on a card
is in tests/test_torch_scoring.py.
"""

from __future__ import annotations

import gc
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stract_tpu.index import InvertedIndex as JaxIndex
from stract_tpu.index import inverted as inv_jax
from stract_tpu.ops import scoring as OJ
from stract_tpu_torch import bench_corpus as bc_port
from stract_tpu_torch.index import inverted as inv_port
from stract_tpu_torch.index.device import segment_arrays_from_numpy
from stract_tpu_torch.index.inverted import InvertedIndex
from stract_tpu_torch.ops import kernels
from stract_tpu_torch.ops import scoring as OT

from test_torch_index import BENCH_QUERIES, _compare_search, _ctx_pair
from torch_parity import (assert_topk_match, assert_topk_runs_match, query_batch, rich_fixture,
                          row_layout_of, ub_inputs)

A_RTOL, A_ATOL = 1e-5, 5e-3


def jx(tup):
    return type(tup)(*[jnp.asarray(x) for x in tup])


@pytest.fixture
def jax_merge(monkeypatch):
    """The JAX package with MERGE_KERNEL on from its next trace → the list
    of merges its traces entered (one entry per traced merge)."""
    entered = []
    real = OJ.merge_sorted_tiles

    def spy(keys, *payloads):
        entered.append(tuple(keys.shape))
        return real(keys, *payloads)

    monkeypatch.setattr(OJ, "merge_sorted_tiles", spy)
    monkeypatch.setattr(OJ, "MERGE_KERNEL", True)
    jax.clear_caches()
    yield entered
    jax.clear_caches()  # later traces read the restored switch


@pytest.fixture
def fixture():
    rng = np.random.default_rng(13)
    seg, starts, dfs, impact, L = rich_fixture(rng)
    return rng, seg, starts, dfs, impact, L


# ---- the network --------------------------------------------------------------------
def _tiles(rng, P: int, L: int, kind: str):
    """[P, L] keys with duplicates inside and across rows, ascending rows,
    and in `kind` one row reversed or ordered by a payload (as a
    tf-ordered impact slot is), with f32 and i32 payloads."""
    keys = np.sort(rng.integers(0, 4 * L, (P, L)), axis=1).astype(np.int32)
    contrib = rng.random((P, L)).astype(np.float32)
    aux = rng.integers(-2 ** 31, 2 ** 31 - 1, (P, L), dtype=np.int64).astype(np.int32)
    r = P // 2
    if kind == "reversed":
        keys[r] = keys[r][::-1]
    elif kind == "tf_ordered":
        keys[r] = keys[r][np.argsort(-contrib[r], kind="stable")]
    return keys, contrib, aux


@pytest.mark.parametrize("P,L", [(2, 8), (4, 128), (16, 64)])
@pytest.mark.parametrize("kind", ["ascending", "reversed", "tf_ordered"])
def test_merge_twin_matches_jax_network(P, L, kind):
    rng = np.random.default_rng(P * L)
    keys, contrib, aux = _tiles(rng, P, L, kind)
    kj, (cj, aj) = jax.jit(OJ.merge_sorted_tiles)(jnp.asarray(keys), jnp.asarray(contrib),
                                                  jnp.asarray(aux))
    kt, (ct, at) = OT.merge_sorted_tiles_plain(*(torch.from_numpy(x) for x in
                                                 (keys, contrib, aux)))
    assert kt.shape == (P * L,) and kt.dtype == torch.int32
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    np.testing.assert_array_equal(ct.numpy().view(np.uint32), np.asarray(cj).view(np.uint32))
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    is_sorted = bool((np.diff(kt.numpy()) >= 0).all())
    assert is_sorted == (kind == "ascending")  # sorted exactly where every row was
    # the batched form is the per-query network
    kb, (cb,) = OT.merge_sorted_tiles_plain(torch.from_numpy(np.stack([keys, keys[::-1]])),
                                            torch.from_numpy(np.stack([contrib, contrib])))
    assert torch.equal(kb[0], kt) and torch.equal(cb[0], ct)
    k1, (c1,) = OT.merge_sorted_tiles_plain(torch.from_numpy(keys[::-1].copy()),
                                            torch.from_numpy(contrib))
    assert torch.equal(kb[1], k1) and torch.equal(cb[1], c1)


# ---- stage A under the merge ---------------------------------------------------------
@pytest.mark.parametrize("default_static,ub,soft", [(True, False, True), (False, False, True),
                                                    (True, True, True), (True, False, False)])
@pytest.mark.parametrize("row_layout", ["q16", "q8"])
def test_stage_a_merge_plain_matches_jax(fixture, jax_merge, default_static, ub, soft,
                                         row_layout):
    """Both static branches, with UB, and with the n_required mask in place
    of the soft bonus (soft=False)."""
    rng, seg, starts, dfs, impact, L = fixture
    qs, _ = query_batch(rng, seg, starts, dfs, impact, default_static=default_static)
    ubkw_j, ubkw_t = {}, {}
    if ub:
        u, t = ub_inputs(rng, qs)
        ubkw_j = dict(ub_entry=jnp.asarray(u), ub_total=jnp.asarray(t))
        ubkw_t = dict(ub_entry=u, ub_total=t)
    seg_l = row_layout_of(seg, row_layout)
    seg_t = segment_arrays_from_numpy(seg_l, device="cpu")
    K, nd, B = 128, int(seg.num_docs), qs.starts.shape[0]
    d_j, s_j = OJ.score_candidates_batch(jx(seg_l), jx(qs), L, K, default_static,
                                         soft_required=soft, **ubkw_j)
    assert jax_merge == [(16, L)]  # the reference's traced stage A merged [P, L] tiles
    d_t, s_t = OT.score_candidates_batch(seg_t, qs, L, K, default_static, soft, merge=True,
                                         **ubkw_t)
    assert d_t.dtype == torch.int32 and tuple(d_t.shape) == (B, K)
    repeated = 0
    for b in range(B):
        assert_topk_runs_match(np.asarray(d_j[b]), np.asarray(s_j[b]), d_t[b].numpy(),
                               s_t[b].numpy(), nd, A_RTOL, A_ATOL)
        real = d_t[b].numpy()[d_t[b].numpy() < nd]
        repeated += len(real) - len(np.unique(real))
    # the impact slots' tf-ordered rows leave docs in several runs (under the
    # n_required mask a split run rarely holds every required group)
    assert repeated > 0 or not soft
    d_0, _ = OT.score_candidates_batch(seg_t, qs, L, K, default_static, soft, **ubkw_t)
    assert not torch.equal(d_0, d_t)
    # the single-query form
    q1 = OJ.QuerySlots(*[x[0] for x in qs])
    one_j = {k: v[0] for k, v in ubkw_j.items()}
    one_t = {k: v[0] for k, v in ubkw_t.items()}
    d1_j, s1_j = OJ.score_candidates(jx(seg_l), jx(q1), L, K, default_static,
                                     soft_required=soft, **one_j)
    d1_t, s1_t = OT.score_candidates(seg_t, q1, L, K, default_static, soft, merge=True, **one_t)
    assert_topk_runs_match(np.asarray(d1_j), np.asarray(s1_j), d1_t.numpy(), s1_t.numpy(), nd,
                           A_RTOL, A_ATOL)


def test_stage_a_network_is_the_merge_of_the_fetched_tiles(fixture):
    """stage_a_network (what the kernel's tail reads) is the plain fetch of
    the [P, L] tiles through merge_sorted_tiles_plain, and sorted where the
    slots are doc-ascending."""
    rng, seg, starts, dfs, impact, L = fixture
    qs, _ = query_batch(rng, seg, starts, dfs, impact)
    seg_t = segment_arrays_from_numpy(seg, device="cpu")
    qt = OT.to_tensors(qs, "cpu")
    k, c, a = OT.stage_a_network(seg_t, qs, L)
    keys, contrib, aux, _ = OT._stage_a_entries(seg_t, qt, L)
    kr, (cr, ar) = OT.merge_sorted_tiles_plain(keys, contrib, aux)
    assert torch.equal(k, kr) and torch.equal(c, cr) and torch.equal(a, ar)
    assert k.shape == (qs.starts.shape[0], qs.starts.shape[1] * L)
    lens = qs.lens.copy()
    lens[:, 6:] = 0  # no impact slot: every row doc-ascending
    k_sorted, _, _ = OT.stage_a_network(seg_t, qs._replace(lens=lens), L)
    assert bool((k_sorted[:, 1:] >= k_sorted[:, :-1]).all())
    assert not bool((k[:, 1:] >= k[:, :-1]).all())


@pytest.mark.parametrize("P,L", [(12, 256), (16, 200), (1, 256)])
def test_gate_takes_the_default_stage_a(P, L):
    """Outside the gate (P not a power of two >= 2, or L not a power of two)
    merge=True is the default stage A, as the reference's use_merge."""
    assert not OT.merge_applies(P, L)
    rng = np.random.default_rng(3)
    seg, starts, dfs, impact, Lf = rich_fixture(rng, L=L)
    qs, _ = query_batch(rng, seg, starts, dfs, impact, P=max(P, 8))
    if P < 8:
        qs = type(qs)(*[x[:, :P] if x.ndim == 2 and x.shape[1] == 8 else x for x in qs])
    seg_t = segment_arrays_from_numpy(seg, device="cpu")
    for ds in (True, False):
        a = OT.score_candidates_batch(seg_t, qs, L, 64, ds, True, merge=True)
        b = OT.score_candidates_batch(seg_t, qs, L, 64, ds, True)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert OT.merge_applies(2, 1) and OT.merge_applies(64, 1024)
    with pytest.raises(ValueError):
        OT.stage_a_network(seg_t, qs, L)


# ---- the search --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def bench_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch-merge"))
    return bc_port.ensure_corpus(root, 2000, seed=3, log=lambda *a: None)


def test_search_under_merge_matches_jax(bench_dir, jax_merge, monkeypatch):
    """search_initial and search_arrays_batch through
    InvertedIndex(merge_kernel=True) against the JAX index under its merge
    switch, in scan mode, on a corpus whose head terms carry impact-prefix
    slots (posting lists longer than IMPACT_L)."""
    monkeypatch.setattr(inv_jax, "DRIVER_MAX", 16)
    monkeypatch.setattr(inv_port, "DRIVER_MAX", 16)
    jidx = JaxIndex(bench_dir)
    pidx = InvertedIndex(bench_dir, device="cpu", merge_kernel=True)
    assert pidx.merge_kernel
    seg = pidx.segments[0]
    dev = pidx.device_segment_for(seg)
    assert (dev.impact_lens > 0).any()  # impact-prefix slots exist
    seen = []
    real = OT.score_candidates_batch
    monkeypatch.setattr(OT, "score_candidates_batch",
                        lambda *a, **kw: seen.append(kw.get("merge")) or real(*a, **kw))
    found = 0
    for raw, terms, kw in BENCH_QUERIES:
        cj, cp = _ctx_pair(raw, terms, **kw)
        pj, sj = jidx.search_initial(cj, top_k=32)
        pp, sp = pidx.search_initial(cp, top_k=32)
        assert len(pj) == len(pp)
        assert_topk_match(np.array([p.doc for p in pj]), np.array(sj),
                          np.array([p.doc for p in pp]), np.array(sp), -1, 1e-5, 1e-5)
        found += len(pp)
    assert found > 0 and jax_merge and seen and all(seen)
    _, _, _, n = _compare_search(jidx, pidx, BENCH_QUERIES)
    assert n > 0


def test_merge_switch_reaches_the_index(bench_dir):
    """build_searcher(merge_kernel=True) builds its index under the merge;
    the default does not."""
    from stract_tpu_torch.main import build_searcher

    for on in (True, False):
        index = build_searcher(bench_dir, "cpu", merge_kernel=on).searcher.searchers[0].index
        assert index.merge_kernel is on


# ---- the wrapper: arguments, dispatch, live launch arguments ---------------------------
def test_merge_kernel_arguments_are_checked(monkeypatch):
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731

    class Seg:
        postings = i32(64, 3)

    q = lambda P: type("Q", (), {"starts": i32(2, P)})()  # noqa: E731
    net = lambda N: (i32(2, N), torch.zeros((2, N)), i32(2, N), i32(2, N))  # noqa: E731
    with pytest.raises(ValueError):  # P not a power of two
        kernels.stage_a_merge(Seg, q(12), 64, 16, True, True, 1.0, *net(768), None, None)
    with pytest.raises(ValueError):  # L not a power of two
        kernels.stage_a_merge(Seg, q(16), 100, 16, True, True, 1.0, *net(1600), None, None)
    with pytest.raises(ValueError):  # more candidates than one block sorts
        kernels.stage_a_merge(Seg, q(16), 1024, 8192, True, True, 1.0, *net(16384), None, None)
    with pytest.raises(ValueError):  # UB takes both arrays
        kernels.stage_a_merge(Seg, q(16), 64, 16, True, True, 1.0, *net(1024), None, None,
                              ub_entry=torch.zeros((2, 16)))
    mkey, mcon, _, skey = net(1024)
    with pytest.raises(ValueError):  # the default static score reads the aux words
        kernels.stage_a_merge(Seg, q(16), 64, 16, True, True, 1.0, mkey, mcon, None, skey,
                              None, None)
    assert "stage_a_merge" in kernels.LAUNCHES


def test_merge_dispatches_on_cuda_tensors_with_live_arguments(fixture, monkeypatch):
    """A CUDA segment under merge=True reaches stage_a_merge (the gate
    closed: stage_a), never a plain version, and every tensor handed to the
    launch is alive. Stand-in launches, so it runs without a card."""
    rng, seg, starts, dfs, impact, L = fixture
    qs, _ = query_batch(rng, seg, starts, dfs, impact)
    ub, total = ub_inputs(rng, qs)
    seg_t = segment_arrays_from_numpy(seg, device="cpu")
    seen = []

    def live(*ts):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            alive = {o.data_ptr() for o in gc.get_objects() if isinstance(o, torch.Tensor)}
        return all(t.data_ptr() in alive for t in ts if t is not None)

    monkeypatch.setattr(kernels, "stage_a_merge", lambda seg, q, L, K, ds, soft, fs, *ts, **kw:
                        seen.append(("merge", K, live(*ts, *kw.values(), *q))))
    monkeypatch.setattr(kernels, "stage_a", lambda *a: seen.append(("stage_a", None, True)))
    monkeypatch.setattr(OT, "score_candidates_batch_plain",
                        lambda *a, **k: seen.append(("plain", None, False)))
    monkeypatch.setattr(OT, "merge_sorted_tiles_plain",
                        lambda *a, **k: seen.append(("plain", None, False)))
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    OT.score_candidates_batch(seg_t, qs, L, 128, True, True, merge=True)
    OT.score_candidates_batch(seg_t, qs, L, 128, False, True, ub, total, merge=True)
    OT.stage_a_network(seg_t, qs, L)
    OT.score_candidates_batch(seg_t, qs, 200, 128, True, True, merge=True)  # L off the gate
    assert seen == [("merge", 128, True), ("merge", 128, True), ("merge", 0, True),
                    ("stage_a", None, True)], seen
