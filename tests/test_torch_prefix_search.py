"""K12, pass 2 over the slots' L-row prefixes, as a grid of (candidate tile,
query) blocks that search each slot's prefix in shared memory.

A numpy model of the kernel's search (the live slots taken `group` at a
time, each one's first min(len, L) doc ids staged in a tile padded with
num_docs, the fixed-step bisection of ops/scoring.py _lookup_steps with its
mid clamped, the found row's factor word read once) is held equal to the
JAX package's _gather_packed + _slot_factor_lookup at L = 1, 7 and 1,024, on
q16 and q8 rows, over slots shorter and longer than L, an empty slot and
tf-ordered impact slots. kernels.prefix_plan is held to what a block's
shared memory holds, and the wrapper hands its plan to the C entry point.
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stract_tpu.ops import scoring as OJ
from stract_tpu_torch.index.device import segment_arrays_from_numpy
from stract_tpu_torch.ops import kernels
from stract_tpu_torch.ops import scoring as OT

from torch_parity import query_batch, rich_fixture, row_layout_of


def _row_words(postings: np.ndarray, rows: np.ndarray) -> tuple:
    """(doc ids, packed q16 factor words) of posting rows, q16 or q8."""
    r = postings[rows].astype(np.int64) & 0xFFFFFFFF
    if postings.shape[1] == 3:
        return r[..., 0].astype(np.int32), r[..., 1].astype(np.uint32).astype(np.int32)
    docs = (r[..., 0] >> 7) & 0x1FFFFFF
    f = ((((r[..., 1] >> 24) & 0xFF) * 257) << 16) | (((r[..., 1] >> 16) & 0xFF) * 257)
    return docs.astype(np.int32), f.astype(np.uint32).astype(np.int32)


def prefix_model(postings, starts, lens, cand, L: int, num_docs: int, group: int):
    """signals_prefix_kernel's search → factors i32[B, P, K]: per query its
    live slots (min(len, L) > 0) in order, `group` at a time (0: all, read
    where they lie), each slot's prefix staged in an L-row tile whose rows
    past min(len, L) hold num_docs; `_lookup_steps(L)` bisection steps over
    it, the mid clamped to [0, L - 1]; a row found at pos < min(len, L) gives
    its factor word, read from the clamped row."""
    B, P = starts.shape
    K = cand.shape[1]
    n_rows = postings.shape[0]
    steps = OT._lookup_steps(L)
    out = np.zeros((B, P, K), np.int32)
    for b in range(B):
        live = [p for p in range(P) if min(int(lens[b, p]), L) > 0]
        per = group if group > 0 else max(len(live), 1)
        for g0 in range(0, len(live), per):
            for p in live[g0:g0 + per]:
                vl = min(int(lens[b, p]), L)
                rows = np.clip(int(starts[b, p]) + np.arange(L), 0, n_rows - 1)
                tile = np.full(L, num_docs, np.int64)
                tile[:vl] = _row_words(postings, rows[:vl])[0]
                c = cand[b].astype(np.int64)
                lo, hi = np.zeros(K, np.int64), np.full(K, L, np.int64)
                for _ in range(steps):
                    mid = (lo + hi) // 2
                    right = tile[np.clip(mid, 0, L - 1)] < c
                    lo, hi = np.where(right, mid + 1, lo), np.where(right, hi, mid)
                pos = np.clip(lo, 0, L - 1)
                hit = (pos < vl) & (tile[pos] == c)
                out[b, p] = np.where(hit, _row_words(postings, rows[pos])[1], 0)
    return out


def _jax_lookup(postings, starts, lens, cand, L: int, num_docs: int) -> np.ndarray:
    seg = SimpleNamespace(postings=jnp.asarray(postings), num_docs=jnp.int32(num_docs))
    out = []
    for b in range(starts.shape[0]):
        q = SimpleNamespace(starts=jnp.asarray(starts[b]), lens=jnp.asarray(lens[b]))
        docs_t, facs_t, _, _ = OJ._gather_packed(seg, q, L)
        out.append(np.asarray(OJ._slot_factor_lookup(docs_t, facs_t, jnp.asarray(cand[b]), L)))
    return np.stack(out)


def _slots(rng, seg, starts, dfs, impact, L: int, B=3, P=8, K=96):
    """B queries of P slots: doc-ordered ranges (shorter and longer than a
    short L), every impact (tf-ordered) range in query 0, an empty slot in
    query 1; candidates from the slots' first L rows, from their other rows,
    docs in no slot, and the pad doc num_docs."""
    D = int(seg.num_docs)
    post = np.asarray(seg.postings)
    st = np.zeros((B, P), np.int32)
    ln = np.zeros((B, P), np.int32)
    for b in range(B):
        terms = rng.choice(len(dfs), P, replace=False)
        st[b], ln[b] = starts[terms], dfs[terms]
    for i, (s, n) in enumerate(impact.values()):
        st[0, i], ln[0, i] = s, n
    ln[1, 3] = 0
    cand = np.empty((B, K), np.int32)
    for b in range(B):
        head = np.concatenate([np.arange(s, s + min(n, L)) for s, n in zip(st[b], ln[b]) if n])
        rows = np.concatenate([np.arange(s, s + n) for s, n in zip(st[b], ln[b]) if n])
        m = min(len(head), K // 2)
        picked = [_row_words(post, rng.choice(head, m, replace=False))[0],
                  _row_words(post, rng.choice(rows, K - 8 - m, replace=False))[0]]
        cand[b] = np.concatenate(picked + [rng.integers(0, D, 7), [D]])
    return st, ln, cand


@pytest.mark.parametrize("layout", ["q16", "q8"])
@pytest.mark.parametrize("group", ["plan", 1, 3, 0])
@pytest.mark.parametrize("L", [1, 7, 1024])
def test_k12_model_equals_jax_slot_factor_lookup(L, group, layout):
    """The model's staged search, at prefix_plan's group, at groups of 1 and
    3 live slots and with the rows read where they lie (group 0), equal to
    the JAX package's lookup over its [P, L] tiles, factor word for factor
    word (the impact slots' rows are not doc-ascending: the same fixed-step
    answers, found or not)."""
    rng = np.random.default_rng(L)
    seg, starts, dfs, impact, _ = rich_fixture(rng)
    seg = row_layout_of(seg, layout)
    st, ln, cand = _slots(rng, seg, starts, dfs, impact, L)
    post, nd = np.asarray(seg.postings), int(seg.num_docs)
    assert (ln > L).any() == (L < 1024) and (ln[ln > 0] < L).any() == (L == 1024)
    g = kernels.prefix_plan(st.shape[1], L, cand.shape[1], 46).group if group == "plan" else group
    got = prefix_model(post, st, ln, cand, L, nd, g)
    want = _jax_lookup(post, st, ln, cand, L, nd)
    np.testing.assert_array_equal(got, want)
    assert (got != 0).sum() >= cand.shape[0] * min(L, 10)  # the searches find rows


@pytest.mark.parametrize("P,L,K,want", [
    (16, 1024, 512, (128, 16, True)),   # the smoke's compacted slots: one group
    (64, 1024, 512, (128, 37, True)),   # 64 full slots: two groups
    (64, 128, 512, (128, 64, True)),    # the index's short bucket
    (300, 1024, 512, (27, 47, False)),  # past the coefficients' share
    (8192, 1024, 512, (1, 24, False)),  # past the staged coefficients
    (16, 65536, 512, (128, 0, True)),   # a prefix past the block: read where it lies
    (1, 7, 3, (3, 1, True)),
])
def test_prefix_plan_fits_a_blocks_shared_memory(P, L, K, want):
    """prefix_plan's (candidates a block, slots staged at a time, staged
    coefficients) at the smoke's shape and the ends of what K12 takes; the
    shared memory stract_signals_prefix asks for stays within the block's;
    at the smoke's B = 32, more blocks than queries."""
    plan = kernels.prefix_plan(P, L, K, 46)
    assert tuple(plan) == want
    smem = 4 * (P * plan.cands + 3 * P + plan.group * L) + (
        4 * (3 * 46 + 2) * P + 2 * 46 * P if plan.staged else 0)
    assert smem <= kernels.STAGE_A_DYN_SMEM and P * plan.cands <= kernels.PREFIX_FAC_WORDS
    if (P, L, K) == (16, 1024, 512):
        assert -(-K // plan.cands) * 32 > 32


class _RecordingLib:
    def __init__(self, called):
        self.called = called

    def __getattr__(self, name):
        if not name.startswith("stract_"):
            raise AttributeError(name)
        return lambda *args: self.called.append((name, args)) or 0


def test_prefix_signals_launch_takes_the_plan(monkeypatch):
    """compute_signals_batch on a CUDA segment (stood in) reaches
    stract_signals_prefix once with prefix_plan's candidates, group and
    staging for its P, L, K, counted under signals_prefix."""
    rng = np.random.default_rng(3)
    seg, starts, dfs, impact, L = rich_fixture(rng)
    qs, aggs = query_batch(rng, seg, starts, dfs, impact)
    B, P = qs.starts.shape
    cands = np.asarray(seg.postings)[:B * 64, 0].reshape(B, 64).astype(np.int32)
    seg_t = segment_arrays_from_numpy(seg, device="cpu")
    called = []
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(kernels, "_load", lambda name: _RecordingLib(called))
    monkeypatch.setattr(kernels, "on_card", lambda *t: contextlib.nullcontext(0))
    kernels.reset_launches()
    sig = OT.compute_signals_batch(seg_t, qs, aggs, cands, L)
    ((name, args),) = called
    plan = kernels.prefix_plan(P, L, 64, 46)
    assert name == "stract_signals_prefix" and sig.shape == (B, 46, 64)
    assert args[7:13] == (64, L, OT._lookup_steps(L), plan.cands, plan.group, int(plan.staged))
    assert kernels.LAUNCHES["signals_prefix"] == 1
