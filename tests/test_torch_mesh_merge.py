"""K9, the mesh's global top-k, as a merge of the shards' sorted lists.

A numpy model of the kernel's two forms (the rank merge where every list of
a query is descending, the select where one is not) is held bit-equal to
the plain twin (ops/scoring.py mesh_topk_plain) and to jax.lax.top_k over
the flattened n*K scores, on seeded lists with ties within and across
shards, -0 beside +0 (+0 ranks above -0, as lax.top_k on the CPU), -inf
tails, an all -inf shard and k < K. The
per-shard call (ops/scoring.py mesh_topk_lists) is held to the stacked
merge on the CPU, its wrapper's checks run before any build, and on a
stand-in card the mesh's merge (parallel/search.py _merge) hands the
shards' own tensors to the kernel's table, with no stack.
"""

from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stract_tpu_torch.ops import kernels
from stract_tpu_torch.ops import scoring as O
from stract_tpu_torch.parallel import search as PS


def _keys(scores: np.ndarray) -> np.ndarray:
    """order_key of csrc/scoring.cu over f32 scores (+0 above -0)."""
    u = scores.astype(np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _value(keys: np.ndarray) -> np.ndarray:
    u = np.where(keys & 0x80000000, keys & 0x7FFFFFFF, ~keys).astype(np.uint32)
    return u.view(np.float32)


def _count(lst: np.ndarray, x: int, hi: int, ties_first: bool) -> int:
    """The kernel's bisection: the leading entries of lst[0, hi) that sort
    before key x (>= x where the list comes first, else > x)."""
    lo = 0
    while lo < hi:
        mid = (lo + hi) >> 1
        if lst[mid] > x or (ties_first and lst[mid] == x):
            lo = mid + 1
        else:
            hi = mid
    return lo


def k9_model(scores: np.ndarray, docs: np.ndarray, k: int) -> tuple:
    """mesh_topk_kernel, query by query → (docs, shards, scores, forms)."""
    B, n, K = scores.shape
    out_d = np.zeros((B, k), np.int32)
    out_h = np.zeros((B, k), np.int32)
    out_s = np.zeros((B, k), np.float32)
    forms = np.zeros(B, np.int32)
    for b in range(B):
        keys = _keys(scores[b])
        if np.all(keys[:, :-1] >= keys[:, 1:]):  # the merge: each entry's rank
            seen = np.zeros(k, bool)
            for i in range(n):
                for p in range(k):
                    r = p
                    for j in range(n):
                        if j == i or r >= k:
                            continue
                        r += _count(keys[j], int(keys[i, p]), k - r, j < i)
                    if r < k:
                        assert not seen[r]
                        seen[r] = True
                        out_d[b, r], out_h[b, r] = docs[b, i, p], i
                        out_s[b, r] = _value(keys[i, p:p + 1])[0]
            assert seen.all()
        else:  # the select: key descending, ties to the lower flat index
            forms[b] = 1
            flat = keys.reshape(-1)
            idx = np.lexsort((np.arange(n * K), ~flat))[:k]
            out_d[b], out_h[b] = docs[b].reshape(-1)[idx], idx // K
            out_s[b] = _value(flat[idx])
    return out_d, out_h, out_s, forms


def _lists(B: int, n: int, K: int, seed: int, unsorted: bool, zero_run=(0.0,)) -> tuple:
    """Seeded per-shard top-K lists, gathered shard-major: each descending on
    a coarse grid (ties within and across shards), -inf tails, the last
    shard of query 0 all -inf; in query 1 a run of zeros where each list
    crosses 0: +0 +0 -0 -0 in the last list, four of zero_run[0] in the
    others (the zeros past a run that ends in -0 made -0, so every list
    descends in the kernel's key, +0 above -0); with `unsorted`, one list of
    query 1 out of order."""
    rng = np.random.default_rng(seed)
    scores = np.sort(rng.integers(-8, 24, (B, n, K)).astype(np.float32) / 4, axis=2)[..., ::-1]
    scores = np.ascontiguousarray(scores)
    for b in range(B):
        for d in range(n):
            if b != 1:
                scores[b, d, rng.integers(K // 3, K + 1):] = -np.inf
            else:  # a run of zeros where the list crosses 0
                q = int(np.argmax(scores[b, d] <= 0))
                run = [0.0, 0.0, -0.0, -0.0] if d == n - 1 else [zero_run[0]] * 4
                scores[b, d, q:q + 4] = np.array(run, np.float32)[:K - q]
                if np.signbit(run[-1]):  # the zeros after a -0 are -0: still descending
                    tail = scores[b, d, q + 4:]
                    tail[tail == 0] = -0.0
    scores[0, -1] = -np.inf
    if unsorted:
        scores[1, n // 2, 0], scores[1, n // 2, K - 1] = -5.0, 9.0
    docs = rng.integers(0, 1_000_000, (B, n, K)).astype(np.int32)
    return scores, docs


CASES = [(1, 64, 64), (1, 64, 17), (4, 128, 128), (4, 128, 33), (8, 64, 64), (8, 256, 100)]


def _model_equals_plain(scores, docs, k):
    got_d, got_h, got_s, forms = k9_model(scores, docs, k)
    want = O.mesh_topk_plain(torch.from_numpy(scores), torch.from_numpy(docs), k)
    np.testing.assert_array_equal(got_d, want[0].numpy())
    np.testing.assert_array_equal(got_h, want[1].numpy())
    np.testing.assert_array_equal(got_s, want[2].numpy())
    return got_d, got_h, got_s, forms


@pytest.mark.parametrize("unsorted", [False, True])
@pytest.mark.parametrize("n,K,k", CASES)
def test_k9_model_equals_plain_and_lax_top_k(n, K, k, unsorted):
    """The model's rank merge (and its select, for a query with a list out
    of order) bit-equal to mesh_topk_plain and to lax.top_k: docs, shards,
    scores (bit for bit, the zeros' signs too), and each query's form."""
    B = 3
    scores, docs = _lists(B, n, K, seed=n * 100 + K + k, unsorted=unsorted)
    got_d, got_h, got_s, forms = _model_equals_plain(scores, docs, k)
    for b in range(B):
        top_s, idx = jax.lax.top_k(jnp.asarray(scores[b].reshape(-1)), k)
        idx = np.asarray(idx)
        np.testing.assert_array_equal(got_s[b].view(np.uint32),
                                      np.asarray(top_s).view(np.uint32))
        np.testing.assert_array_equal(got_d[b], docs[b].reshape(-1)[idx])
        np.testing.assert_array_equal(got_h[b], idx // K)
    assert forms.tolist() == [0, int(unsorted), 0]


@pytest.mark.parametrize("n,K,k", [(2, 64, 64), (4, 128, 50)])
def test_k9_model_takes_minus_zero_before_plus_zero_as_ties(n, K, k):
    """-0 in the earlier lists and +0 in the later ones, where lax.top_k on
    the CPU ranks +0 above -0 (the JAX mesh's merge, stract_tpu/parallel/
    search.py:42, 81): so do the model and the plain twin, bit-equal to it
    and each other; every list stays descending (the merge form)."""
    scores, docs = _lists(3, n, K, seed=7 * n + k, unsorted=False, zero_run=(-0.0,))
    got_d, got_h, got_s, forms = _model_equals_plain(scores, docs, k)
    assert forms.tolist() == [0, 0, 0]
    top_s, idx = jax.lax.top_k(jnp.asarray(scores[1].reshape(-1)), k)
    np.testing.assert_array_equal(got_h[1], np.asarray(idx) // K)
    np.testing.assert_array_equal(got_s[1].view(np.uint32), np.asarray(top_s).view(np.uint32))


@pytest.mark.parametrize("n", [2, 4])
def test_k9_plain_merge_ranks_signed_zeros_as_lax_top_k(n):
    """The per-shard call's CPU path (mesh_topk_lists) and mesh_topk_plain
    against jax.lax.top_k over the gathered scores, as the JAX mesh's merge
    calls it, on lists of -0 and +0 in both orders across shards (-0 first
    in the earlier lists, +0 first in the later): the same shards, docs and
    scores bit for bit, +0 above -0."""
    B, K = 2, 8
    scores = np.zeros((B, n, K), np.float32)
    scores[0, : n // 2] = -0.0
    scores[1, n // 2:] = -0.0
    scores[:, :, 0] = 1.0
    scores[:, :, -2:] = -np.inf
    docs = np.arange(B * n * K, dtype=np.int32).reshape(B, n, K)
    s_lists = [torch.from_numpy(scores[:, i].copy()) for i in range(n)]
    d_lists = [torch.from_numpy(docs[:, i].copy()) for i in range(n)]
    for got in (O.mesh_topk_lists(s_lists, d_lists, K),
                O.mesh_topk_plain(torch.from_numpy(scores), torch.from_numpy(docs), K)):
        for b in range(B):
            top_s, idx = jax.lax.top_k(jnp.asarray(scores[b].reshape(-1)), K)
            idx = np.asarray(idx)
            np.testing.assert_array_equal(got[0][b].numpy(), docs[b].reshape(-1)[idx])
            np.testing.assert_array_equal(got[1][b].numpy(), idx // K)
            np.testing.assert_array_equal(got[2][b].numpy().view(np.uint32),
                                          np.asarray(top_s).view(np.uint32))
            assert not np.signbit(got[2][b].numpy()[n:2 * n - n // 2]).any()


@pytest.mark.parametrize("n", [1, 4, 8])
def test_mesh_topk_lists_on_the_cpu_equals_the_stacked_merge(n):
    """The per-shard call's CPU path (the plain twin over the lists stacked)
    equals mesh_topk over the stacked tensors, at k = K and k < K."""
    scores, docs = (torch.from_numpy(x) for x in _lists(4, n, 128, seed=n, unsorted=False))
    s_lists = [scores[:, i].contiguous() for i in range(n)]
    d_lists = [docs[:, i].contiguous() for i in range(n)]
    for k in (None, 40):
        for a, b in zip(O.mesh_topk_lists(s_lists, d_lists, k), O.mesh_topk(scores, docs, k)):
            assert torch.equal(a, b)


class _FailingLib:
    def __getattr__(self, name):
        return lambda *a: pytest.fail(f"{name} was launched")


def _outs(B: int, k: int) -> tuple:
    return tuple(torch.zeros((B, k), dtype=t) for t in (torch.int32, torch.int32, torch.float32))


@pytest.mark.parametrize("case", ["too_many_lists", "docs_count", "entries", "k_past_K",
                                  "k_past_max", "list_shape", "list_dtype", "forms_shape"])
def test_mesh_topk_lists_checks_its_arguments_before_any_build(monkeypatch, case):
    """Arguments the kernel does not take raise ValueError on a CUDA tensor
    (stood in) before the library is built or loaded: more lists than the
    table names, docs and scores of other counts, more than 8,192 entries a
    query, k past K or past 1,024, a list of another shape or dtype, a forms
    array of another shape."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    monkeypatch.setattr(kernels, "_load", lambda name: _FailingLib())
    monkeypatch.setattr(kernels, "build", lambda *a, **k: pytest.fail("a build was started"))
    f32 = lambda *s: torch.zeros(s, dtype=torch.float32)  # noqa: E731
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    n, B, K, k = 4, 2, 64, 32
    scores, docs, forms = [f32(B, K) for _ in range(n)], [i32(B, K) for _ in range(n)], None
    if case == "too_many_lists":
        n = kernels.MESH_MAX_LISTS + 1
        scores, docs = [f32(B, 8) for _ in range(n)], [i32(B, 8) for _ in range(n)]
        k = 8
    elif case == "docs_count":
        docs = docs[:-1]
    elif case == "entries":
        scores, docs, k = [f32(B, 4096)] * 3, [i32(B, 4096)] * 3, 1024
    elif case == "k_past_K":
        k = K + 1
    elif case == "k_past_max":
        scores, docs, k = [f32(B, 2048)] * 2, [i32(B, 2048)] * 2, 1025
    elif case == "list_shape":
        scores[2] = f32(B, K + 1)
    elif case == "list_dtype":
        docs[1] = f32(B, K)
    else:
        forms = i32(B + 1)
    with pytest.raises(ValueError):
        kernels.mesh_topk_lists(scores, docs, k, *_outs(B, k), forms)


class _RecordingLib:
    def __init__(self, called):
        self.called = called

    def __getattr__(self, name):
        if not name.startswith("stract_"):
            raise AttributeError(name)
        return lambda *args: self.called.append((name, args)) or 0


@pytest.mark.parametrize("form", ["lists", "stacked"])
def test_mesh_topk_table_names_the_lists_where_they_lie(monkeypatch, form):
    """The C entry point gets a table whose entries are the shards' own
    tensors' addresses (qstride K, one entry a list) or the stacked
    tensor's (qstride n*K, one entry), one launch counted under mesh_topk
    and under its form of call."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    called = []
    monkeypatch.setattr(kernels, "_load", lambda name: _RecordingLib(called))
    monkeypatch.setattr(kernels, "on_card", lambda *t: contextlib.nullcontext(0))
    kernels.reset_launches()
    n, B, K, k = 4, 3, 64, 20
    scores, docs = (torch.from_numpy(x) for x in _lists(B, n, K, seed=1, unsorted=False))
    forms = torch.zeros(B, dtype=torch.int32)
    if form == "lists":
        s_l = [scores[:, i].contiguous() for i in range(n)]
        d_l = [docs[:, i].contiguous() for i in range(n)]
        kernels.mesh_topk_lists(s_l, d_l, k, *_outs(B, k), forms)
        want = ([t.data_ptr() for t in s_l], [t.data_ptr() for t in d_l], K, n)
    else:
        kernels.mesh_topk(scores, docs, k, *_outs(B, k), forms)
        want = ([scores.data_ptr()], [docs.data_ptr()], n * K, 1)
    ((name, args),) = called
    table = args[0]._obj
    m = want[3]
    assert name == "stract_mesh_topk" and args[1:5] == (B, n, K, k)
    assert (list(table.scores[:m]), list(table.docs[:m]), table.qstride, table.ntab) == want
    assert args[8] == forms.data_ptr()
    assert kernels.LAUNCHES["mesh_topk"] == 1
    assert kernels.MESH_TOPK_CALLS == {"stacked": int(form == "stacked"),
                                       "lists": int(form == "lists")}


def test_merge_hands_the_shards_tensors_to_the_kernel_without_a_stack(monkeypatch):
    """parallel/search.py _merge on shards of one card (stood in): the
    kernel's per-shard call gets each shard's own scores and docs tensors,
    and nothing is stacked."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    seen = []
    monkeypatch.setattr(kernels, "mesh_topk_lists", lambda s, d, k, *outs: seen.append((s, d, k)))
    monkeypatch.setattr(torch, "stack", lambda *a, **kw: pytest.fail("the lists were stacked"))
    n, B, K = 4, 2, 64
    scores, docs = (torch.from_numpy(x) for x in _lists(B, n, K, seed=2, unsorted=False))
    parts = [(docs[:, i].contiguous(), scores[:, i].contiguous()) for i in range(n)]
    PS._merge(parts, torch.device("cpu"), K)
    ((s, d, k),) = seen
    assert k == K and all(a is p[1] for a, p in zip(s, parts))
    assert all(a is p[0] for a, p in zip(d, parts))
