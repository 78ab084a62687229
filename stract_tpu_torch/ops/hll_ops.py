"""HyperBall's HyperLogLog register programs — the port of
stract_tpu/ops/hll_ops.py: `init_registers` (numpy, copied), the register
merge of one round (K6a) and the size estimate (K6b).

All the graph's sketches are one uint8[N, m] register matrix on the device.
A round sets every target's row to the bytewise max of its own row and its
in-neighbours' round-start rows. The JAX package gathers regs[edge_from] and
scatter-maxes into regs[edge_to]; on a card the port pulls instead over the
reverse CSR (webgraph/csr.py: the graph store's, or the edges sorted by
target on the card). The kernel (csrc/graph.cu) walks each target's in-edges
with no atomics, writes the new rows into a second buffer (so every read sees
the round start, as the reference's gather-then-scatter), estimates the new
rows' sizes in its epilogue and sets one flag when any row changed.

A HyperBall run takes the systolic round (Boldi and Vigna, 2013): one change
byte a row, set where the round before changed the row (every byte before
round 1). From round 1 on a row already holds the max of its in-neighbours'
rows of the round before, so only the in-neighbours that changed can add to
it; the round gathers those alone and gives the full merge's bits, change
flag and round count. It is not the full merge from an arbitrary state:
`merge_iteration`, the reference's stateless round, gathers every in-edge.

The sharded HyperBall (webgraph/centrality.py) runs a round as ring steps
over its register shards: `ring_step` (K8) takes the max of a shard's
running rows and the ring buffer's rows over one (shard, ring distance)
bucket of edges, pulled over the bucket's reverse CSR like K6a, and gathers
only the ring buffer's rows whose change byte is set.

`merge_iteration_plain`, `merge_systolic_plain`, `estimate_sizes_plain` and
`ring_step_plain` are the plain PyTorch versions; the public functions take
them for tensors on the CPU and launch the kernels for tensors on a card (or
raise).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..utils.hashing import _MASK64
from ..webgraph.csr import LONG_ROW, InCSR, in_csr
from . import kernels

# the plain merge gathers at most this many bytes of rows at a time
PLAIN_CHUNK_BYTES = 2 ** 31


def init_registers(n: int, precision: int = 6, seed: int = 0) -> np.ndarray:
    """Initial HLL registers: sketch of {node} per node → uint8[N, m].
    Vectorized numpy twin of utils.hyperloglog.HyperLogLog.add_u64."""
    m = 1 << precision
    ids = np.arange(n, dtype=np.uint64) + np.uint64(seed)
    # splitmix64, vectorized
    x = (ids + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(_MASK64)
    z = x
    z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(_MASK64)
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & np.uint64(_MASK64)
    h = (z ^ (z >> np.uint64(31))) & np.uint64(_MASK64)

    idx = (h >> np.uint64(64 - precision)).astype(np.int64)
    rest = (h << np.uint64(precision)) & np.uint64(_MASK64)
    # rank = leading zeros of `rest` + 1 (capped): count via 64-step halving
    rank = np.zeros(n, dtype=np.uint8)
    zero = rest == 0
    lz = np.zeros(n, dtype=np.int64)
    cur = rest.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        mask = cur < (np.uint64(1) << np.uint64(64 - shift))
        lz += np.where(mask, shift, 0)
        cur = np.where(mask, cur << np.uint64(shift), cur)
    rank = np.where(zero, 64 - precision + 1, lz + 1).astype(np.uint8)

    regs = np.zeros((n, m), dtype=np.uint8)
    regs[np.arange(n), idx] = rank
    return regs


def hll_alpha(m: int) -> float:
    """The bias constant of utils.hyperloglog, as the reference's f32."""
    return float(np.float32(
        0.673 if m == 16 else 0.697 if m == 32 else 0.709 if m == 64 else 0.7213 / (1 + 1.079 / m)))


def merge_iteration_plain(regs, edge_from, edge_to):
    """One HyperBall round, plainly: a copy of regs, then per chunk of edges
    the round-start rows regs[edge_from] max-reduced into it at edge_to."""
    ef = torch.as_tensor(edge_from, device=regs.device).long()
    et = torch.as_tensor(edge_to, device=regs.device).long()
    new = regs.clone()
    chunk = max(1, PLAIN_CHUNK_BYTES // max(regs.shape[1], 1))
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="index_reduce")  # "in beta"
        for s in range(0, ef.numel(), chunk):
            new.index_reduce_(0, et[s:s + chunk], regs[ef[s:s + chunk]], "amax")
    return new


def merge_systolic_plain(regs, changed, edge_from, edge_to):
    """One systolic HyperBall round, plainly: only the edges whose source's
    change byte in `changed` u8[N] is set (None: every edge) max-reduced
    into a copy of regs → (new regs, new change bytes u8[N], 1 where the row
    differs from regs)."""
    ef = torch.as_tensor(edge_from, device=regs.device).long()
    et = torch.as_tensor(edge_to, device=regs.device).long()
    if changed is not None:
        keep = changed[ef] != 0
        ef, et = ef[keep], et[keep]
    new = merge_iteration_plain(regs, ef, et)
    return new, (new != regs).any(dim=1).to(torch.uint8)


def exp2_neg(regs):
    """2^-r f32 of uint8 registers, as the kernels build it: the exponent bits
    (127 - r) << 23 for r <= 125, and 0 from r = 126 on, which is what XLA's
    exp2 gives on the CPU (it flushes 2^-126)."""
    r = regs.to(torch.int32)
    return torch.where(r < 126, (127 - r) << 23, 0).view(torch.float32)


def estimate_sizes_plain(regs):
    """The vectorized HLL estimate f32[N], the reference's formula in f32."""
    n, m = regs.shape
    mf = float(m)
    alpha = torch.tensor(hll_alpha(m), dtype=torch.float32, device=regs.device)
    est = alpha * mf * mf / exp2_neg(regs).sum(dim=1)
    zeros = (regs == 0).to(torch.float32).sum(dim=1)
    lc = mf * torch.log(mf / zeros.clamp_min(1.0))
    use_lc = (est <= 2.5 * mf) & (zeros > 0)
    return torch.where(use_lc, lc, est)


def merge_csr(regs, csr: InCSR, out=None, sizes: bool = True, flags=None, flags_out=None):
    """K6a over the reverse CSR, with K6b for the new rows → (new regs, f32[N]
    sizes or None, i32[1] changed flag). `flags` u8[N]: the systolic round,
    which gathers only the in-neighbours whose change byte is set and copies
    a row with none (None: every in-neighbour, the full merge); `flags_out`
    u8[N], when given, receives this round's change bytes. Card tensors
    only."""
    n, m = regs.shape
    out = torch.empty_like(regs) if out is None else out
    sz = torch.empty(n, dtype=torch.float32, device=regs.device) if sizes else None
    changed = torch.empty(1, dtype=torch.int32, device=regs.device)
    kernels.hll_merge(regs, csr.offsets, csr.sources, csr.long_rows, LONG_ROW, hll_alpha(m), out,
                      sz, changed, flags, flags_out)
    return out, sz, changed


def merge_iteration(regs, edge_from, edge_to):
    """One HyperBall round: ball(to) ∪= ball(from) for every edge → new regs
    uint8[N, m]; edges i32[E]. A CPU tensor takes the plain version, a card
    tensor the kernel (the edges sorted by target on the card first)."""
    if not regs.is_cuda:
        return merge_iteration_plain(regs, edge_from, edge_to)
    return merge_csr(regs, in_csr(regs.shape[0], edge_from, edge_to, regs.device),
                     sizes=False)[0]


def estimate_sizes(regs):
    """Vectorized HLL estimate f32[N] (same formula as utils.hyperloglog)."""
    if not regs.is_cuda:
        return estimate_sizes_plain(regs)
    sizes = torch.empty(regs.shape[0], dtype=torch.float32, device=regs.device)
    kernels.hll_estimate(regs, hll_alpha(regs.shape[1]), sizes)
    return sizes


def ring_step_plain(out, buf, csr: InCSR, flags=None):
    """One ring step plainly, as the reference's `out.at[t].max(buf[s])`:
    each edge's ring-buffer row max-reduced into its target's row of `out`
    (in place), only the edges whose source's change byte in `flags` u8[S]
    is set (None: every edge) → out."""
    S = out.shape[0]
    deg = (csr.offsets[1:] - csr.offsets[:-1]).long()
    tgt = torch.repeat_interleave(torch.arange(S, device=out.device), deg)
    src = csr.sources.long()
    if flags is not None:
        keep = flags[src] != 0
        src, tgt = src[keep], tgt[keep]
    chunk = max(1, PLAIN_CHUNK_BYTES // max(out.shape[1], 1))
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="index_reduce")  # "in beta"
        for s in range(0, src.numel(), chunk):
            out.index_reduce_(0, tgt[s:s + chunk], buf[src[s:s + chunk]], "amax")
    return out


def ring_step(out, buf, csr: InCSR, start=None, sizes: bool = False, flags=None,
              flags_out=None):
    """K8, one ring step of one shard: `out` u8[S, m] (updated in place) ∪=
    the rows of the ring buffer `buf` (another tensor, never written) over
    the bucket's reverse CSR, only the rows whose change byte in `flags`
    u8[S] is set (None: every row). At the round's last step `start` is the
    round-start shard: → (changed i32[1], f32[S] sizes of the new rows when
    `sizes`, else None), and `flags_out` u8[S], when given, receives each
    row's change byte; at the other steps → (None, None). A CPU tensor takes
    the plain version, a card tensor the kernel (or raises)."""
    if buf is out:
        raise ValueError("the ring buffer must be another tensor than the rows it updates")
    if flags_out is not None and start is None:
        raise ValueError("the change bytes are written at the round's last step, with start")
    if not out.is_cuda:
        ring_step_plain(out, buf, csr, flags)
        if start is None:
            return None, None
        rows = (out != start).any(dim=1)
        if flags_out is not None:
            flags_out.copy_(rows)
        changed = rows.any().to(torch.int32).reshape(1)
        return changed, estimate_sizes_plain(out) if sizes else None
    S, m = out.shape
    changed = sz = None
    if start is not None:
        changed = torch.empty(1, dtype=torch.int32, device=out.device)
        if sizes:
            sz = torch.empty(S, dtype=torch.float32, device=out.device)
    kernels.hll_ring_step(out, buf, csr.offsets, csr.sources, csr.long_rows, LONG_ROW,
                          hll_alpha(m), start, sz, changed, flags, flags_out)
    return changed, sz
