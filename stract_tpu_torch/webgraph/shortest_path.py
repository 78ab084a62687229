"""Shortest paths on the webgraph — the port of
stract_tpu/webgraph/shortest_path.py (role of reference
webgraph/shortest_path.rs BFS and the AMPC shortest-path job).

The reference relaxes every distance every round, dist[to] = min(dist[to],
dist[from] + 1), to a fixpoint, from one source or from S at once
(approximated harmonic centrality samples its sources,
entrypoint/centrality.rs:73); `relax_plain` is the port's counterpart of
that round. `bfs` starts where the reference does (0 at each source,
UNREACHABLE elsewhere), and from that state every finite distance after r
rounds is the exact level, so the round is a bitset frontier step (MS-BFS):
a node not yet seen for source s whose in-neighbour is in s's frontier
(level r) gets r + 1. The same distances round for round, and a round
changes something exactly when the relaxation would, so the round count is
the reference's too. The state (`BfsState`) is node-major: 32 sources' bits
a word, W = ceil(S / 32) words a node (`seen`, with the bits past S set, and
`frontier`), and the distances i32[N, 32 W]. On a card each round is one
launch of K7 (csrc/graph.cu) over the reverse CSR; on the CPU it is
`frontier_step_plain`. The public functions keep the JAX package's [S, N]
layout (the transpose and the copy back are part of their time).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops import kernels
from .csr import LONG_ROW, InCSR, graph_in_csr, in_csr
from .store import Webgraph

UNREACHABLE = np.int32(2**30)
# the plain versions gather at most this many bytes a chunk of edges
PLAIN_CHUNK_BYTES = 2 ** 31


def forward_edges(graph: Webgraph) -> tuple:
    """(edge_from, edge_to) i32[E] from the forward CSR, as the reference
    builds them."""
    n = graph.num_nodes
    out_off = np.asarray(graph.out_offsets, dtype=np.int64)
    ef = np.repeat(np.arange(n, dtype=np.int32), np.diff(out_off))
    return ef, np.asarray(graph.out_targets, dtype=np.int32)


def relax_plain(dist, edge_from, edge_to):
    """One round of the reference for S sources, plainly: dist i32[S, N] →
    new i32[S, N], each chunk of edges gathered from the round-start
    distances and min-reduced into a copy."""
    S = dist.shape[0]
    ef = torch.as_tensor(edge_from, device=dist.device).long()
    et = torch.as_tensor(edge_to, device=dist.device).long()
    new = dist.clone()
    chunk = max(1, PLAIN_CHUNK_BYTES // (4 * max(S, 1)))
    for s in range(0, ef.numel(), chunk):
        idx = et[s:s + chunk]
        new.scatter_reduce_(1, idx.expand(S, -1), dist[:, ef[s:s + chunk]] + 1, "amin")
    return new


class BfsState(NamedTuple):
    """The BFS after some rounds: seen, frontier i32[N, W] (bit s % 32 of
    word s // 32 for source s; seen's bits past the sources set, so they are
    never reached) and dist i32[N, 32 W] (UNREACHABLE where not seen)."""
    seen: torch.Tensor
    frontier: torch.Tensor
    dist: torch.Tensor


def _to_i32(words: np.ndarray) -> np.ndarray:
    return np.asarray(words, dtype=np.uint32).view(np.int32)


def bfs_start(n: int, sources, device) -> BfsState:
    """The state of round 0 on `device`: each source seen and in the
    frontier in its own column, at distance 0."""
    src = np.asarray(sources, dtype=np.int64)
    S = len(src)
    W = max(1, -(-S // 32))
    seen = torch.zeros((n, W), dtype=torch.int32, device=device)
    tail = S - 32 * (W - 1)  # the sources of the last word, 0..32
    if tail < 32:
        seen[:, W - 1] = int(_to_i32([~((1 << tail) - 1) & 0xFFFFFFFF])[0])
    cols = np.arange(S)
    words, inv = np.unique(src * W + cols // 32, return_inverse=True)
    bits = np.zeros(len(words), dtype=np.uint32)
    np.bitwise_or.at(bits, inv.reshape(-1), (np.uint32(1) << (cols % 32)).astype(np.uint32))
    at = torch.from_numpy(words).to(device)
    frontier = torch.zeros_like(seen)
    frontier.view(-1)[at] = torch.from_numpy(_to_i32(bits)).to(device)
    seen.view(-1)[at] |= frontier.view(-1)[at]
    dist = torch.full((n, 32 * W), int(UNREACHABLE), dtype=torch.int32, device=device)
    dist[torch.from_numpy(src).to(device), torch.arange(S, device=device)] = 0
    return BfsState(seen, frontier, dist)


def unpack_bits(words):
    """i32[N, W] words → i32[N, 32 W] of 0 and 1 (column 32 w + b is bit b
    of word w)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return ((words.unsqueeze(-1) >> shifts) & 1).reshape(words.shape[0], -1)


def pack_bits(bits):
    """[N, 32 W] of 0 and 1 (or bool) → i32[N, W], unpack_bits' inverse."""
    n = bits.shape[0]
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    v = (bits.reshape(n, -1, 32).long() << shifts).sum(-1)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def frontier_step_plain(state: BfsState, edge_from, edge_to, level: int) -> tuple:
    """K7's round `level`, plainly, over the forward edges: the frontier's
    bits unpacked, gathered by edge source and max-reduced into the edge
    targets (a chunk of edges at a time), less what is seen → (the new
    BfsState: seen | next, next, dist with level + 1 at next's bits;
    changed i32[1]). New tensors; the state given is not changed."""
    seen, frontier, dist = state
    ef = torch.as_tensor(edge_from, device=frontier.device).long()
    et = torch.as_tensor(edge_to, device=frontier.device).long()
    bits = unpack_bits(frontier)
    cols = bits.shape[1]
    reached = torch.zeros_like(bits)
    chunk = max(1, PLAIN_CHUNK_BYTES // (4 * cols))
    for s in range(0, ef.numel(), chunk):
        idx = et[s:s + chunk].unsqueeze(1).expand(-1, cols)
        reached.scatter_reduce_(0, idx, bits[ef[s:s + chunk]], "amax")
    fresh = (reached == 1) & (unpack_bits(seen) == 0)
    nxt = pack_bits(fresh)
    changed = fresh.any().to(torch.int32).reshape(1)
    return BfsState(seen | nxt, nxt, dist.masked_fill(fresh, level + 1)), changed


def csr_targets(csr: InCSR):
    """The target of each of the reverse CSR's edges (the edges' order)."""
    n = csr.offsets.numel() - 1
    counts = (csr.offsets[1:] - csr.offsets[:-1]).long()
    return torch.repeat_interleave(torch.arange(n, device=csr.offsets.device), counts)


def frontier_step(state: BfsState, csr: InCSR, level: int, out=None) -> tuple:
    """Round `level` of the BFS over the reverse CSR → (BfsState, changed
    i32[1]). A CPU state takes frontier_step_plain; a card's launches K7,
    which updates seen and dist in place and writes the next frontier into
    `out` (i32[N, W], another tensor than the frontier) or a new tensor."""
    if not state.frontier.is_cuda:
        return frontier_step_plain(state, csr.sources, csr_targets(csr), level)
    nxt = torch.empty_like(state.frontier) if out is None else out
    changed = torch.empty(1, dtype=torch.int32, device=state.frontier.device)
    kernels.bfs_step(state.frontier, state.seen, state.dist, csr.offsets, csr.sources,
                     csr.long_rows, LONG_ROW, level, nxt, changed)
    return BfsState(state.seen, nxt, state.dist), changed


def bfs(n: int, edge_from, edge_to, sources, max_rounds: int = 128, device="cuda",
        csr=None, timings: dict | None = None) -> np.ndarray:
    """Multi-source BFS distances i32[S, N] (UNREACHABLE where no path), a
    frontier step a round over the reverse CSR (built from the edges unless
    given) until nothing changes or max_rounds: K7 on a card, the plain step
    on the CPU. `timings`, when given, receives the seconds of the rounds
    ("rounds": the start state, the steps and the copy back) and the count
    of rounds that changed a distance ("n_rounds")."""
    dev = resolve_device(device)
    src = np.asarray(sources, dtype=np.int64)
    csr = csr if csr is not None else in_csr(n, edge_from, edge_to, dev)
    t0 = time.perf_counter()
    state = bfs_start(n, src, dev)
    spare = torch.empty_like(state.frontier)
    rounds = 0
    for level in range(max_rounds):
        new, changed = frontier_step(state, csr, level, out=spare)
        if not int(changed.item()):
            break
        spare = state.frontier if new.frontier is spare else spare
        state, rounds = new, rounds + 1
    out = state.dist[:, :len(src)].t().contiguous().cpu().numpy()
    if timings is not None:
        timings.update(rounds=time.perf_counter() - t0, n_rounds=rounds)
    return out


def graph_bfs(graph: Webgraph, sources, max_rounds: int = 128, device="cuda",
              timings: dict | None = None) -> np.ndarray:
    """bfs over the store's reverse CSR of the graph."""
    dev = resolve_device(device)
    return bfs(graph.num_nodes, None, None, sources, max_rounds, dev,
               csr=graph_in_csr(graph, dev), timings=timings)


def distances(graph: Webgraph, source, max_rounds: int = 128, device="cuda") -> dict[str, int]:
    """BFS distances from `source` following forward edges."""
    n = graph.num_nodes
    src = source if isinstance(source, int) else graph.rank_of(source)
    if src is None or n == 0:
        return {}
    out = graph_bfs(graph, [src], max_rounds, device)[0]
    names = graph.names()
    return {names[i]: int(out[i]) for i in np.nonzero(out < UNREACHABLE)[0]}


def distances_many(graph: Webgraph, sources: list, max_rounds: int = 128,
                   device="cuda", timings: dict | None = None) -> np.ndarray:
    """Multi-source BFS, one device program per round: dist i32[S, N]."""
    src = [s if isinstance(s, int) else graph.rank_of(s) for s in sources]
    return graph_bfs(graph, src, max_rounds, device, timings)


def approx_harmonic_centrality(graph: Webgraph, num_samples: int = 256, seed: int = 0,
                               device="cuda", timings: dict | None = None) -> dict[str, float]:
    """Sampled-source approximation (role of reference build_approx_harmonic,
    entrypoint/centrality.rs:73): run BFS from `num_samples` random sources and
    scale contributions by N/num_samples. `timings` as for bfs."""
    n = graph.num_nodes
    if n == 0:
        return {}
    rng = np.random.default_rng(seed)
    k = min(num_samples, n)
    sources = rng.choice(n, size=k, replace=False)
    dist = distances_many(graph, [int(s) for s in sources], device=device, timings=timings)
    with np.errstate(divide="ignore"):
        contrib = np.where((dist > 0) & (dist < UNREACHABLE), 1.0 / dist, 0.0)
    acc = contrib.sum(axis=0) * (n / k)
    norm = max(n - 1, 1)
    return dict(zip(graph.names(), (acc / norm).tolist()))
