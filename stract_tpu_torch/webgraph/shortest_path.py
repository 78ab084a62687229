"""Shortest paths on the webgraph — the port of
stract_tpu/webgraph/shortest_path.py (role of reference
webgraph/shortest_path.rs BFS and the AMPC shortest-path job).

Edge-parallel Bellman-Ford relaxation, dist[to] = min(dist[to], dist[from] +
1), repeated to a fixpoint, from one source or from S at once (approximated
harmonic centrality samples its sources, entrypoint/centrality.rs:73). On a
card each round is one launch of K7 (csrc/graph.cu) over the reverse CSR with
the distances held node-major [N, S], so an in-neighbour's S distances are one
coalesced read; the kernel sets a flag when a distance changed. The public
functions keep the JAX package's [S, N] layout (the transposes are part of
their time). On the CPU each round is `relax_plain`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import kernels
from .csr import LONG_ROW, graph_in_csr, in_csr
from .store import Webgraph

UNREACHABLE = np.int32(2**30)
# the plain relaxation gathers at most this many bytes of distances at a time
PLAIN_CHUNK_BYTES = 2 ** 31


def forward_edges(graph: Webgraph) -> tuple:
    """(edge_from, edge_to) i32[E] from the forward CSR, as the reference
    builds them."""
    n = graph.num_nodes
    out_off = np.asarray(graph.out_offsets, dtype=np.int64)
    ef = np.repeat(np.arange(n, dtype=np.int32), np.diff(out_off))
    return ef, np.asarray(graph.out_targets, dtype=np.int32)


def relax_plain(dist, edge_from, edge_to):
    """One round for S sources, plainly: dist i32[S, N] → new i32[S, N], each
    chunk of edges gathered from the round-start distances and min-reduced
    into a copy."""
    S = dist.shape[0]
    ef = torch.as_tensor(edge_from, device=dist.device).long()
    et = torch.as_tensor(edge_to, device=dist.device).long()
    new = dist.clone()
    chunk = max(1, PLAIN_CHUNK_BYTES // (4 * max(S, 1)))
    for s in range(0, ef.numel(), chunk):
        idx = et[s:s + chunk]
        new.scatter_reduce_(1, idx.expand(S, -1), dist[:, ef[s:s + chunk]] + 1, "amin")
    return new


def relax(dist_ns, csr, out=None):
    """K7 over the reverse CSR: dist i32[N, S] (S = 1 or a multiple of 32) →
    (new i32[N, S], i32[1] changed flag). Card tensors only."""
    out = torch.empty_like(dist_ns) if out is None else out
    changed = torch.empty(1, dtype=torch.int32, device=dist_ns.device)
    kernels.bfs_relax(dist_ns, csr.offsets, csr.sources, csr.long_rows, LONG_ROW, out, changed)
    return out, changed


def bfs(n: int, edge_from, edge_to, sources, max_rounds: int = 128, device="cuda",
        csr=None, timings: dict | None = None) -> np.ndarray:
    """Multi-source BFS distances i32[S, N] (UNREACHABLE where no path), by
    relaxation rounds until nothing changes or max_rounds. On a card the
    distances are held [N, S'] with S' = S padded to 1 or a multiple of 32
    (the padding columns stay UNREACHABLE). `timings`, when given, receives
    the seconds of the rounds ("rounds", the copy back included) and the
    count of rounds that changed a distance ("n_rounds")."""
    dev = resolve_device(device)
    src = np.asarray(sources, dtype=np.int64)
    S = len(src)
    rounds = 0
    if dev.type != "cuda":
        t0 = time.perf_counter()
        dist = torch.full((S, n), int(UNREACHABLE), dtype=torch.int32)
        dist[torch.arange(S), torch.from_numpy(src)] = 0
        ef, et = torch.from_numpy(np.asarray(edge_from)), torch.from_numpy(np.asarray(edge_to))
        for _ in range(max_rounds):
            new = relax_plain(dist, ef, et)
            if torch.equal(new, dist):
                break
            dist, rounds = new, rounds + 1
        out = dist.numpy()
    else:
        csr = csr if csr is not None else in_csr(n, edge_from, edge_to, dev)
        t0 = time.perf_counter()
        Sp = 1 if S == 1 else -(-S // 32) * 32
        dist = torch.full((n, Sp), int(UNREACHABLE), dtype=torch.int32, device=dev)
        dist[torch.from_numpy(src).to(dev), torch.arange(S, device=dev)] = 0
        spare = torch.empty_like(dist)
        for _ in range(max_rounds):
            new, changed = relax(dist, csr, out=spare)
            if not int(changed.item()):
                break
            dist, spare, rounds = new, dist, rounds + 1
        out = dist[:, :S].t().contiguous().cpu().numpy()
    if timings is not None:
        timings.update(rounds=time.perf_counter() - t0, n_rounds=rounds)
    return out


def graph_bfs(graph: Webgraph, sources, max_rounds: int = 128, device="cuda",
              timings: dict | None = None) -> np.ndarray:
    """bfs over the graph's edges: on a card the store's reverse CSR, on the
    CPU the forward edges."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return bfs(graph.num_nodes, None, None, sources, max_rounds, dev,
                   csr=graph_in_csr(graph, dev), timings=timings)
    return bfs(graph.num_nodes, *forward_edges(graph), sources, max_rounds, dev, timings=timings)


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
