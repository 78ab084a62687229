"""Harmonic centrality via HyperBall — the port of
stract_tpu/webgraph/centrality.py (role of reference
webgraph/centrality/harmonic.rs:215-292 in-process HyperBall).

    c(v) = Σ_r (|ball_r(v)| − |ball_{r−1}(v)|) / r
    ball_r(v) = {v} ∪ ⋃_{(w,v)∈E} ball_{r−1}(w)   (nodes that can reach v)

All sketches are one uint8[N, m] register matrix on the device. A round is
the systolic round (ops/hll_ops.py): one change byte a row carries the rows
the round before changed (every byte before round 1), and only those are
gathered; the registers, the change flag and the round count are the full
merge's. On a card a round is one launch of K6a (ops/hll_ops.py,
csrc/graph.cu) over the store's reverse CSR (webgraph/csr.py), which also
estimates the new rows' sizes (K6b), writes the next change bytes and flags
a change; the host reads the flag and the f32 sizes. The per-node Σ/r
accumulation uses Kahan-compensated f64 on the host, as the reference does
(kahan_sum.rs). On the CPU a round is the plain systolic merge and the
plain estimate.

The sharded variant (harmonic_centrality_sharded) partitions the nodes over
the entries of a mesh (parallel/mesh.py; entries may share a card) and runs
each round as the JAX package's ring exchange: n steps per shard, where at
step k shard d takes the max over its edges whose source lives in shard
(d + k) mod n, read from that shard's round-start registers (the "ppermute"
is a reference to the shard, a copy when it lies on another card; it is
never written) and flagged by that shard's change bytes, which travel with
it. On a card a step is one launch of K8 (hll_ring_step) over the (shard,
step) bucket's reverse CSR, built on the host; the last step also flags a
change against the round start, writes the shard's change bytes and
estimates the new rows.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops import hll_ops
from .csr import InCSR, graph_in_csr, in_csr
from .shortest_path import forward_edges
from .store import Webgraph

DEFAULT_PRECISION = 6  # 64 registers, like the reference's HyperLogLog<64>


def harmonic_centrality(graph: Webgraph, precision: int = DEFAULT_PRECISION,
                        max_rounds: int = 64, device="cuda",
                        timings: dict | None = None) -> dict[str, float]:
    """→ {node_name: centrality}, normalized by (N-1) like the reference.
    `timings`, when given, receives the seconds of reading the edges (on a
    card the store's reverse CSR onto it, "edges"), of the registers' set-up
    ("setup"), of the rounds ("rounds") and of building the result
    ("names"), and the round count ("n_rounds")."""
    n = graph.num_nodes
    if n == 0:
        return {}
    dev = resolve_device(device)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        edges, csr = (None, None), graph_in_csr(graph, dev)
    else:
        edges, csr = forward_edges(graph), None
    if timings is not None:
        timings["edges"] = time.perf_counter() - t0
    centrality = _hyperball(n, *edges, precision, max_rounds, dev, timings, csr=csr)
    t0 = time.perf_counter()
    norm = max(n - 1, 1)
    out = dict(zip(graph.names(), (centrality / norm).tolist()))
    if timings is not None:
        timings["names"] = time.perf_counter() - t0
    return out


def _hyperball(n, edge_from, edge_to, precision, max_rounds, device="cuda",
               timings: dict | None = None, csr: InCSR | None = None) -> np.ndarray:
    """Raw HyperBall → unnormalized centrality f64[n], in systolic rounds. On
    a card the rounds walk `csr`, or the edges sorted by target there when it
    is not given."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    regs = torch.from_numpy(hll_ops.init_registers(n, precision)).to(dev)
    flags = torch.ones(n, dtype=torch.uint8, device=dev)  # every row "changed" before round 1
    if dev.type == "cuda":
        csr = csr if csr is not None else in_csr(n, edge_from, edge_to, dev)
        spare, spare_flags = torch.empty_like(regs), torch.empty_like(flags)

        def step(regs, flags):
            new, sizes, changed = hll_ops.merge_csr(regs, csr, out=spare, flags=flags,
                                                    flags_out=spare_flags)
            return (new, sizes, spare_flags) if int(changed.item()) else (None, None, None)
    else:
        ef, et = torch.from_numpy(np.asarray(edge_from)), torch.from_numpy(np.asarray(edge_to))

        def step(regs, flags):
            new, new_flags = hll_ops.merge_systolic_plain(regs, flags, ef, et)
            if not bool(new_flags.any()):
                return None, None, None
            return new, hll_ops.estimate_sizes(new), new_flags

    sizes = hll_ops.estimate_sizes(regs).cpu().numpy().astype(np.float64)
    t1 = time.perf_counter()
    # Kahan-compensated accumulation, vectorized over all nodes per round
    acc = np.zeros(n, dtype=np.float64)
    comp = np.zeros(n, dtype=np.float64)
    rounds = 0
    for r in range(1, max_rounds + 1):
        new_regs, new_sizes, new_flags = step(regs, flags)
        if new_regs is None:
            break
        rounds = r
        spare, regs = regs, new_regs
        spare_flags, flags = flags, new_flags
        new_sizes = new_sizes.cpu().numpy().astype(np.float64)
        delta = (new_sizes - sizes) / r
        y = delta - comp
        t = acc + y
        comp = (t - acc) - y
        acc = t
        sizes = new_sizes
    if timings is not None:
        timings.update(setup=t1 - t0, rounds=time.perf_counter() - t1, n_rounds=rounds)
    return acc


def harmonic_centrality_sharded(graph: Webgraph, mesh, precision: int = DEFAULT_PRECISION,
                                max_rounds: int = 64,
                                timings: dict | None = None) -> dict[str, float]:
    """HyperBall over the shards of `mesh` (one register shard of N/n rows
    per entry, the ring exchange of the JAX package) → {node_name:
    centrality}, normalized by (N-1). `timings` as _hyperball_sharded's."""
    n = graph.num_nodes
    if n == 0:
        return {}
    out_off = np.asarray(graph.out_offsets, dtype=np.int64)
    sources = np.repeat(np.arange(n, dtype=np.int32), np.diff(out_off))
    targets = np.asarray(graph.out_targets, dtype=np.int32)
    acc = _hyperball_sharded(n, sources, targets, mesh, precision, max_rounds, timings)
    norm = max(n - 1, 1)
    return dict(zip(graph.names(), (acc / norm).tolist()))


def ring_buckets(n: int, sources, targets, devices: list) -> list:
    """The edges bucketed as the JAX package buckets them, by (owner of the
    target, ring distance to the owner of the source), each bucket as the
    reverse CSR over local rows on its shard's device → buckets[d][k], the
    edges of shard d whose source lies in shard (d + k) mod n. Shards hold S
    = ceil(N / n) rows; the last is padded, and padding rows have no edges."""
    n_dev = len(devices)
    S = -(-n // n_dev)
    sources = np.asarray(sources, dtype=np.int64)
    targets = np.asarray(targets, dtype=np.int64)
    tgt_owner = targets // S
    key = tgt_owner * n_dev + (sources // S - tgt_owner) % n_dev
    order = np.argsort(key, kind="stable")
    sources, targets, key = sources[order], targets[order], key[order]
    bounds = np.searchsorted(key, np.arange(n_dev * n_dev + 1))
    buckets = []
    for d, dev in enumerate(devices):
        row = []
        for k in range(n_dev):
            lo, hi = bounds[d * n_dev + k], bounds[d * n_dev + k + 1]
            row.append(in_csr(S, sources[lo:hi] % S, targets[lo:hi] - d * S, dev))
        buckets.append(row)
    return buckets


def ring_round(shards: list, buckets: list, sizes: bool = True,
               flags: list | None = None) -> tuple:
    """One HyperBall round over register shards u8[S, m] (one per mesh
    entry, on its device): shard d's new rows are the max of its round-start
    rows and, at step k, the rows of shard (d + k) mod n over buckets[d][k],
    only those whose change byte in flags[(d + k) mod n] u8[S] is set (None:
    every row, the full round) → (new shards, per-shard f32[S] sizes of the
    new rows or None, per-shard i32[1] changed flags, per-shard u8[S] change
    bytes of this round). Every read sees the round start (Jacobi)."""
    n_dev = len(shards)
    new, sz, changed, new_flags = [], [], [], []
    for d, start in enumerate(shards):
        out = start.clone()
        rows = torch.empty(start.shape[0], dtype=torch.uint8, device=start.device)
        for k in range(n_dev):
            src = (d + k) % n_dev
            buf = shards[src].to(start.device)
            fl = None if flags is None else flags[src].to(start.device)
            last = k == n_dev - 1
            c, s = hll_ops.ring_step(out, buf, buckets[d][k], start=start if last else None,
                                     sizes=sizes and last, flags=fl,
                                     flags_out=rows if last else None)
        new.append(out)
        sz.append(s)
        changed.append(c)
        new_flags.append(rows)
    return new, sz, changed, new_flags


def _hyperball_sharded(n, sources, targets, mesh, precision=DEFAULT_PRECISION, max_rounds=64,
                       timings: dict | None = None) -> np.ndarray:
    """Raw ring-exchange HyperBall over the entries of `mesh`, in systolic
    rounds (each shard's change bytes travel with it, every byte set before
    round 1) → unnormalized centrality f64[n]. `timings`, when given, receives the seconds of
    bucketing the edges on the host and copying the buckets' CSRs to the
    devices ("bucket"), of the registers' set-up ("setup"), of the first
    size estimate ("estimate"; the rounds' estimates are in the last ring
    step's epilogue), of the rounds ("rounds", and each round's in
    "round_s"), and the round count ("n_rounds")."""
    devices = [resolve_device(d) for d in mesh.devices.flat]
    n_dev = len(devices)
    S = -(-n // n_dev)
    t0 = time.perf_counter()
    buckets = ring_buckets(n, sources, targets, devices)
    t1 = time.perf_counter()
    regs0 = np.zeros((S * n_dev, 1 << precision), dtype=np.uint8)
    regs0[:n] = hll_ops.init_registers(n, precision)
    shards = [torch.from_numpy(regs0[d * S:(d + 1) * S]).to(dev)
              for d, dev in enumerate(devices)]
    t2 = time.perf_counter()
    # the estimate over the padded registers, then cut to the real nodes
    sizes = torch.cat([hll_ops.estimate_sizes(s).cpu() for s in shards])[:n].numpy()
    sizes = sizes.astype(np.float64)
    t3 = time.perf_counter()
    flags = [torch.ones(S, dtype=torch.uint8, device=dev) for dev in devices]
    acc = np.zeros(n, dtype=np.float64)
    comp = np.zeros(n, dtype=np.float64)
    rounds = 0
    round_s = []
    for r in range(1, max_rounds + 1):
        tr = time.perf_counter()
        new, new_sizes, changed, new_flags = ring_round(shards, buckets, flags=flags)
        # the change flag reduced over every shard
        if not any(int(c.item()) for c in changed):
            break
        rounds = r
        shards, flags = new, new_flags
        new_sizes = torch.cat([s.cpu() for s in new_sizes])[:n].numpy().astype(np.float64)
        delta = (new_sizes - sizes) / r
        y = delta - comp
        t = acc + y
        comp = (t - acc) - y
        acc = t
        sizes = new_sizes
        round_s.append(time.perf_counter() - tr)
    if timings is not None:
        timings.update(bucket=t1 - t0, setup=t2 - t1, estimate=t3 - t2,
                       rounds=time.perf_counter() - t3, n_rounds=rounds, round_s=round_s)
    return acc


def exact_harmonic_centrality(graph: Webgraph) -> dict[str, float]:
    """Exact O(N·E) BFS oracle for tests (role of the reference's exact tests,
    webgraph/centrality/harmonic.rs tests)."""
    n = graph.num_nodes
    out_off = np.asarray(graph.out_offsets, dtype=np.int64)
    tgt = np.asarray(graph.out_targets, dtype=np.int64)
    adj = [tgt[out_off[i] : out_off[i + 1]] for i in range(n)]
    out = np.zeros(n)
    for src in range(n):
        # BFS forward from src; contributes 1/d to each reached node
        dist = -np.ones(n, dtype=np.int64)
        dist[src] = 0
        frontier = [src]
        d = 0
        while frontier:
            d += 1
            nxt = []
            for u in frontier:
                for v in adj[u]:
                    if dist[v] < 0:
                        dist[v] = d
                        nxt.append(int(v))
                        out[v] += 1.0 / d
            frontier = nxt
    norm = max(n - 1, 1)
    return {graph.name_of(i): out[i] / norm for i in range(n)}


def centrality_ranks(centrality: dict[str, float]) -> dict[str, int]:
    """Dense ranks, best = 0 (feeds the HostCentralityRank column)."""
    ordered = sorted(centrality.items(), key=lambda kv: -kv[1])
    ranks = {}
    prev_val, prev_rank = None, -1
    for i, (name, val) in enumerate(ordered):
        if val != prev_val:
            prev_rank = i
            prev_val = val
        ranks[name] = prev_rank
    return ranks


def store_harmonic(centrality: dict[str, float], path: str) -> None:
    """Persist centrality + ranks as a speedy-kv style store (role of
    centrality/mod.rs:206 store_harmonic)."""
    from ..kv import Db

    db = Db.open(path)
    ranks = centrality_ranks(centrality)
    for name, val in centrality.items():
        db.insert(name.encode(), {"centrality": val, "rank": ranks[name]})
    db.commit()
