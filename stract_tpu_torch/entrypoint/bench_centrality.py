"""HyperBall harmonic-centrality benchmark on one card — the port of
tools/bench_centrality.py into the package (BASELINE.json config 3:
"HyperBall harmonic centrality iterations on host-level webgraph").

    python -m stract_tpu_torch.entrypoint.bench_centrality \\
        [--nodes 1000000] [--edges 20000000] [--rounds 8] [--graph DIR] [--device cuda] \\
        [--sharded --shards 4]

The graph is the tool's: a power-law host graph (Pareto 1.3 in-degree,
uniform sources, seed 0, self-loops dropped; 1M nodes and 20M edges by
default, a realistic host-level webgraph shard), with node i named
"h{i}.example". It is written to DIR in the webgraph store's layout
(webgraph/store.py write_graph: nodes ranked by prehash, parallel edges
merged), so the centrality job reads it as any graph. The benchmark then
times `--rounds` HyperBall register merges (K6a over the reverse CSR) and
one size estimate (K6b) with CUDA events, and prints one JSON line with the
card's name. It writes nothing else (CENTRALITY.json is the JAX package's
TPU record).

--sharded adds the tool's sharded arm: the ring-exchange HyperBall
(webgraph/centrality.py _hyperball_sharded, K8) over a mesh of --shards
entries on the card, up to --rounds rounds, against the single-device
HyperBall of as many rounds, with the same fields as the tool's (the
per-shard register memory of the ring beside an all-gather design's).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def make_edges(n: int, m: int, seed: int = 0) -> tuple:
    """(sources, targets) int64 of the benchmark graph, self-loops dropped."""
    rng = np.random.default_rng(seed)
    # power-law in-degree: preferential targets
    targets = (rng.pareto(1.3, m) * n / 50).astype(np.int64) % n
    sources = rng.integers(0, n, m)
    keep = sources != targets
    return sources[keep], targets[keep]


def write_bench_graph(path: str, n: int = 1_000_000, m: int = 20_000_000, seed: int = 0):
    """The benchmark graph in the store's layout at `path` (rebuilt unless a
    graph written from the same recipe is there) → Webgraph."""
    from ..webgraph.store import Webgraph, write_graph

    recipe = {"nodes": n, "edges": m, "seed": seed, "pareto": 1.3}
    stamp = os.path.join(path, "bench_recipe.json")
    if os.path.exists(stamp):
        with open(stamp) as fh:
            if json.load(fh) == recipe:
                return Webgraph(path)
    sources, targets = make_edges(n, m, seed)
    g = write_graph(path, [f"h{i}.example" for i in range(n)], sources, targets)
    with open(stamp, "w") as fh:
        json.dump(recipe, fh)
    return g


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=1_000_000)
    ap.add_argument("--edges", type=int, default=20_000_000)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--graph", default=os.path.join("data", "bench_centrality"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sharded", action="store_true",
                    help="also run the ring-exchange HyperBall over a mesh of --shards entries")
    ap.add_argument("--shards", type=int, default=4)
    args = ap.parse_args(argv)

    import torch

    from ..device import resolve_device
    from ..ops import hll_ops
    from ..webgraph.csr import graph_in_csr

    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("the benchmark times the kernels: it needs --device cuda")
    t0 = time.perf_counter()
    g = write_bench_graph(args.graph, args.nodes, args.edges)
    graph_s = time.perf_counter() - t0
    csr = graph_in_csr(g, dev)
    regs = torch.from_numpy(hll_ops.init_registers(g.num_nodes, 6)).to(dev)
    spare = torch.empty_like(regs)
    regs, _, _ = hll_ops.merge_csr(regs, csr, out=spare)  # warm-up (the build included)
    spare = torch.empty_like(regs)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(args.rounds):
        new, _, _ = hll_ops.merge_csr(regs, csr, out=spare)
        regs, spare = new, regs
    b.record()
    torch.cuda.synchronize()
    merge_ms = a.elapsed_time(b) / args.rounds
    a.record()
    hll_ops.estimate_sizes(regs)
    b.record()
    torch.cuda.synchronize()
    out = {"metric": "hyperball_centrality", "nodes": g.num_nodes, "edges": g.num_edges,
           "graph_write_s": graph_s, "merge_round_ms": merge_ms,
           "estimate_ms": a.elapsed_time(b),
           "edge_merges_per_s": g.num_edges / (merge_ms / 1e3),
           "registers": "uint8[N, 64]", "card": torch.cuda.get_device_name(0)}
    if args.sharded:
        out["sharded"] = sharded_arm(g, args.shards, args.rounds, dev)
    print(json.dumps(out))
    return out


def sharded_arm(g, shards: int, rounds: int, dev) -> dict:
    """The ring-exchange HyperBall over a mesh of `shards` entries on `dev`
    against the single-device HyperBall, both up to `rounds` rounds."""
    from ..parallel.mesh import Mesh
    from ..webgraph.centrality import _hyperball, _hyperball_sharded
    from ..webgraph.shortest_path import forward_edges

    n = g.num_nodes
    src, dst = forward_edges(g)
    mesh = Mesh([dev] * shards, axis_names=("x",))
    timings: dict = {}
    t0 = time.perf_counter()
    acc_sh = _hyperball_sharded(n, src, dst, mesh, 6, max_rounds=rounds, timings=timings)
    total = time.perf_counter() - t0
    acc_1 = _hyperball(n, src, dst, 6, rounds, dev)
    parity = bool(np.allclose(acc_sh, acc_1, rtol=1e-6, atol=1e-9))
    S = -(-n // shards)
    rec = {"devices": shards, "platform": dev.type, "parity_vs_single_device": parity,
           "rounds_run": timings["n_rounds"],
           "round_s_median": float(np.median(timings["round_s"])) if timings["round_s"] else None,
           "total_s": total, "bucket_s": timings["bucket"], "estimate_s": timings["estimate"],
           # the ring holds 3 register shards a mesh entry (round start, ring
           # buffer, output); an all-gather design the whole matrix and a shard
           "per_device_reg_mb": 3 * S * 64 / 1e6,
           "allgather_design_reg_mb": (S * shards + S) * 64 / 1e6}
    if not parity:
        rec["max_abs_diff"] = float(np.abs(acc_sh - acc_1).max())
    return rec


if __name__ == "__main__":
    main()
