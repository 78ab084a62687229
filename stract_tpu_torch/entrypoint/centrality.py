"""Centrality jobs — the port of stract_tpu/entrypoint/centrality.py (role
of reference entrypoint/centrality.rs:41,73: `centrality harmonic` /
`approx-harmonic` over a webgraph → kv store with values + ranks). Each job
runs on `device` ("cuda" unless the caller asks for the CPU); a kv store
written here opens in the JAX package, and the other way round."""

from __future__ import annotations

import time

from ..device import resolve_device
from ..webgraph import Webgraph
from ..webgraph.centrality import (harmonic_centrality, harmonic_centrality_sharded,
                                   store_harmonic)
from ..webgraph.shortest_path import approx_harmonic_centrality


def _store(c: dict, output_path: str, timings: dict | None) -> None:
    t0 = time.perf_counter()
    store_harmonic(c, output_path)
    if timings is not None:
        timings["kv_write"] = time.perf_counter() - t0


def run_harmonic(graph_path: str, output_path: str, precision: int = 6, device="cuda",
                 timings: dict | None = None, mesh=None) -> dict:
    """HyperBall harmonic centrality of the graph → kv store; over the shards
    of `mesh` (parallel/mesh.py) when it has more than one entry, which then
    sets the devices. `timings`, when given, receives the stages' seconds
    (harmonic_centrality's or harmonic_centrality_sharded's, and
    "kv_write")."""
    graph = Webgraph(graph_path)
    if mesh is not None and mesh.devices.size > 1:
        c = harmonic_centrality_sharded(graph, mesh, precision=precision, timings=timings)
    else:
        c = harmonic_centrality(graph, precision=precision, device=device, timings=timings)
    _store(c, output_path, timings)
    return c


def run_approx_harmonic(graph_path: str, output_path: str, num_samples: int = 256,
                        device="cuda", timings: dict | None = None) -> dict:
    """Sampled-source harmonic centrality (BFS from num_samples sources) →
    kv store; `timings` receives the BFS rounds' seconds and count
    ("rounds", "n_rounds"), the whole BFS with the CSR's copy and the
    sums ("bfs"), and "kv_write"."""
    graph = Webgraph(graph_path)
    t0 = time.perf_counter()
    c = approx_harmonic_centrality(graph, num_samples=num_samples, device=device,
                                   timings=timings)
    if timings is not None:
        timings["bfs"] = time.perf_counter() - t0
    _store(c, output_path, timings)
    return c


def run_harmonic_nearest_seed(page_graph_path: str, original_centrality_path: str,
                              output_path: str, discount_factor: float = 0.85,
                              device="cuda") -> dict:
    """Page-level centrality propagation (role of reference
    entrypoint/centrality.rs:126 harmonic_nearest_seed): a page keeps its
    original harmonic centrality if one was computed; otherwise it inherits
    its first backlink seed's centrality × discount_factor. Host work only;
    `device` is checked like the other jobs' so the command line behaves
    alike."""
    from ..kv import Db

    resolve_device(device)
    graph = Webgraph(page_graph_path)
    original = Db.open(original_centrality_path)
    out = {}
    for rank in range(graph.num_nodes):
        name = graph.name_of(rank)
        own = original.get(name.encode())
        if own is not None:
            out[name] = own["centrality"] if isinstance(own, dict) else float(own)
            continue
        for src_rank, _flags in graph.backlinks(name)[:1]:
            seed = original.get(graph.name_of(src_rank).encode())
            if seed is not None:
                v = seed["centrality"] if isinstance(seed, dict) else float(seed)
                out[name] = v * discount_factor
    store_harmonic(out, output_path)
    return out
