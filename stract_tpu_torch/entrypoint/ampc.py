"""AMPC process roles — the port of stract_tpu/entrypoint/ampc.py (role of
reference main.rs:49-123 `ampc {dht |
harmonic-worker | harmonic-coordinator | approx-harmonic-coordinator |
shortest-path-worker | shortest-path-coordinator}` — the distributed
bulk-synchronous graph-compute deployment: a sharded DHT (optionally
raft-replicated), per-shard edge workers, and round-driving coordinators).

Discovery is gossip-based like every other role here: workers and DHT shards
join the cluster as `ampc-worker` / `ampc-dht` services and coordinators
resolve their addresses from membership (the reference does the same with
chitchat, e.g. approximated_harmonic_centrality/coordinator.rs:42-60).

A harmonic worker merges on `device` (K6a on a card, ampc/harmonic.py);
"cuda" without a card raises. Every other role is host work. As in the JAX
package, a DHT shard started with `peers` serves a RaftNode, which answers
no DhtClient call, and each of its replicas announces itself as a shard of
its own: a coordinator cannot use a raft-replicated DHT (a gap of the
reference, kept for parity)."""

from __future__ import annotations

import time

import numpy as np

from ..ampc.dht import DhtClient, DhtShard
from ..ampc.harmonic import HarmonicWorker, run_distributed_harmonic, partition_edges
from ..ampc.shortest_path import ShortestPathWorker, run_distributed_shortest_path
from ..distributed.cluster import Cluster, Service
from ..distributed.sonic import serve_in_thread
from ..webgraph import Webgraph


def run_dht(host: str = "127.0.0.1", port: int = 0, node_id: int = 0,
            peers: list | None = None, gossip_addr=("127.0.0.1", 0), gossip_seeds=()):
    """One DHT shard. With `peers` — the FULL replica address list of this
    shard group, indexed by node id (entry `node_id` is this node) — the
    shard is raft-replicated (ampc/raft.py); without, it is a single sonic
    service (the reference's documented shard-loss = key-loss limitation,
    dht/mod.rs:24-28)."""
    if peers:
        from ..ampc.raft import RaftNode

        node = RaftNode(node_id)
        server = serve_in_thread(node, host, port)
        node.set_peers({i: tuple(a) for i, a in enumerate(peers) if i != node_id})
        node.start()
        service_obj = node
    else:
        service_obj = DhtShard()
        server = serve_in_thread(service_obj, host, port)
    cluster = Cluster.join(
        Service("ampc-dht", host=server.addr, shard=node_id),
        gossip_addr=gossip_addr, seeds=gossip_seeds,
    )
    return server, cluster, service_obj


def _load_partition(graph_path: str, shard: int, num_shards: int):
    graph = Webgraph(graph_path)
    edge_from, edge_to = partition_edges(graph, num_shards)[shard]
    return graph, edge_from, edge_to


def run_harmonic_worker(graph_path: str, shard: int, num_shards: int,
                        precision: int = 6, host: str = "127.0.0.1", port: int = 0,
                        gossip_addr=("127.0.0.1", 0), gossip_seeds=(), device="cuda"):
    """(role of entrypoint/ampc/harmonic_centrality/worker.rs) The merge
    stage runs on `device`."""
    graph, ef, et = _load_partition(graph_path, shard, num_shards)
    worker = HarmonicWorker(shard, num_shards, ef, et, graph.num_nodes, precision, device)
    server = serve_in_thread(worker, host, port)
    cluster = Cluster.join(
        Service("ampc-worker", host=server.addr, shard=shard),
        gossip_addr=gossip_addr, seeds=gossip_seeds,
    )
    return server, cluster


def run_shortest_path_worker(graph_path: str, shard: int, num_shards: int,
                             host: str = "127.0.0.1", port: int = 0,
                             gossip_addr=("127.0.0.1", 0), gossip_seeds=()):
    graph, ef, et = _load_partition(graph_path, shard, num_shards)
    worker = ShortestPathWorker(shard, num_shards, ef, et, graph.num_nodes)
    server = serve_in_thread(worker, host, port)
    cluster = Cluster.join(
        Service("ampc-worker", host=server.addr, shard=shard),
        gossip_addr=gossip_addr, seeds=gossip_seeds,
    )
    return server, cluster


def _discover(gossip_addr, gossip_seeds, num_shards: int, wait_s: float = 30.0):
    """Spectator-join gossip and wait until every worker shard + at least one
    DHT shard are visible → (worker_addrs ordered by shard, dht_addrs)."""
    cluster = Cluster.join(Service("ampc-coordinator"),
                           gossip_addr=gossip_addr, seeds=gossip_seeds)
    deadline = time.monotonic() + wait_s
    workers: dict[int, tuple] = {}
    dhts: dict[int, tuple] = {}
    while time.monotonic() < deadline:
        for svc in cluster.services("ampc-worker"):
            if svc.host:
                workers[svc.shard] = tuple(svc.host)
        for svc in cluster.services("ampc-dht"):
            if svc.host:
                dhts[svc.shard] = tuple(svc.host)
        if len(workers) >= num_shards and dhts:
            break
        time.sleep(0.5)
    if len(workers) < num_shards or not dhts:
        cluster.shutdown()
        raise RuntimeError(
            f"ampc discovery timed out: {len(workers)}/{num_shards} workers, "
            f"{len(dhts)} dht shards")
    return cluster, [workers[s] for s in sorted(workers)], [dhts[s] for s in sorted(dhts)]


def run_harmonic_coordinator(graph_path: str, output_path: str, num_shards: int,
                             precision: int = 6, gossip_addr=("127.0.0.1", 0),
                             gossip_seeds=(), wait_s: float = 30.0) -> dict:
    """(role of entrypoint/ampc/harmonic_centrality/coordinator.rs)"""
    from ..webgraph.centrality import store_harmonic

    graph = Webgraph(graph_path)
    cluster, worker_addrs, dht_addrs = _discover(gossip_addr, gossip_seeds,
                                                 num_shards, wait_s)
    try:
        cent = run_distributed_harmonic(
            graph, worker_addrs, DhtClient(dht_addrs), num_shards, precision)
        if output_path:
            store_harmonic(cent, output_path)
        return cent
    finally:
        cluster.shutdown()


def run_shortest_path_coordinator(graph_path: str, source: str, output_path: str,
                                  num_shards: int, gossip_addr=("127.0.0.1", 0),
                                  gossip_seeds=(), wait_s: float = 30.0) -> dict:
    """(role of entrypoint/ampc/shortest_path/coordinator.rs)"""
    from ..kv import Db

    graph = Webgraph(graph_path)
    cluster, worker_addrs, dht_addrs = _discover(gossip_addr, gossip_seeds,
                                                 num_shards, wait_s)
    try:
        dist = run_distributed_shortest_path(
            graph, source, worker_addrs, DhtClient(dht_addrs), num_shards)
        if output_path:
            db = Db.open(output_path)
            for name, d in dist.items():
                db.insert(name.encode(), d)
            db.commit()
        return dist
    finally:
        cluster.shutdown()


def run_approx_harmonic_coordinator(graph_path: str, output_path: str, num_shards: int,
                                    num_samples: int = 16, seed: int = 0,
                                    gossip_addr=("127.0.0.1", 0), gossip_seeds=(),
                                    wait_s: float = 30.0) -> dict:
    """Sampled-source approximation over the distributed shortest-path job
    (role of entrypoint/ampc/approximated_harmonic_centrality/coordinator.rs:
    centrality(v) = (N/S) · Σ_samples 1/d(s,v), normalized by N-1). Reuses the
    shortest-path workers — they serve the relax mapper for any source."""
    from ..webgraph.centrality import store_harmonic
    from ..webgraph.shortest_path import UNREACHABLE

    graph = Webgraph(graph_path)
    n = graph.num_nodes
    cluster, worker_addrs, dht_addrs = _discover(gossip_addr, gossip_seeds,
                                                 num_shards, wait_s)
    try:
        rng = np.random.default_rng(seed)
        k = min(num_samples, n) or 1
        sources = rng.choice(n, size=k, replace=False)
        acc = np.zeros(n, dtype=np.float64)
        dht = DhtClient(dht_addrs)
        for s in sources:
            dist = run_distributed_shortest_path(
                graph, int(s), worker_addrs, dht, num_shards)
            for name, d in dist.items():
                if 0 < d < UNREACHABLE:
                    acc[graph.rank_of(name)] += 1.0 / d
        acc *= n / k
        norm = max(n - 1, 1)
        cent = {graph.name_of(i): float(acc[i]) / norm for i in range(n)}
        if output_path:
            store_harmonic(cent, output_path)
        return cent
    finally:
        cluster.shutdown()
