"""AMPC single-source shortest paths — the port's copy of
stract_tpu/ampc/shortest_path.py, host numpy as there (role of reference
ampc/shortest_path/: `distances` DHT table with U64Min upserts, shortest_path/mod.rs:50-57).

Per round each worker relaxes its edge shard: dist(to) = min(dist(to),
dist(from)+1) via U64_MIN upserts. Terminates when a round changes nothing."""

from __future__ import annotations

import struct

import numpy as np

from .coordinator import Coordinator
from .dht import upsert
from .dht_conn import DhtConn
from .job import Finisher, Mapper, Setup
from .harmonic import EdgeShardJob, _key
from .worker import Worker

DIST = "dist"
SP_META = "sp_meta"


class ShortestPathWorker(Worker):
    def __init__(self, shard: int, num_shards: int, edge_from, edge_to, num_nodes: int):
        self.shard = shard
        self.num_shards = num_shards
        self.edge_from = np.asarray(edge_from, dtype=np.int64)
        self.edge_to = np.asarray(edge_to, dtype=np.int64)
        self.num_nodes = num_nodes
        self.mappers = {"relax": RelaxMapper()}
        self.jobs = {"edge_shard": EdgeShardJob}

    def meta(self):
        return {"shard": self.shard}


class RelaxMapper(Mapper):
    name = "relax"

    def map(self, job, worker: ShortestPathWorker, dht: DhtConn) -> None:
        prev = dht.prev(DIST)
        nxt = dht.next(DIST)
        srcs = np.unique(worker.edge_from)
        vals = prev.batch_get([_key(int(s)) for s in srcs])
        dist = {int(s): v for s, v in zip(srcs, vals) if v is not None}
        # carry forward all known distances
        known = prev.scan()
        nxt.batch_upsert(upsert.U64_MIN, known)
        updates = {}
        changed = 0
        for f, t in zip(worker.edge_from, worker.edge_to):
            d = dist.get(int(f))
            if d is None:
                continue
            cand = d + 1
            cur = updates.get(int(t))
            if cur is None or cand < cur:
                updates[int(t)] = cand
        prev_known = {struct.unpack(">Q", bytes(k))[0]: v for k, v in known}
        pairs = []
        for t, d in updates.items():
            if t not in prev_known or d < prev_known[t]:
                changed += 1
            pairs.append((_key(t), d))
        if pairs:
            nxt.batch_upsert(upsert.U64_MIN, pairs)
        dht.next(SP_META).batch_upsert(upsert.U64_ADD, [(b"changed", changed)])


class ShortestPathSetup(Setup):
    def __init__(self, source: int):
        self.source = source

    def init_tables(self, dht: DhtConn) -> None:
        dht.prev(DIST).batch_set([(_key(self.source), 0)])


class ShortestPathFinisher(Finisher):
    def is_finished(self, dht: DhtConn) -> bool:
        if dht.round == 0:
            return False
        changed = dht.prev(SP_META).get(b"changed")
        return changed == 0


def run_distributed_shortest_path(graph, source, worker_addrs, dht_client, num_shards: int,
                                  max_rounds: int = 128) -> dict:
    src_rank = source if isinstance(source, int) else graph.rank_of(source)
    conn = DhtConn(dht_client, [DIST, SP_META])
    coordinator = Coordinator(ShortestPathSetup(src_rank), [RelaxMapper()], worker_addrs)
    jobs = [EdgeShardJob(s) for s in range(num_shards)]
    coordinator.run(jobs, conn, ShortestPathFinisher(), max_rounds=max_rounds)
    out = {}
    for k, v in conn.prev(DIST).scan():
        rank = struct.unpack(">Q", bytes(k))[0]
        out[graph.name_of(rank)] = v
    # drop the final-generation tables: multi-source callers (approx harmonic
    # coordinator) reuse the DHT and would otherwise leak one table per source
    for name in (DIST, SP_META):
        dht_client.drop_table(f"{name}@{conn.round}")
    return out
