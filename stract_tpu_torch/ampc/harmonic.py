"""AMPC harmonic centrality, the multi-host HyperBall — the port of
stract_tpu/ampc/harmonic.py (role of reference
entrypoint/ampc/harmonic_centrality/: coordinator.rs + mapper.rs:38-45 stages).

Workers own edge partitions; per round:
  stage 'merge':        read prev registers of the partition's edge sources
                        from the DHT, register-max them into its targets'
                        rows, hll_max-upsert the rows into next. On a card
                        this is one launch of K6a (ops/hll_ops.py merge_csr,
                        csrc/graph.cu) over the worker's local reverse CSR;
                        on the CPU its plain version (PartitionMerge)
  stage 'centralities': each worker estimates |ball| for its OWNED nodes from
                        prev vs next registers (f64 on the host, as the
                        reference), f64_add-upserts Δ/r into the persistent
                        centrality table, and counts changed nodes
Termination: a round with zero changed registers (reference finisher).

The merge is the JAX package's `np.maximum.at(tgt_acc, tgt_idx,
src_regs[src_idx])` into zeroed rows. A worker's edges never change, so it
lays its partition out once: the S unique sources' rows, then T rows for the
unique targets, and the edges (src_idx -> S + tgt_idx) sorted by target on
the worker's device (webgraph/csr.py in_csr). A round uploads the S rows,
zeroes the T rows, merges and reads the T rows back: the reference's bytes,
since a max of uint8 registers is exact in any order. The estimate stays on
the host in f64 (K6b computes in f32), so the centralities are the JAX
package's.

Inside one card the same computation is one job (webgraph/centrality.py);
this module is the DCN-scale version where the graph exceeds one card."""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..device import resolve_device
from ..ops import hll_ops
from ..utils.hyperloglog import estimate_cardinalities
from ..webgraph.csr import in_csr
from .coordinator import Coordinator
from .dht import upsert
from .dht_conn import DhtConn, DhtTable
from .job import Finisher, Job, Mapper, Setup
from .worker import Worker

REGS = "regs"
META = "meta"
CENTRALITY_TABLE = "centrality@global"


def _key(rank: int) -> bytes:
    return struct.pack(">Q", rank)


class EdgeShardJob(Job):
    def __init__(self, shard: int):
        self.shard = shard

    def is_schedulable(self, worker_meta: dict) -> bool:
        return worker_meta.get("shard") == self.shard

    def to_json(self):
        return {"kind": "edge_shard", "shard": self.shard}

    @classmethod
    def from_json(cls, d):
        return cls(d["shard"])


class PartitionMerge:
    """The merge stage's register-max over one edge partition, laid out once
    on `device`: `srcs` and `tgts` the partition's unique sources and
    targets; calling it with the sources' rows u8[S, m] (numpy, in `srcs`
    order) → the targets' rows u8[T, m], each the max of its in-edges'
    source rows (zeros for none)."""

    def __init__(self, edge_from, edge_to, m: int, device):
        ef = np.asarray(edge_from, dtype=np.int64)
        et = np.asarray(edge_to, dtype=np.int64)
        self.m = m
        self.device = torch.device(device)
        self.srcs = np.unique(ef)
        self.tgts = np.unique(et)
        S = len(self.srcs)
        src_idx = np.searchsorted(self.srcs, ef)
        tgt_idx = S + np.searchsorted(self.tgts, et)
        if self.device.type == "cuda":
            self.csr = in_csr(S + len(self.tgts), src_idx, tgt_idx, self.device)
        else:
            self.edges = (torch.from_numpy(src_idx), torch.from_numpy(tgt_idx))

    def __call__(self, src_regs: np.ndarray) -> np.ndarray:
        S, T = len(self.srcs), len(self.tgts)
        rows = torch.zeros((S + T, self.m), dtype=torch.uint8, device=self.device)
        rows[:S] = torch.from_numpy(np.ascontiguousarray(src_regs, dtype=np.uint8))
        if rows.is_cuda:
            out = hll_ops.merge_csr(rows, self.csr, sizes=False)[0]
        else:
            out = hll_ops.merge_iteration_plain(rows, *self.edges)
        return out[S:].cpu().numpy()


class HarmonicWorker(Worker):
    """Owns one edge partition + the nodes where rank % num_shards == shard.
    The merge stage runs on `device` ("cuda": K6a on the card, raising
    without one; "cpu": the plain version)."""

    def __init__(self, shard: int, num_shards: int, edge_from: np.ndarray, edge_to: np.ndarray,
                 num_nodes: int, precision: int = 6, device="cuda"):
        self.shard = shard
        self.num_shards = num_shards
        self.edge_from = np.asarray(edge_from, dtype=np.int64)
        self.edge_to = np.asarray(edge_to, dtype=np.int64)
        self.num_nodes = num_nodes
        self.precision = precision
        self.m = 1 << precision
        self.owned = np.arange(shard, num_nodes, num_shards, dtype=np.int64)
        self.merge = PartitionMerge(self.edge_from, self.edge_to, self.m,
                                    resolve_device(device))
        self.mappers = {"merge": MergeMapper(), "centralities": CentralitiesMapper()}
        self.jobs = {"edge_shard": EdgeShardJob}

    def meta(self) -> dict:
        return {"shard": self.shard, "num_nodes": self.num_nodes}

    def _get_regs(self, table: DhtTable, ranks: np.ndarray) -> np.ndarray:
        vals = table.batch_get([_key(int(r)) for r in ranks])
        out = np.zeros((len(ranks), self.m), dtype=np.uint8)
        for i, v in enumerate(vals):
            if v is not None:
                out[i] = np.frombuffer(v, dtype=np.uint8)
        return out


class MergeMapper(Mapper):
    name = "merge"

    def map(self, job, worker: HarmonicWorker, dht: DhtConn) -> None:
        merge = worker.merge
        if len(merge.tgts) == 0:
            return
        tgt_acc = merge(worker._get_regs(dht.prev(REGS), merge.srcs))
        dht.next(REGS).batch_upsert(
            upsert.HLL_MAX,
            [(_key(int(t)), tgt_acc[i].tobytes()) for i, t in enumerate(merge.tgts)],
        )


class CentralitiesMapper(Mapper):
    name = "centralities"

    def map(self, job, worker: HarmonicWorker, dht: DhtConn) -> None:
        if len(worker.owned) == 0:
            return
        r = dht.round + 1  # ball radius this round
        prev_regs = worker._get_regs(dht.prev(REGS), worker.owned)
        next_regs = worker._get_regs(dht.next(REGS), worker.owned)
        # next table only holds merged contributions; a node's own prev sketch
        # is part of its ball too
        merged = np.maximum(prev_regs, next_regs)
        dht.next(REGS).batch_upsert(
            upsert.HLL_MAX,
            [(_key(int(n)), merged[i].tobytes()) for i, n in enumerate(worker.owned)],
        )
        prev_sizes = estimate_cardinalities(prev_regs)
        next_sizes = estimate_cardinalities(merged)
        delta = (next_sizes - prev_sizes) / r
        changed = int(np.sum(np.any(merged != prev_regs, axis=1)))
        cent = DhtTable(dht.client, CENTRALITY_TABLE)
        cent.batch_upsert(
            upsert.F64_ADD,
            [(_key(int(n)), float(delta[i])) for i, n in enumerate(worker.owned) if delta[i] != 0],
        )
        dht.next(META).batch_upsert(upsert.U64_ADD, [(b"changed", changed)])


class HarmonicSetup(Setup):
    def __init__(self, num_nodes: int, precision: int = 6):
        self.num_nodes = num_nodes
        self.precision = precision

    def init_tables(self, dht: DhtConn) -> None:
        regs = hll_ops.init_registers(self.num_nodes, self.precision)
        dht.prev(REGS).batch_set(
            [(_key(n), regs[n].tobytes()) for n in range(self.num_nodes)]
        )


class HarmonicFinisher(Finisher):
    def __init__(self):
        self.rounds_checked = 0

    def is_finished(self, dht: DhtConn) -> bool:
        if dht.round == 0:
            return False
        changed = dht.prev(META).get(b"changed")
        return changed is not None and changed == 0 or changed is None and dht.round > 0


def run_distributed_harmonic(graph, worker_addrs: list, dht_client, num_shards: int,
                             precision: int = 6, max_rounds: int = 64) -> dict:
    """Orchestrates the full job against running HarmonicWorkers
    (role of entrypoint/ampc/harmonic_centrality/coordinator.rs)."""
    conn = DhtConn(dht_client, [REGS, META])
    setup = HarmonicSetup(graph.num_nodes, precision)
    coordinator = Coordinator(setup, [MergeMapper(), CentralitiesMapper()], worker_addrs)
    jobs = [EdgeShardJob(s) for s in range(num_shards)]
    coordinator.run(jobs, conn, HarmonicFinisher(), max_rounds=max_rounds)

    cent = DhtTable(dht_client, CENTRALITY_TABLE)
    norm = max(graph.num_nodes - 1, 1)
    out = {}
    for k, v in cent.scan():
        rank = struct.unpack(">Q", bytes(k))[0]
        out[graph.name_of(rank)] = v / norm
    for i in range(graph.num_nodes):
        out.setdefault(graph.name_of(i), 0.0)
    return out


def partition_edges(graph, num_shards: int):
    """Split a webgraph's edges into shards by source node."""
    out_off = np.asarray(graph.out_offsets, dtype=np.int64)
    sources = np.repeat(np.arange(graph.num_nodes, dtype=np.int64), np.diff(out_off))
    targets = np.asarray(graph.out_targets, dtype=np.int64)
    parts = []
    for s in range(num_shards):
        mask = sources % num_shards == s
        parts.append((sources[mask], targets[mask]))
    return parts
