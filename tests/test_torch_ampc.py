"""The port's AMPC job (stract_tpu_torch/ampc/*, entrypoint/ampc.py) against
the JAX package's, on the CPU.

Tolerance: none where the two compute the same thing. DHT tables after the
same operations, the round-by-round registers of the harmonic job, its
centralities (the coordinator runs a stage's jobs one after another, so
every key's f64 upserts come in one order in both packages), shortest-path
distances and the approx-harmonic centralities are equal exactly. Against
the port's single-device HyperBall (f32 estimates on the device, f64 on the
host here) the centralities agree within 1e-4, the JAX package's own
tolerance (tests/test_ampc.py). The merge stage's plain version is
bit-equal to the reference's np.maximum.at. Every wait on gossip is bounded.
"""

from __future__ import annotations

import importlib
import struct
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import stract_tpu.ampc.dht as JD
import stract_tpu.ampc.dht_conn as JC
import stract_tpu.ampc.harmonic as JH
import stract_tpu.ampc.shortest_path as JS
import stract_tpu.ampc.worker as JW
import stract_tpu_torch.ampc.dht as PD
import stract_tpu_torch.ampc.dht_conn as PC
import stract_tpu_torch.ampc.harmonic as PH
import stract_tpu_torch.ampc.shortest_path as PS
import stract_tpu_torch.ampc.worker as PW
from stract_tpu.webgraph import Webgraph as JaxWebgraph
from stract_tpu_torch.entrypoint.bench_centrality import write_bench_graph
from stract_tpu_torch.webgraph import Webgraph

SHARDS = 3
PKGS = {"jax": (JD, JC, JH, JS, JW, JaxWebgraph, {}),
        "port": (PD, PC, PH, PS, PW, Webgraph, {"device": "cpu"})}


@pytest.fixture(scope="module")
def graph_dir(tmp_path_factory):
    """A seeded Pareto graph of 400 nodes and 4,000 edges (the centrality
    bench's recipe), read by both packages."""
    return write_bench_graph(str(tmp_path_factory.mktemp("ampc") / "g"), 400, 4_000, seed=5).path


@contextmanager
def cluster(pkg: str, graph_path: str, kind: str = "harmonic", shards: int = SHARDS,
            dht_shards: int = 2):
    """A package's in-process deployment: DHT shards and one worker an edge
    partition → (graph, worker addrs, DhtClient, workers)."""
    D, _, H, S, W, G, kw = PKGS[pkg]
    graph = G(graph_path)
    servers, client = D.start_dht(dht_shards)
    workers = []
    for s, (ef, et) in enumerate(H.partition_edges(graph, shards)):
        w = (H.HarmonicWorker(s, shards, ef, et, graph.num_nodes, 6, **kw) if kind == "harmonic"
             else S.ShortestPathWorker(s, shards, ef, et, graph.num_nodes))
        workers.append(W.start_worker(w))
    try:
        yield graph, [w.addr for w in workers], client, workers
    finally:
        for c in client.clients:  # a server's stop waits on open connections
            c.close()
        for s in workers + servers:
            s.stop()


def record_rounds(monkeypatch, conn_mod, rounds: list) -> None:
    """Each round's new registers (the `regs` table of the next generation,
    after both stages) recorded as {rank: bytes} before the swap."""
    orig = conn_mod.DhtConn.next_round

    def next_round(self):
        if "regs" in self.table_names:
            rounds.append({struct.unpack(">Q", bytes(k))[0]: bytes(v)
                           for k, v in self.next("regs").scan()})
        orig(self)

    monkeypatch.setattr(conn_mod.DhtConn, "next_round", next_round)


# ---- the DHT ------------------------------------------------------------------------
PAIRS = {
    "u64_add": lambda rng, n: [int(x) for x in rng.integers(0, 1000, n)],
    "u64_min": lambda rng, n: [int(x) for x in rng.integers(0, 1000, n)],
    "f32_add": lambda rng, n: [float(x) for x in rng.normal(size=n)],
    "f64_add": lambda rng, n: [float(x) for x in rng.normal(size=n) * 1e6],
    "kahan_add": lambda rng, n: [[float(x), float(y)] for x, y in rng.normal(size=(n, 2))],
    "hll_max": lambda rng, n: [rng.integers(0, 20, 64, dtype=np.uint8).tobytes()
                               for _ in range(n)],
}


@pytest.mark.parametrize("fn", list(PAIRS))
def test_dht_shard_upserts_match_jax(fn):
    """Five batches of seeded upserts on 40 keys (repeats within a batch
    included) leave the JAX shard's table in the port's shard; scan,
    clone, drop and num_keys alike."""
    rng = np.random.default_rng(len(fn))
    shards = (JD.DhtShard(), PD.DhtShard())
    for _ in range(5):
        keys = [f"k{int(i)}".encode() for i in rng.integers(0, 40, 30)]
        body = {"table": "t", "fn": fn, "pairs": list(zip(keys, PAIRS[fn](rng, 30)))}
        for s in shards:
            assert s.batch_upsert(body) is True
    a, b = (s.tables["t"] for s in shards)
    assert a == b and len(a) > 20
    for s in shards:
        s.clone_table({"from": "t", "to": "u"})
        s.batch_set({"table": "u", "pairs": [(b"new", 1)]})
    assert shards[0].scan({"table": "u"}) == shards[1].scan({"table": "u"})
    keys = [b"k1", b"new", b"absent"]
    assert shards[0].batch_get({"table": "u", "keys": keys}) == \
        shards[1].batch_get({"table": "u", "keys": keys})
    for s in shards:
        s.drop_table({"table": "t"})
    assert [s.num_keys({"table": "t"}) for s in shards] == [0, 0]
    assert [s.num_keys({"table": "u"}) for s in shards] == [len(a) + 1] * 2


def test_dht_client_routes_as_the_jax_client():
    """The port's client over three JAX shards puts each key on the shard
    the JAX client puts it on (fnv1a64 % n), and reads back what either
    wrote."""
    rng = np.random.default_rng(3)
    pairs = [(rng.integers(0, 256, 8, dtype=np.uint8).tobytes(), int(i)) for i in range(60)]
    placed = []
    for pkg in ("jax", "port"):
        servers, _ = JD.start_dht(3)
        try:
            client = PKGS[pkg][0].DhtClient([s.addr for s in servers])
            client.batch_set("t", pairs)
            client.batch_upsert("t", "u64_add", pairs[:10])
            placed.append([dict(s.server.service.tables["t"]) for s in servers])
            assert client.batch_get("t", [k for k, _ in pairs]) == \
                [2 * v if i < 10 else v for i, (_, v) in enumerate(pairs)]
            assert client.num_keys("t") == 60 and dict(client.scan("t")) == \
                {k: (2 * v if i < 10 else v) for i, (k, v) in enumerate(pairs)}
            for c in client.clients:
                c.close()
        finally:
            for s in servers:
                s.stop()
    assert placed[0] == placed[1] and all(placed[0])


def test_dht_conn_rounds_across_packages():
    """The port's DhtConn over JAX shards: prev / next per round, the old
    generation dropped, seed_next_from_prev, and a wire form a JAX worker
    rebuilds."""
    servers, _ = JD.start_dht(2)
    try:
        conn = PC.DhtConn(PD.DhtClient([s.addr for s in servers]), ["regs"])
        conn.prev("regs").set(b"k", 1)
        conn.next("regs").set(b"k", 2)
        assert conn.prev("regs").get(b"k") == 1
        conn.next_round()
        assert conn.prev("regs").get(b"k") == 2 and conn.client.num_keys("regs@0") == 0
        conn.seed_next_from_prev()
        assert conn.next("regs").get(b"k") == 2
        jconn = JC.DhtConn.from_serializable(conn.serializable())
        assert jconn.round == 1 and jconn.prev("regs").get(b"k") == 2
        back = PC.DhtConn.from_serializable(jconn.serializable())
        assert back.serializable() == conn.serializable()
        for c in conn.client.clients + jconn.client.clients + back.client.clients:
            c.close()
    finally:
        for s in servers:
            s.stop()


# ---- the merge stage ----------------------------------------------------------------
@pytest.mark.parametrize("precision", [1, 6, 12])
def test_partition_merge_plain_is_the_references_maximum_at(precision):
    """PartitionMerge on the CPU (merge_iteration_plain over the local
    layout) gives np.maximum.at into zeroed target rows bit for bit, on
    seeded partitions with duplicate edges and self-loops."""
    m = 1 << precision
    rng = np.random.default_rng(precision)
    for n, e in ((50, 400), (300, 60), (7, 7)):
        ef = rng.integers(0, n, e)
        et = rng.integers(0, n, e)
        ef[:5], et[:5] = et[:5], et[:5]          # self-loops
        ef = np.concatenate([ef, ef[:20]])        # duplicate edges
        et = np.concatenate([et, et[:20]])
        merge = PH.PartitionMerge(ef, et, m, "cpu")
        src_regs = rng.integers(0, 40, (len(merge.srcs), m), dtype=np.uint8)
        want = np.zeros((len(merge.tgts), m), dtype=np.uint8)
        np.maximum.at(want, np.searchsorted(merge.tgts, et),
                      src_regs[np.searchsorted(merge.srcs, ef)])
        got = merge(src_regs)
        assert got.dtype == np.uint8 and np.array_equal(got, want)


def test_partition_merge_on_a_card_launches_k6a_and_raises_on_failure(monkeypatch):
    """A merge whose rows lie on a card goes through K6a (merge_csr) and
    never the plain version; a failed launch raises out of the merge
    (checked with stand-ins, so it runs without a card)."""
    from stract_tpu_torch.ops import hll_ops, kernels
    from stract_tpu_torch.webgraph.csr import in_csr

    called = []
    merge = PH.PartitionMerge(np.array([0, 1, 1]), np.array([2, 2, 0]), 64, "cpu")
    S, T = len(merge.srcs), len(merge.tgts)
    merge.csr = in_csr(S + T, *merge.edges, "cpu")
    monkeypatch.setattr(hll_ops, "merge_iteration_plain", lambda *a: called.append("plain"))

    def failed_launch(*args):
        called.append("hll_merge")
        raise RuntimeError("stract_hll_merge failed: CUDA error 700")

    monkeypatch.setattr(kernels, "hll_merge", failed_launch)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises(RuntimeError, match="stract_hll_merge"):
        merge(np.zeros((S, 64), dtype=np.uint8))
    assert called == ["hll_merge"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_a_failed_merge_is_retried_never_replaced(pkg, graph_dir, monkeypatch):
    """A merge that raises on a live worker (the port: K6a's failure out of
    PartitionMerge) comes back to the coordinator as an ApplicationError;
    the coordinator finds the worker alive and sends the job to the same
    worker again, until it succeeds, in both packages: nothing computes the
    rows elsewhere, and the result is the job's."""
    calls = []
    cls, name = (PH.PartitionMerge, "__call__") if pkg == "port" else (JH.MergeMapper, "map")
    orig = getattr(cls, name)

    def failing(*args):
        calls.append(1)
        if len(calls) <= 3:
            raise RuntimeError("stract_hll_merge failed: CUDA error 700")
        return orig(*args)

    with cluster(pkg, graph_dir, shards=1, dht_shards=1) as (graph, addrs, client, _):
        want = PKGS[pkg][2].run_distributed_harmonic(graph, addrs, client, 1)
    monkeypatch.setattr(cls, name, failing)
    with cluster(pkg, graph_dir, shards=1, dht_shards=1) as (graph, addrs, client, _):
        got = PKGS[pkg][2].run_distributed_harmonic(graph, addrs, client, 1)
    assert got == want and len(calls) > 3


def test_harmonic_worker_on_cuda_without_a_card_raises(graph_dir):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    graph = Webgraph(graph_dir)
    ef, et = PH.partition_edges(graph, 1)[0]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        PH.HarmonicWorker(0, 1, ef, et, graph.num_nodes)


# ---- the jobs -------------------------------------------------------------------------
def test_harmonic_job_matches_jax_round_by_round(graph_dir, monkeypatch):
    """3 workers, 2 DHT shards: the port's registers equal the JAX job's in
    every round, the round counts and the centralities equal, and both are
    within 1e-4 of the port's single-device HyperBall."""
    from stract_tpu_torch.webgraph.centrality import harmonic_centrality

    rounds, cents = {}, {}
    for pkg in ("jax", "port"):
        rounds[pkg] = []
        record_rounds(monkeypatch, PKGS[pkg][1], rounds[pkg])
        with cluster(pkg, graph_dir) as (graph, addrs, client, _):
            cents[pkg] = PKGS[pkg][2].run_distributed_harmonic(graph, addrs, client, SHARDS)
    assert len(rounds["port"]) == len(rounds["jax"]) > 3
    for r, (a, b) in enumerate(zip(rounds["jax"], rounds["port"])):
        assert a == b, f"round {r}"
    assert list(cents["port"].items()) == list(cents["jax"].items())
    single = harmonic_centrality(Webgraph(graph_dir), precision=6, device="cpu")
    assert max(abs(cents["port"][k] - v) for k, v in single.items()) < 1e-4


def test_dead_worker_rescheduled(graph_dir):
    """A worker of shard 0 stopped before the run: its jobs run on the other
    worker of shard 0, and the job gives the JAX job's centralities."""
    graph = Webgraph(graph_dir)
    ef, et = PH.partition_edges(graph, 1)[0]
    w1 = PW.start_worker(PH.HarmonicWorker(0, 1, ef, et, graph.num_nodes, device="cpu"))
    w2 = PW.start_worker(PH.HarmonicWorker(0, 1, ef, et, graph.num_nodes, device="cpu"))
    dead = w1.addr
    w1.stop()
    servers, client = PD.start_dht(1)
    try:
        got = PH.run_distributed_harmonic(graph, [dead, w2.addr], client, 1)
    finally:
        for s in servers + [w2]:
            s.stop()
    with cluster("jax", graph_dir, shards=1, dht_shards=1) as (jg, addrs, jclient, _):
        want = JH.run_distributed_harmonic(jg, addrs, jclient, 1)
    assert got == want


def test_mixed_roles_over_sonic(graph_dir):
    """The port's coordinator against JAX DHT shards and workers, and the
    JAX coordinator against the port's (CPU workers): each gives the JAX
    deployment's centralities, and the JAX shortest paths."""
    with cluster("jax", graph_dir) as (graph, addrs, client, _):
        want = JH.run_distributed_harmonic(graph, addrs, client, SHARDS)
    dists = []
    for coord, workers in (("port", "jax"), ("jax", "port")):
        with cluster(workers, graph_dir) as (_, addrs, client, _w):
            c = PKGS[coord][0].DhtClient([x.addr for x in client.clients])
            assert PKGS[coord][2].run_distributed_harmonic(
                PKGS[coord][5](graph_dir), addrs, c, SHARDS) == want, coord
            for x in c.clients:
                x.close()
        with cluster(workers, graph_dir, kind="sp") as (_, addrs, client, _w):
            c = PKGS[coord][0].DhtClient([x.addr for x in client.clients])
            dists.append(PKGS[coord][3].run_distributed_shortest_path(
                PKGS[coord][5](graph_dir), 7, addrs, c, SHARDS))
            for x in c.clients:
                x.close()
    assert dists[0] == dists[1] and len(dists[0]) > 1


def test_shortest_path_matches_jax_and_the_bfs(graph_dir):
    """Distances from three sources equal the JAX job's and the port's
    single-device BFS (its reached nodes)."""
    from stract_tpu_torch.webgraph.shortest_path import UNREACHABLE, distances

    graph = Webgraph(graph_dir)
    got = {}
    for pkg in ("jax", "port"):
        with cluster(pkg, graph_dir, kind="sp") as (g, addrs, client, _):
            got[pkg] = [PKGS[pkg][3].run_distributed_shortest_path(g, src, addrs, client, SHARDS)
                        for src in (0, 17, graph.name_of(123))]
            assert client.num_keys("dist@0") == 0  # each source's tables dropped
    assert got["port"] == got["jax"]
    for src, d in zip((0, 17, 123), got["port"]):
        bfs = {k: v for k, v in distances(graph, src, device="cpu").items() if v < UNREACHABLE}
        assert d == bfs and len(d) > 1


def test_gossip_roles_approx_harmonic_and_shortest_path(graph_dir, tmp_path):
    """entrypoint/ampc.py of each package over gossip: one DHT shard, 3
    shortest-path workers, then the approx-harmonic coordinator (4 samples)
    and the shortest-path coordinator: the two packages' results and kv
    stores equal."""
    from stract_tpu_torch.kv import Db

    out = {}
    for pkg in ("jax", "port"):
        ep = importlib.import_module(f"{'stract_tpu' if pkg == 'jax' else 'stract_tpu_torch'}"
                                     ".entrypoint.ampc")
        cl = importlib.import_module(f"{'stract_tpu' if pkg == 'jax' else 'stract_tpu_torch'}"
                                     ".distributed.cluster")
        seed = cl.Cluster.join(cl.Service("admin"), interval=0.1, failure_timeout=5.0)
        seeds = [seed.gossip_addr]
        dht_srv, dht_cluster, _ = ep.run_dht(gossip_seeds=seeds)
        roles = [ep.run_shortest_path_worker(graph_dir, s, SHARDS, gossip_seeds=seeds)
                 for s in range(SHARDS)]
        try:
            approx = ep.run_approx_harmonic_coordinator(
                graph_dir, str(tmp_path / f"{pkg}-approx"), SHARDS, num_samples=4, seed=2,
                gossip_seeds=seeds, wait_s=30.0)
            dist = ep.run_shortest_path_coordinator(
                graph_dir, Webgraph(graph_dir).name_of(9), str(tmp_path / f"{pkg}-sp"),
                SHARDS, gossip_seeds=seeds, wait_s=30.0)
            out[pkg] = (approx, dist, dict(Db.open(str(tmp_path / f"{pkg}-approx")).items()),
                        dict(Db.open(str(tmp_path / f"{pkg}-sp")).items()))
        finally:
            for _, c in roles:
                c.shutdown()
            dht_cluster.shutdown()
            seed.shutdown()
            for s in [dht_srv] + [s for s, _ in roles]:
                s.stop()
    assert out["port"] == out["jax"]
    assert sum(v > 0 for v in out["port"][0].values()) > 4 and len(out["port"][1]) > 1


# ---- the raft-replicated DHT: a gap of the reference, kept ---------------------------
@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_raft_dht_cannot_serve_a_coordinator_in_either_package(pkg, graph_dir):
    """`run_dht` with peers serves a RaftNode: every replica announces itself
    as a DHT shard of its own (shard = node_id), so a coordinator's discovery
    takes one group for three shards, and the DhtClient's batch calls end in
    an ApplicationError (a RaftNode answers only its raft RPCs): the harmonic
    job fails at its first write. The same in both packages."""
    name = "stract_tpu" if pkg == "jax" else "stract_tpu_torch"
    ep = importlib.import_module(f"{name}.entrypoint.ampc")
    cl = importlib.import_module(f"{name}.distributed.cluster")
    sonic = importlib.import_module(f"{name}.distributed.sonic")
    D, _, H, _, W, G, kw = PKGS[pkg]
    peers = [sonic.free_socket_addr() for _ in range(3)]
    seed = cl.Cluster.join(cl.Service("admin"), interval=0.1, failure_timeout=5.0)
    replicas = [ep.run_dht(*peers[i], node_id=i, peers=peers, gossip_seeds=[seed.gossip_addr])
                for i in range(3)]
    graph = G(graph_dir)
    ef, et = H.partition_edges(graph, 1)[0]
    worker = W.start_worker(H.HarmonicWorker(0, 1, ef, et, graph.num_nodes, 6, **kw))
    try:
        assert _await_services(seed, "ampc-dht", 3) == [0, 1, 2]  # three "shards", one group
        client = D.DhtClient([tuple(p) for p in peers])
        with pytest.raises(sonic.ApplicationError):
            client.batch_set("t", [(b"k", 1)])
        with pytest.raises(sonic.RpcError):
            H.run_distributed_harmonic(graph, [worker.addr], client, 1)
        for c in client.clients:
            c.close()
    finally:
        worker.stop()
        for server, cluster_, node in replicas:
            cluster_.shutdown()
            node._stop.set()
            server.stop()
        seed.shutdown()


def _await_services(seed, kind: str, n: int, timeout: float = 30.0) -> list:
    """The shards of the first `n` services of `kind` the seed sees within
    `timeout` seconds, sorted."""
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        shards = sorted(s.shard for s in seed.services(kind))
        if len(shards) >= n:
            return shards
        time.sleep(0.1)
    return sorted(s.shard for s in seed.services(kind))
