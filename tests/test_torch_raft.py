"""The port's raft-replicated DHT shard (stract_tpu_torch/ampc/raft.py)
against the JAX package's, on the CPU.

Tolerance: none. After the same seeded operations every replica's tables
equal the JAX group's replicas' (set, the upserts, clone, drop), before and
after a failover. Timing: tier-1 runs six xdist workers, so no test leans on
a margin of a few hundred milliseconds. A test of a timing property (no
election while a follower is dead) widens the election timeout through the
node's constructor arguments; every wait polls under a deadline.
"""

from __future__ import annotations

import copy
import time

import numpy as np

from stract_tpu.ampc import raft as JR
from stract_tpu_torch.ampc import raft as PR
from stract_tpu_torch.distributed.sonic import serve_in_thread

RAFT = {"jax": JR, "port": PR}


def wait_for(pred, timeout: float = 60.0, what: str = "condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.05)
    raise AssertionError(f"timed out after {timeout}s waiting for {what}")


def wait_for_leader(nodes, timeout: float = 60.0):
    def one():
        leaders = [n for n in nodes if n.state == "leader"]
        return leaders[0] if len(leaders) == 1 else None

    return wait_for(one, timeout, "a single leader")


def applied(nodes) -> bool:
    """Every node has applied the longest log among them."""
    n = max(len(x.log) for x in nodes)
    return all(len(x.log) == n and x.last_applied == n - 1 for x in nodes)


def stop(nodes, servers, client=None):
    """Stop the nodes' loops, close every client's pooled connections (a
    server's stop waits on the open ones), then stop the servers."""
    for n in nodes:
        n._stop.set()
        for ev in n._peer_wake.values():
            ev.set()
    for n in nodes:
        for t in n._repl_threads:
            t.join(timeout=5)
    clients = [c for n in nodes for c in n.peers.values()]
    for c in clients + (client.clients if client is not None else []):
        c.close()
    for s in servers:
        try:
            s.stop()
        except Exception:  # noqa: BLE001 — already stopped
            pass


def kill(nodes, servers, idx: int, client) -> None:
    """Stop node `idx` and its server, its connections closed first."""
    node = nodes[idx]
    stop([node], [], None)
    for c in [n.peers[node.id] for n in nodes if node.id in n.peers] + [client.clients[idx]]:
        c.close()
    servers[idx].stop()


def operations(seed: int) -> list:
    """A seeded sequence of DHT writes: sets, each upsert function, a clone
    and a drop."""
    rng = np.random.default_rng(seed)
    ops = []
    for i in range(8):
        keys = [f"k{int(k)}".encode() for k in rng.integers(0, 12, 6)]
        fn = ("u64_add", "u64_min", "f64_add", "hll_max")[i % 4]
        vals = ([rng.integers(0, 30, 16, dtype=np.uint8).tobytes() for _ in keys]
                if fn == "hll_max" else [float(x) for x in rng.normal(size=6)]
                if fn == "f64_add" else [int(x) for x in rng.integers(0, 99, 6)])
        ops.append(("batch_upsert", {"table": fn, "fn": fn, "pairs": list(zip(keys, vals))}))
        ops.append(("batch_set", {"table": "s", "pairs": [(keys[0], i)]}))
    ops += [("clone_table", {"from": "s", "to": "s2"}), ("drop_table", {"table": "u64_min"})]
    return ops


def test_replicated_writes_and_failover_tables_equal_the_jax_groups():
    """Three replicas of each package take the same writes; every replica
    applies them; the leader is stopped, a new one is elected and the rest
    of the writes go through it. Each replica's tables, and the reads
    through the client, equal the JAX group's."""
    ops = operations(7)
    tables, reads = {}, {}
    for pkg, mod in RAFT.items():
        nodes, servers, client = mod.start_raft_group(3)
        try:
            leader = wait_for_leader(nodes)
            for op, body in ops[:10]:
                assert client.write(op, body)["ok"]
            wait_for(lambda: applied(nodes), what="every replica applied")
            before = [copy.deepcopy(n.store.tables) for n in nodes]
            idx = nodes.index(leader)
            kill(nodes, servers, idx, client)
            survivors = [n for i, n in enumerate(nodes) if i != idx]
            assert wait_for_leader(survivors) is not leader
            for op, body in ops[10:]:
                assert client.write(op, body)["ok"]
            wait_for(lambda: applied(survivors), what="the survivors applied")
            tables[pkg] = (before, [n.store.tables for n in survivors])
            reads[pkg] = [client.read("scan", {"table": t}) for t in ("u64_add", "s", "s2")]
            reads[pkg].append(client.read("batch_get", {"table": "hll_max",
                                                        "keys": [b"k1", b"k7"]}))
        finally:
            stop(nodes, servers, client)
    for pkg in RAFT:
        before, after = tables[pkg]
        assert all(t == before[0] for t in before) and all(t == after[0] for t in after)
    assert tables["port"] == tables["jax"] and reads["port"] == reads["jax"]
    assert "u64_min" not in tables["port"][1][0] and tables["port"][1][0]["s2"]


def test_log_consistency_after_a_follower_rejoins():
    """A follower cut off (its server stopped) misses five writes; the group
    commits them on the other two. Its server back on the same port, the
    leader's replicator brings its log, its commit index and its tables to
    the leader's, at one term."""
    nodes, servers, client = PR.start_raft_group(3)
    try:
        leader = wait_for_leader(nodes)
        idx = next(i for i, n in enumerate(nodes) if n is not leader)
        follower, addr = nodes[idx], servers[idx].addr
        servers[idx].stop()
        for i in range(5):
            assert client.write("batch_upsert", {"table": "c", "fn": "u64_add",
                                                 "pairs": [(b"n", 1)]})["ok"]
        assert client.read("batch_get", {"table": "c", "keys": [b"n"]}) == [5]
        assert len(follower.log) < len(leader.log)
        servers[idx] = serve_in_thread(follower, *addr)
        wait_for(lambda: applied(nodes), what="the follower caught up")
        assert follower.store.tables == leader.store.tables == {"c": {b"n": 5}}
        assert len({n.term for n in nodes}) == 1 and leader.state == "leader"
        assert [x["term"] for x in follower.log] == [x["term"] for x in leader.log]
    finally:
        stop(nodes, servers, client)


def test_no_spurious_election_with_a_dead_follower():
    """Five replicas with an election timeout of 2-4 s and heartbeats every
    50 ms (constructor arguments): one follower dead, 2 s of writes, and
    the leader and its term do not change (per-peer replicators keep the
    live followers' heartbeats flowing)."""
    nodes, servers, client = PR.start_raft_group(5, heartbeat_interval=0.05,
                                                 election_timeout=(2.0, 4.0))
    try:
        leader = wait_for_leader(nodes)
        dead = next(i for i, n in enumerate(nodes) if n is not leader)
        kill(nodes, servers, dead, client)
        term0 = leader.term
        t_end = time.monotonic() + 2.0
        k = 0
        while time.monotonic() < t_end:
            assert client.write("batch_set", {"table": "t", "pairs": [(f"k{k}".encode(), k)]})["ok"]
            k += 1
        assert k > 10
        live = [n for i, n in enumerate(nodes) if i != dead]
        assert wait_for_leader(live) is leader and leader.term == term0
        assert client.read("batch_get", {"table": "t", "keys": [b"k0"]}) == [0]
    finally:
        stop(nodes, servers, client)


def test_partitioned_leader_steps_down_and_rejoins():
    """Five replicas: the leader cut off both ways (its server stopped, its
    clients pointed at a closed port); the other four elect a leader and
    take a write; healed, the old leader hears the higher term through its
    own RPCs and steps down, and its log takes the write."""
    nodes, servers, client = PR.start_raft_group(5)
    try:
        leader = wait_for_leader(nodes)
        idx = nodes.index(leader)
        servers[idx].stop()
        saved = {nid: c.addr for nid, c in leader.peers.items()}
        for c in leader.peers.values():
            c.close()
            c.addr = ("127.0.0.1", 1)
        others = [n for i, n in enumerate(nodes) if i != idx]
        new_leader = wait_for_leader(others)
        assert new_leader is not leader
        assert client.write("batch_set", {"table": "p", "pairs": [(b"x", 7)]})["ok"]
        assert client.read("batch_get", {"table": "p", "keys": [b"x"]}) == [7]
        for nid, c in leader.peers.items():
            c.close()
            c.addr = saved[nid]
        wait_for(lambda: leader.state != "leader", what="the healed leader to step down")
        assert leader.term >= new_leader.term - 1
        servers[idx] = serve_in_thread(leader, *servers[idx].addr)
        wait_for(lambda: leader.store.tables.get("p") == {b"x": 7},
                 what="the old leader to take the write")
    finally:
        stop(nodes, servers, client)
