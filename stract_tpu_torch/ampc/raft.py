"""Raft consensus for DHT shard replication — the port's copy of
stract_tpu/ampc/raft.py (role of reference ampc/dht's
openraft usage: each DHT shard is a raft group — dht/mod.rs:31-59, log_store.rs,
network/).

Compact but real Raft: randomized election timeouts, terms, RequestVote,
AppendEntries with log matching + commit on majority, state-machine apply of
the DHT table operations (batch_set / batch_upsert / drop_table / clone_table).
Log is in-memory (the reference persists via openraft's log store; durability
here comes from the AMPC model — a lost shard group restarts its job, the same
documented recovery story as the reference).

Transport: sonic RPC. Each replica runs a RaftNode wrapping a DhtShard as the
state machine; clients route writes to the leader (followers answer with a
redirect).

The heartbeat interval and the election timeout's range are a node's
constructor arguments (the JAX package reads them from the module constants,
which stay the defaults), so a deployment on a loaded host, or a test of a
timing property, can widen them. A group answers request_vote,
append_entries, propose, read and status alone: DhtClient's batch_get /
batch_set / batch_upsert reach no raft node (the JAX package's gap, kept for
parity); RaftShardClient is the group's client."""

from __future__ import annotations

import random
import threading
import time

from ..distributed.sonic import RemoteClient, RpcError, serve_in_thread
from .dht import DhtShard

HEARTBEAT_INTERVAL = 0.08
ELECTION_TIMEOUT = (0.25, 0.5)


class RaftNode:
    """One replica of a DHT shard group."""

    def __init__(self, node_id: int, peers: list | None = None,
                 heartbeat_interval: float = HEARTBEAT_INTERVAL,
                 election_timeout: tuple = ELECTION_TIMEOUT):
        self.id = node_id
        self.heartbeat_interval = heartbeat_interval
        self.election_timeout_range = tuple(election_timeout)
        self.peers: dict[int, RemoteClient] = {}
        self.store = DhtShard()

        self.term = 0
        self.voted_for: int | None = None
        self.state = "follower"
        self.leader_id: int | None = None
        self.log: list[dict] = []  # {term, op, body}
        self.commit_index = -1
        self.last_applied = -1
        self.next_index: dict[int, int] = {}
        self.match_index: dict[int, int] = {}

        self._lock = threading.RLock()
        self._commit_cv = threading.Condition(self._lock)
        self._last_heartbeat = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._tick_loop, daemon=True)
        self._election_timeout = random.uniform(*self.election_timeout_range)
        self._peer_wake: dict[int, threading.Event] = {}
        self._repl_threads: list[threading.Thread] = []

    def start(self):
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        for ev in self._peer_wake.values():
            ev.set()
        self._thread.join(timeout=2)

    def set_peers(self, peers: dict):
        """peers: node_id → (host, port) of the other replicas. Each peer gets
        a dedicated replicator thread — one dead follower must never stall the
        leader's heartbeats to the others (liveness: a synchronous broadcast
        with a 2s dead-peer timeout stretched the heartbeat period past the
        followers' election timeout and triggered spurious elections)."""
        with self._lock:
            self.peers = {nid: RemoteClient(addr, timeout=2.0, retries=1) for nid, addr in peers.items()}
            for nid in self.peers:
                self.next_index[nid] = len(self.log)
                self.match_index[nid] = -1
                self._peer_wake[nid] = threading.Event()
        for nid in self.peers:
            t = threading.Thread(target=self._replicator_loop, args=(nid,), daemon=True)
            t.start()
            self._repl_threads.append(t)

    def _replicator_loop(self, nid: int):
        """Per-peer heartbeat + log replication."""
        while not self._stop.is_set():
            self._peer_wake[nid].wait(timeout=self.heartbeat_interval)
            self._peer_wake[nid].clear()
            if self._stop.is_set():
                return
            with self._lock:
                is_leader = self.state == "leader"
            if is_leader:
                self._append_to(nid)

    @property
    def quorum(self) -> int:
        return (len(self.peers) + 1) // 2 + 1

    # ---- RPC handlers (dispatched by sonic) ------------------------------------
    def request_vote(self, body: dict):
        with self._lock:
            term, cand = body["term"], body["candidate"]
            up_to_date = (body["last_log_term"], body["last_log_index"]) >= self._last_log()
            if body.get("prevote"):
                # PreVote (Raft §9.6) + leader stickiness: grant without touching
                # our own term iff we'd vote for this candidate in that term AND
                # we ourselves suspect the leader is gone (no heartbeat for at
                # least the minimum election timeout). A single starved/partitioned
                # node can therefore never inflate the cluster's term.
                elapsed = time.monotonic() - self._last_heartbeat
                grant = (
                    term >= self.term
                    and up_to_date
                    and self.state != "leader"
                    and elapsed >= self.election_timeout_range[0]
                )
                return {"term": self.term, "granted": grant}
            if term > self.term:
                self._become_follower(term)
            grant = (
                term >= self.term
                and self.voted_for in (None, cand)
                and up_to_date
            )
            if grant:
                self.voted_for = cand
                self._last_heartbeat = time.monotonic()
            return {"term": self.term, "granted": grant}

    def append_entries(self, body: dict):
        with self._lock:
            term = body["term"]
            if term < self.term:
                return {"term": self.term, "success": False}
            self._become_follower(term)
            # same-term candidate accepting a leader's entries steps down too
            self.state = "follower"
            self.leader_id = body["leader"]
            self._last_heartbeat = time.monotonic()

            prev_idx = body["prev_log_index"]
            if prev_idx >= 0:
                if prev_idx >= len(self.log) or self.log[prev_idx]["term"] != body["prev_log_term"]:
                    return {"term": self.term, "success": False}
            # append/overwrite
            idx = prev_idx + 1
            for e in body["entries"]:
                if idx < len(self.log):
                    if self.log[idx]["term"] != e["term"]:
                        del self.log[idx:]
                        self.log.append(e)
                else:
                    self.log.append(e)
                idx += 1
            if body["leader_commit"] > self.commit_index:
                self.commit_index = min(body["leader_commit"], len(self.log) - 1)
                self._apply_committed()
            return {"term": self.term, "success": True}

    def propose(self, body: dict):
        """Client write: {op, body}. Leader appends, wakes the per-peer
        replicators, and waits for the commit index to reach the entry (commit
        advances via the match-index majority rule); followers redirect."""
        with self._lock:
            if self.state != "leader":
                return {"ok": False, "leader": self.leader_id}
            entry = {"term": self.term, "op": body["op"], "body": body["body"]}
            self.log.append(entry)
            index = len(self.log) - 1
            if not self.peers:  # single-node group commits immediately
                self._advance_commit()
        for ev in self._peer_wake.values():
            ev.set()
        deadline = time.monotonic() + 2.0
        with self._commit_cv:
            while self.commit_index < index and self.state == "leader":
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._commit_cv.wait(timeout=remaining)
            if self.commit_index >= index and self.state == "leader":
                return {"ok": True}
            return {"ok": False, "leader": None}

    def read(self, body: dict):
        """Reads serve from the leader's applied state (linearizable enough for
        the AMPC BSP model where rounds are barriers)."""
        with self._lock:
            if self.state != "leader":
                return {"ok": False, "leader": self.leader_id}
            method = getattr(self.store, body["op"])
            return {"ok": True, "result": method(body["body"])}

    def status(self, body=None):
        with self._lock:
            return {"id": self.id, "state": self.state, "term": self.term,
                    "leader": self.leader_id, "log": len(self.log),
                    "commit": self.commit_index}

    # ---- internals -----------------------------------------------------------------
    def _last_log(self):
        if not self.log:
            return (0, -1)
        return (self.log[-1]["term"], len(self.log) - 1)

    def _become_follower(self, term: int):
        if term > self.term:
            self.term = term
            self.voted_for = None
            self.state = "follower"

    def _apply_committed(self):
        while self.last_applied < self.commit_index:
            self.last_applied += 1
            e = self.log[self.last_applied]
            getattr(self.store, e["op"])(e["body"])

    def _tick_loop(self):
        while not self._stop.is_set():
            time.sleep(self.heartbeat_interval / 2)
            with self._lock:
                state = self.state
                elapsed = time.monotonic() - self._last_heartbeat
            if state != "leader" and elapsed > self._election_timeout:
                self._run_election()

    def _run_election(self):
        """PreVote round first (no term change), then the real election.
        Vote requests go out in PARALLEL — a dead peer's RPC timeout must
        not delay reaching quorum on the live ones."""
        if not self._pre_vote():
            with self._lock:
                # retry after a fresh randomized timeout; term untouched
                self._last_heartbeat = time.monotonic()
                self._election_timeout = random.uniform(*self.election_timeout_range)
            return
        with self._lock:
            # a live leader's AppendEntries may have arrived during the
            # prevote round (heartbeat refreshed) — promoting anyway would
            # bump the term and force a disruptive election
            if time.monotonic() - self._last_heartbeat < self._election_timeout:
                return
            self.state = "candidate"
            self.term += 1
            self.voted_for = self.id
            self.leader_id = None
            term = self.term
            last_t, last_i = self._last_log()
            self._last_heartbeat = time.monotonic()
            self._election_timeout = random.uniform(*self.election_timeout_range)
        votes = {"n": 1}

        def ask(nid, client):
            try:
                r = client.send("request_vote", {
                    "term": term, "candidate": self.id,
                    "last_log_term": last_t, "last_log_index": last_i,
                })
            except RpcError:
                return
            with self._lock:
                if r.get("term", 0) > self.term:
                    self._become_follower(r["term"])
                    return
                if not r.get("granted"):
                    return
                votes["n"] += 1
                if (
                    self.state == "candidate"
                    and self.term == term
                    and votes["n"] >= self.quorum
                ):
                    self.state = "leader"
                    self.leader_id = self.id
                    for pid in self.peers:
                        self.next_index[pid] = len(self.log)
                        self.match_index[pid] = -1
                    for ev in self._peer_wake.values():
                        ev.set()  # immediate heartbeats assert leadership

        threads = [
            threading.Thread(target=ask, args=(nid, client), daemon=True)
            for nid, client in list(self.peers.items())
        ]
        for t in threads:
            t.start()

    def _pre_vote(self) -> bool:
        """Poll peers with term+1 WITHOUT incrementing anything; proceed to a
        real election only on quorum. Voters refuse while they still hear a
        live leader, so a lone starved/partitioned node cannot disrupt a
        healthy group (the GIL on a 1-core host can delay a follower's
        heartbeat delivery past its election timeout under write load)."""
        with self._lock:
            if not self.peers:
                return True
            term = self.term + 1
            last_t, last_i = self._last_log()
        votes = {"n": 1, "max_term": 0}
        quorum = self.quorum
        done = threading.Event()

        def ask(client):
            try:
                r = client.send("request_vote", {
                    "term": term, "candidate": self.id, "prevote": True,
                    "last_log_term": last_t, "last_log_index": last_i,
                })
            except RpcError:
                return
            with self._lock:
                votes["max_term"] = max(votes["max_term"], r.get("term", 0))
                if r.get("granted"):
                    votes["n"] += 1
                    if votes["n"] >= quorum:
                        done.set()

        for client in list(self.peers.values()):
            threading.Thread(target=ask, args=(client,), daemon=True).start()
        done.wait(timeout=self.election_timeout_range[0])
        with self._lock:
            # a higher term in any response means the cluster moved on —
            # adopt it and stand down instead of starting a stale election
            if votes["max_term"] > self.term:
                self._become_follower(votes["max_term"])
                return False
            return votes["n"] >= quorum and self.state != "leader"

    def _append_to(self, nid: int) -> bool:
        """Send missing entries to one follower; retreats next_index on mismatch."""
        client = self.peers[nid]
        while True:
            with self._lock:
                if self.state != "leader":
                    return False
                ni = self.next_index.get(nid, len(self.log))
                prev_idx = ni - 1
                prev_term = self.log[prev_idx]["term"] if prev_idx >= 0 else 0
                entries = self.log[ni:]
                body = {
                    "term": self.term, "leader": self.id,
                    "prev_log_index": prev_idx, "prev_log_term": prev_term,
                    "entries": entries, "leader_commit": self.commit_index,
                }
            try:
                r = client.send("append_entries", body)
            except RpcError:
                return False
            with self._lock:
                if r.get("term", 0) > self.term:
                    self._become_follower(r["term"])
                    return False
                if r.get("success"):
                    self.next_index[nid] = ni + len(entries)
                    self.match_index[nid] = self.next_index[nid] - 1
                    self._advance_commit()
                    return True
                self.next_index[nid] = max(0, ni - 1)

    def _advance_commit(self):
        """Raft commit rule: the highest index replicated on a majority, only
        for entries of the CURRENT term (§5.4.2). Called with the lock held."""
        if self.state != "leader" or not self.log:
            return
        matches = sorted(
            [len(self.log) - 1] + [self.match_index.get(n, -1) for n in self.peers],
            reverse=True,
        )
        majority_idx = matches[self.quorum - 1]
        if majority_idx > self.commit_index and majority_idx >= 0 \
                and self.log[majority_idx]["term"] == self.term:
            self.commit_index = majority_idx
            self._apply_committed()
            self._commit_cv.notify_all()


class RaftShardClient:
    """Client for one raft-replicated DHT shard: finds the leader, retries on
    redirects/elections (role of the openraft client in dht/client.rs)."""

    def __init__(self, addrs: list, timeout: float = 5.0):
        self.addrs = [tuple(a) for a in addrs]
        self.clients = [RemoteClient(a, timeout=2.0, retries=1) for a in self.addrs]
        self.timeout = timeout
        self._leader = 0

    def _call(self, method: str, payload: dict):
        deadline = time.monotonic() + self.timeout
        i = self._leader
        while time.monotonic() < deadline:
            try:
                r = self.clients[i % len(self.clients)].send(method, payload)
            except RpcError:
                i += 1
                time.sleep(0.05)
                continue
            if r.get("ok"):
                self._leader = i % len(self.clients)
                return r
            leader = r.get("leader")
            i = leader if isinstance(leader, int) and leader is not None else i + 1
            time.sleep(0.05)
        raise RpcError("no raft leader reachable")

    def write(self, op: str, body: dict):
        return self._call("propose", {"op": op, "body": body})

    def read(self, op: str, body: dict):
        return self._call("read", {"op": op, "body": body})["result"]


def start_raft_group(n: int = 3, heartbeat_interval: float = HEARTBEAT_INTERVAL,
                     election_timeout: tuple = ELECTION_TIMEOUT):
    """In-process raft group → (nodes, servers, RaftShardClient); the timings
    are each node's (RaftNode)."""
    nodes = [RaftNode(i, heartbeat_interval=heartbeat_interval,
                      election_timeout=election_timeout) for i in range(n)]
    servers = [serve_in_thread(node) for node in nodes]
    addrs = {i: s.addr for i, s in enumerate(servers)}
    for i, node in enumerate(nodes):
        node.set_peers({j: a for j, a in addrs.items() if j != i})
        node.start()
    return nodes, servers, RaftShardClient(list(addrs.values()))
