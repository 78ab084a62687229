"""Replica/shard client layer (role of reference sonic/replication.rs:
RemoteClient retry :29-151, ReplicatedClient + selectors :153-331,
ShardedClient :356, ReusableShardedClient refreshed from gossip :494-505)."""

from __future__ import annotations

import random
import threading
import time

from ..utils.executor import Executor
from .cluster import Cluster
from .sonic import RemoteClient, RpcError


class RandomReplicaSelector:
    def select(self, replicas):
        return [random.choice(replicas)] if replicas else []


class AllReplicaSelector:
    def select(self, replicas):
        return list(replicas)


class SpecificReplicaSelector:
    def __init__(self, index: int):
        self.index = index

    def select(self, replicas):
        return [replicas[self.index % len(replicas)]] if replicas else []


class AllShardsSelector:
    def select(self, shard_ids):
        return list(shard_ids)


class SpecificShardSelector:
    def __init__(self, shard_id):
        self.shard_id = shard_id

    def select(self, shard_ids):
        return [s for s in shard_ids if s == self.shard_id]


class ReplicatedClient:
    """Fan-out over replicas of one shard. Failed replicas are skipped and the
    call retried on another (reference ReplicatedClient behavior)."""

    def __init__(self, addrs, timeout: float = 90.0):
        self.clients = [RemoteClient(a, timeout=timeout) for a in addrs]

    def send(self, method: str, body=None, selector=None):
        selector = selector or RandomReplicaSelector()
        chosen = selector.select(self.clients)
        if not chosen:
            raise RpcError("no replicas")
        if len(chosen) == 1 and isinstance(selector, RandomReplicaSelector):
            # retry on other replicas if the chosen one is down
            order = chosen + [c for c in self.clients if c is not chosen[0]]
            last = None
            for c in order:
                try:
                    return [c.send(method, body)]
                except RpcError as e:
                    last = e
            raise last
        results = Executor.multi_thread(len(chosen)).map(lambda c: c.send(method, body), chosen)
        return results


class ShardedClient:
    """shard_id → ReplicatedClient; fan-out with shard+replica selectors
    (reference ShardedClient :356)."""

    def __init__(self, shards: dict):
        self.shards = dict(shards)

    def shard_ids(self):
        return sorted(self.shards.keys())

    def send(self, method: str, body=None, shard_selector=None, replica_selector=None):
        shard_selector = shard_selector or AllShardsSelector()
        ids = shard_selector.select(self.shard_ids())
        ex = Executor.multi_thread(max(len(ids), 1))

        def call(sid):
            return sid, self.shards[sid].send(method, body, replica_selector)

        return dict(ex.map(call, ids))


class ReusableShardedClient:
    """ShardedClient rebuilt from gossip membership every `refresh` seconds
    (reference replication.rs:494-505: 60s)."""

    def __init__(self, cluster: Cluster, kind: str, refresh: float = 60.0):
        self.cluster = cluster
        self.kind = kind
        self.refresh = refresh
        self._client: ShardedClient | None = None
        self._built = 0.0
        self._lock = threading.Lock()

    def get(self) -> ShardedClient:
        with self._lock:
            now = time.monotonic()
            if self._client is None or now - self._built > self.refresh:
                shards: dict[int, list] = {}
                for svc in self.cluster.services(self.kind):
                    if svc.host:
                        shards.setdefault(svc.shard, []).append(svc.host)
                self._client = ShardedClient({sid: ReplicatedClient(addrs) for sid, addrs in shards.items()})
                self._built = now
            return self._client

    def invalidate(self):
        with self._lock:
            self._client = None

    def close(self):
        """Close every pooled connection to the shards (a server then stops
        without waiting on them); a later send reconnects."""
        with self._lock:
            client, self._client = self._client, None
        for replicated in client.shards.values() if client is not None else ():
            for remote in replicated.clients:
                remote.close()

    def send(self, method: str, body=None, shard_selector=None, replica_selector=None):
        return self.get().send(method, body, shard_selector, replica_selector)
