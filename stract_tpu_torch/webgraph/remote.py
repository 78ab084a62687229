"""RemoteWebgraph — the port's copy of stract_tpu/webgraph/remote.py: the
coordinator-side sharded webgraph access (role of reference
webgraph/remote.rs:48-80: fan-out queries over webgraph shards discovered via
gossip)."""

from __future__ import annotations

from ..distributed.replication import (
    AllShardsSelector,
    RandomReplicaSelector,
    ReusableShardedClient,
)


class RemoteWebgraph:
    def __init__(self, client):
        """client: ShardedClient | ReusableShardedClient over 'webgraph'."""
        self.client = client

    @classmethod
    def from_cluster(cls, cluster) -> "RemoteWebgraph":
        return cls(ReusableShardedClient(cluster, "webgraph"))

    def _fanout(self, method: str, body: dict) -> list:
        results = self.client.send(
            method, body, shard_selector=AllShardsSelector(),
            replica_selector=RandomReplicaSelector(),
        )
        out = []
        for replies in results.values():
            r = replies[0]
            if isinstance(r, list):
                out.extend(r)
            elif r:
                out.append(r)
        return out

    def backlinks(self, node: str, limit: int = 100) -> list:
        return self._fanout("backlinks", {"node": node, "limit": limit})

    def forwardlinks(self, node: str, limit: int = 100) -> list:
        return self._fanout("forwardlinks", {"node": node, "limit": limit})

    def backlink_labels(self, node: str, limit: int = 128) -> list:
        return self._fanout("backlink_labels", {"node": node, "limit": limit})

    def batch_search_backlinks(self, nodes: list, limit: int = 100) -> dict:
        """node → backlinks; used by combine_results' inbound_vecs fetch
        (searcher/api/mod.rs:412-465)."""
        return {n: self.backlinks(n, limit) for n in nodes}

    def group_sketch(self, node: str, direction: str = "to", precision: int = 12) -> dict:
        """HostGroupSketchQuery over all shards (reference group_by.rs:40):
        host → HyperLogLog, merged by register max across shards exactly like
        the reference's GroupSketchCollector::merge_fruits."""
        from ..utils.hyperloglog import HyperLogLog

        results = self.client.send(
            "group_sketch", {"node": node, "direction": direction, "precision": precision},
            shard_selector=AllShardsSelector(), replica_selector=RandomReplicaSelector(),
        )
        merged: dict = {}
        for replies in results.values():
            for host, raw in (replies[0] or {}).items():
                hll = HyperLogLog.from_bytes(raw)
                if host in merged:
                    merged[host].merge(hll)
                else:
                    merged[host] = hll
        return merged

    def group_exact(self, node: str, direction: str = "to", limit: int = 4096) -> dict:
        """HostGroupQuery over all shards (group_by.rs:188): host → [names]."""
        results = self.client.send(
            "group_exact", {"node": node, "direction": direction, "limit": limit},
            shard_selector=AllShardsSelector(), replica_selector=RandomReplicaSelector(),
        )
        merged: dict = {}
        for replies in results.values():
            for host, names in (replies[0] or {}).items():
                seen = merged.setdefault(host, [])
                for n in names:
                    if n not in seen and len(seen) < limit:
                        seen.append(n)
        return merged

    def similar_hosts(self, hosts: list, top_k: int = 20) -> list:
        merged = self._fanout("similar_hosts", {"hosts": hosts, "top_k": top_k})
        merged.sort(key=lambda d: -d["score"])
        return merged[:top_k]

    def knows(self, host: str) -> bool:
        return any(self._fanout("knows", {"host": host}))

    def id2node(self, node_id: int):
        hits = self._fanout("id2node", {"id": node_id})
        return hits[0] if hits else None
