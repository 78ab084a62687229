"""Webgraph shard server — the port's copy of
stract_tpu/entrypoint/webgraph_server.py (role of reference
entrypoint/webgraph_server.rs:57 WebGraphService: backlinks / forwardlinks /
id2node / similar-hosts RPC over a graph shard, announced by gossip as the
`webgraph` service). Host work: it does no device work."""

from __future__ import annotations

from ..distributed.cluster import Cluster, Service
from ..distributed.sonic import serve_in_thread
from ..ranking.inbound_similarity import InboundSimilarity
from ..webgraph import Webgraph


class WebGraphService:
    def __init__(self, graph: Webgraph, shard_id: int = 0):
        self.graph = graph
        self.shard_id = shard_id
        self.similarity = InboundSimilarity(graph)

    # -- RPC methods ------------------------------------------------------------
    def backlinks(self, body: dict) -> list:
        node = body["node"]
        out = []
        for src, flags in self.graph.backlinks(node)[: body.get("limit", 100)]:
            out.append({"from": self.graph.name_of(src), "to": node, "rel_flags": flags})
        return out

    def forwardlinks(self, body: dict) -> list:
        node = body["node"]
        out = []
        for tgt, flags in self.graph.forwardlinks(node)[: body.get("limit", 100)]:
            out.append({"from": node, "to": self.graph.name_of(tgt), "rel_flags": flags})
        return out

    def id2node(self, body: dict):
        return self.graph.id2node(body["id"])

    def backlink_labels(self, body: dict) -> list:
        return self.graph.backlink_labels(body["node"], body.get("limit", 128))

    def similar_hosts(self, body: dict) -> list:
        res = self.similarity.similar_hosts(body["hosts"], body.get("top_k", 20))
        return [{"host": h, "score": s} for h, s in res]

    def knows(self, body: dict) -> bool:
        return self.graph.rank_of(body["host"]) is not None

    def group_sketch(self, body: dict) -> dict:
        """HostGroupSketchQuery role (reference webgraph/query/group_by.rs:40,
        registered on the sonic service in entrypoint/webgraph_server.rs:160):
        host → serialized HLL registers; the coordinator merges across shards
        (register max is commutative, like the reference's merge_fruits)."""
        groups = self.graph.group_sketch(
            body["node"], body.get("direction", "to"),
            precision=body.get("precision", 12))
        return {host: hll.to_bytes() for host, hll in groups.items()}

    def group_exact(self, body: dict) -> dict:
        """HostGroupQuery role (group_by.rs:188): host → [node names]."""
        return self.graph.group_exact(
            body["node"], body.get("direction", "to"),
            limit=body.get("limit", 4096))

    def inbound_profiles(self, body: dict) -> dict:
        """Batch inbound profiles for coordinator-side similarity scoring."""
        out = {}
        for nid in body["node_ids"]:
            out[str(nid)] = self.similarity.profile_by_node_id(int(nid)).tolist()
        return out


def run(graph_path: str, shard_id: int = 0, host: str = "127.0.0.1", port: int = 0,
        gossip_addr=("127.0.0.1", 0), gossip_seeds=()):
    graph = Webgraph(graph_path)
    service = WebGraphService(graph, shard_id)
    server = serve_in_thread(service, host, port)
    cluster = Cluster.join(
        Service("webgraph", host=server.addr, shard=shard_id),
        gossip_addr=gossip_addr, seeds=gossip_seeds,
    )
    return server, cluster
