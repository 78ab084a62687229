"""Live-index shard server — the port of stract_tpu/entrypoint/live_index.py
(role of reference entrypoint/live_index/search_server.rs:173
LiveIndexService: IndexWebpages RPC :369, replication with a
consistency_fraction quorum :243-305, the background TTL / compact /
autocommit loop driven by `tick`).

The service speaks the JAX package's wire forms over sonic (`index_webpages`
{pages: [{url, html}]}, `commit`, `tick`, `search` a SearchQuery's JSON,
`retrieve` {query, pointers}, `size`), so either package's client talks to
either package's server. A shard's search runs the port's two-phase search
over its LiveIndex on the LiveIndex's device: K1, K2 and K3 on a card, over
segments that commits add, compaction merges and the TTL drops while
searches run."""

from __future__ import annotations

import threading
import time

from ..distributed.cluster import Cluster, Service
from ..distributed.replication import ReplicatedClient
from ..distributed.sonic import serve_in_thread, RpcError
from ..live_index import LiveIndex
from ..searcher.local import LocalSearcher
from ..searcher.query import SearchQuery
from .indexer import IndexingWorker
from .search_server import candidate_to_wire, resolve_wire_pointers

DEFAULT_CONSISTENCY_FRACTION = 0.5


class LiveIndexService:
    def __init__(self, live: LiveIndex, shard_id: int = 0, worker: IndexingWorker | None = None):
        self.live = live
        self.shard_id = shard_id
        self.worker = worker or IndexingWorker()
        self.searcher = LocalSearcher(live.index, shard_id=shard_id, lazy_signals=False)
        self._lock = threading.Lock()

    # -- RPC methods ------------------------------------------------------------
    def index_webpages(self, body: dict) -> dict:
        """body: {pages: [{url, html}]} — prepare + WAL + insert."""
        n = 0
        with self._lock:
            for page in body["pages"]:
                doc = self.worker.prepare(page["html"], page["url"])
                if doc is not None:
                    self.live.insert(doc)
                    n += 1
        return {"indexed": n}

    def commit(self, body=None) -> bool:
        with self._lock:
            self.live.commit()
        return True

    def tick(self, body=None) -> bool:
        with self._lock:
            self.live.tick()
        return True

    def search(self, body: dict) -> dict:
        sq = SearchQuery.from_json(body)
        candidates, count = self.searcher.search_initial(sq)
        return {"candidates": [candidate_to_wire(c) for c in candidates], "count": count.to_json()}

    def retrieve(self, body: dict) -> list:
        sq = SearchQuery.from_json(body["query"])
        ptrs, segs = resolve_wire_pointers(self.live.index, body["pointers"])
        live_ptrs = [p for p in ptrs if p is not None]
        docs = iter(self.searcher.retrieve(sq, live_ptrs, segments=segs))
        return [(next(docs) if p is not None else {}) for p in ptrs]

    def size(self, body=None) -> dict:
        return {"num_docs": self.live.index.num_docs}


class LiveIndexClient:
    """Client-side quorum writes: pages go to ALL replicas; the write succeeds
    when at least max(1, ceil(consistency_fraction * n)) of the n replicas
    acked (reference :243-305), else RpcError."""

    def __init__(self, replicas: ReplicatedClient,
                 consistency_fraction: float = DEFAULT_CONSISTENCY_FRACTION):
        self.replicas = replicas
        self.fraction = consistency_fraction

    def index_webpages(self, pages: list[dict]) -> int:
        n = len(self.replicas.clients)
        results = []
        for c in self.replicas.clients:
            try:
                results.append(c.send("index_webpages", {"pages": pages}))
            except RpcError:
                pass
        acked = len(results)
        if acked < max(1, int(self.fraction * n + 0.999999)):
            raise RpcError(f"quorum failed: {acked}/{n} replicas acked")
        return max(r["indexed"] for r in results)


def run(path: str, shard_id: int, host: str = "127.0.0.1", port: int = 0,
        gossip_addr=("127.0.0.1", 0), gossip_seeds=(), device="cuda", clock=None):
    """Start a live-index shard over the live directory at `path` on
    `device`: the RPC server and its gossip membership as `live-index`
    (shard `shard_id`) → (server, cluster). `clock` (default time.time)
    is the LiveIndex's."""
    live = LiveIndex(path, device=device, clock=clock or time.time)
    service = LiveIndexService(live, shard_id=shard_id)
    server = serve_in_thread(service, host, port)
    cluster = Cluster.join(
        Service("live-index", host=server.addr, shard=shard_id),
        gossip_addr=gossip_addr, seeds=gossip_seeds,
    )
    return server, cluster
