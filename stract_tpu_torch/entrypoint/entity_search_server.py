"""Entity search shard server — the port's copy of
stract_tpu/entrypoint/entity_search_server.py, run by `main.py
entity-search-server CONFIG` (role of reference
entrypoint/entity_search_server.rs: a sonic `SearchService` with
Search{query} → EntityMatch and GetEntityImage{image_id} RPCs, joined to
gossip as an `EntitySearcher` service so the API coordinator discovers it
instead of loading the entity index in-process). Its RPCs speak the JAX
package's wire forms, so a coordinator of either package reads a server of
the other. Like the JAX package's, this role does no device work."""

from __future__ import annotations

from ..distributed.cluster import Cluster, Service
from ..distributed.sonic import RpcError, serve_in_thread
from ..entity_index import EntityIndex


class EntitySearchService:
    def __init__(self, index: EntityIndex, image_store=None):
        self.index = index
        self.image_store = image_store

    # -- RPC methods ------------------------------------------------------------
    def search(self, body: dict):
        """Top entity for the query, or None (entity_search_server.rs Search)."""
        hits = self.index.search(body["query"], top_k=1)
        return hits[0].to_json() if hits else None

    def get_entity_image(self, body: dict):
        """Raw image bytes (msgpack carries bytes natively), or None."""
        if self.image_store is None:
            return None
        return self.image_store.get(body["image_id"])

    def size(self, body=None) -> dict:
        return {"num_entities": len(self.index)}


def run(index_path: str, image_store_path: str = "", host: str = "127.0.0.1",
        port: int = 0, gossip_addr=("127.0.0.1", 0), gossip_seeds=()):
    image_store = None
    if image_store_path:
        from ..image_store import ImageStore

        image_store = ImageStore(image_store_path)
    service = EntitySearchService(EntityIndex(index_path), image_store)
    server = serve_in_thread(service, host, port)
    cluster = Cluster.join(
        Service("entity-search", host=server.addr, shard=0),
        gossip_addr=gossip_addr, seeds=gossip_seeds,
    )
    return server, cluster


# ---- coordinator-side remote wrappers (duck-typed like the in-proc ones) -------

class RemoteSidebarManager:
    """SidebarManager backed by a gossip-discovered entity-search service
    (role of the reference ApiSearcher's remote EntitySearcher client,
    searcher/api/sidebar.rs)."""

    def __init__(self, client):
        self.client = client  # ReusableShardedClient("entity-search")

    def sidebar(self, query: str) -> dict | None:
        try:
            res = self.client.send("search", {"query": query})
        except RpcError:
            return None
        for vals in res.values():
            for v in vals:
                if v is not None:
                    return {"type": "entity", "value": v}
        return None


class RemoteEntityImageStore:
    """ImageStore duck type over the entity-search service's image RPC."""

    def __init__(self, client):
        self.client = client

    def get(self, image_id: str):
        try:
            res = self.client.send("get_entity_image", {"image_id": image_id})
        except RpcError:
            return None
        for vals in res.values():
            for v in vals:
                if v is not None:
                    return v
        return None
