"""Search shard server — the port of stract_tpu/entrypoint/search_server.py
(role of reference entrypoint/search_server.rs:120-236: SearchService sonic
service + run()).

RPC methods (dispatched by distributed/sonic.py; the wire forms are the JAX
package's, so a coordinator of either package reads a shard of either):
  search              SearchQuery json → {candidates, count}
  search_batch        {queries} → one {candidates, count} per query
  search_block_batch  {queries, max_candidates} → one {block, count} per query
  retrieve            {query, pointers} → stored docs + snippets
  get_webpage         {url} → stored doc
  get_homepage        {site} → stored doc
  size                {} → {num_docs}

With a mesh of more than one entry (parallel/mesh.py) the shard serves its
segments one per mesh entry through the sharded two-stage program
(parallel/search.py MeshShardedSearcher); the entries may share a card.
"""

from __future__ import annotations

import numpy as np

from ..distributed.cluster import Cluster, Service
from ..distributed.sonic import serve_in_thread
from ..index.inverted import DocPointer, InvertedIndex
from ..searcher.local import LocalSearcher
from ..searcher.query import SearchQuery


def candidate_to_wire(c) -> dict:
    # pointer ordinals index the ctx's search-time segment snapshot; the
    # segment NAME goes too, so the retrieve phase re-resolves against the
    # segment list of its own time
    ctx = getattr(c, "_ctx", None)
    snap = getattr(ctx, "_segments", None) if ctx is not None else None
    seg_name = snap[c.pointer.segment].name if snap is not None else None
    return {
        "shard": c.shard,
        "segment": c.pointer.segment,
        "seg": seg_name,
        "doc": c.pointer.doc,
        "score": c.score,
        "signals": c.signals,
        "title_embedding": c.title_embedding,
        "keyword_embedding": c.keyword_embedding,
        "dedup": c.dedup,
        "host_id": c.host_id,
    }


def candidate_from_wire(d):
    from ..ranking.pipeline import RankedCandidate

    c = RankedCandidate(
        shard=d["shard"],
        pointer=DocPointer.from_json(d),
        score=d["score"],
        signals=np.asarray(d["signals"], dtype=np.float32),
        title_embedding=d.get("title_embedding"),
        keyword_embedding=d.get("keyword_embedding"),
        dedup=d.get("dedup", {}),
        host_id=d.get("host_id", 0),
    )
    c._seg_name = d.get("seg")
    return c


def block_to_wire(block, shard_id: int) -> dict:
    """CandidateBlock → wire dict of arrays (the msgpack numpy ext type ships
    them). Pointer ordinals index the search-time snapshot; seg_names lets
    the retrieve phase re-resolve them."""
    return {
        "segment": block.segment,
        "doc": block.doc,
        "score": block.score,
        "dedup": block.dedup,
        "host_id": block.host_id,
        "signals": block.signals,
        "title_emb": block.title_emb,
        "keyword_emb": block.keyword_emb,
        "seg_names": block.seg_names.get(shard_id),
        "cols": block.cols,
    }


def block_from_wire(d: dict, shard_id: int):
    from ..ranking.pipeline.block import CandidateBlock

    n = len(d["doc"])
    b = CandidateBlock(
        shard=np.full(n, shard_id, dtype=np.int32),
        segment=np.asarray(d["segment"], dtype=np.int32),
        doc=np.asarray(d["doc"], dtype=np.int64),
        score=np.asarray(d["score"], dtype=np.float32),
        dedup={k: np.asarray(v, dtype=np.int64) for k, v in d["dedup"].items()},
        host_id=np.asarray(d["host_id"], dtype=np.int64),
        signals=None if d.get("signals") is None else np.asarray(d["signals"], np.float32),
        title_emb=None if d.get("title_emb") is None else np.asarray(d["title_emb"], np.float32),
        keyword_emb=None if d.get("keyword_emb") is None else np.asarray(d["keyword_emb"],
                                                                         np.float32),
    )
    if d.get("seg_names") is not None:
        b.seg_names = {shard_id: list(d["seg_names"])}
    b.cols = {k: np.asarray(v) for k, v in (d.get("cols") or {}).items()}
    return b


def resolve_wire_pointers(index, wire_pointers: list):
    """→ (pointers, segments): wire pointers re-resolved against the current
    segment list by segment name. A pointer whose segment is gone resolves
    to None (the caller answers a placeholder, never a wrong doc); nameless
    pointers fall back to raw ordinals."""
    segs = index.segments
    by_name = {s.name: i for i, s in enumerate(segs)}
    ptrs = []
    for p in wire_pointers:
        nm = p.get("seg")
        if nm is not None:
            ord_ = by_name.get(nm)
        else:
            ord_ = p["segment"] if p["segment"] < len(segs) else None
        ptrs.append(None if ord_ is None else DocPointer(ord_, p["doc"]))
    return ptrs, segs


def resolve_search_mesh(mesh, index):
    """mesh="auto": a mesh over every card when this process sees at least
    two and the index's segments fit one per card; None, "off", "" or fewer
    cards → None (the per-segment path). A Mesh instance passes through, so
    a mesh of several shards on one card is built with the Python API."""
    if mesh in (None, "off", ""):
        return None
    if mesh == "auto":
        import torch

        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < 2:
            return None
        n_seg = sum(1 for s in index.segments if s.num_docs > 0)
        if not (0 < n_seg <= count):
            return None
        from ..parallel.mesh import Mesh

        return Mesh([torch.device("cuda", i) for i in range(count)], axis_names=("x",))
    return mesh


class SearchService:
    def __init__(self, index: InvertedIndex, shard_id: int = 0, linear_model=None,
                 batching: bool = True, mesh=None):
        # eager signals: shard servers send candidates with their rows, and
        # one batched pass 2 here is cheaper than a pass per query later
        self.searcher = LocalSearcher(index, shard_id=shard_id, linear_model=linear_model,
                                      lazy_signals=False,
                                      mesh=resolve_search_mesh(mesh, index))
        if batching:
            from ..searcher.batcher import QueryBatcher

            self.searcher.batcher = QueryBatcher(self.searcher)
        self.shard_id = shard_id

    # -- RPC methods ------------------------------------------------------------
    def search(self, body: dict) -> dict:
        sq = SearchQuery.from_json(body)
        candidates, count = self.searcher.search_initial(sq)
        return {"candidates": [candidate_to_wire(c) for c in candidates], "count": count.to_json()}

    def search_batch(self, body: dict) -> list:
        """A coordinator batch in one RPC (the batched shard flow, no
        micro-batch window)."""
        sqs = [SearchQuery.from_json(b) for b in body["queries"]]
        results = self.searcher.search_initial_many(sqs)
        return [
            {"candidates": [candidate_to_wire(c) for c in cands], "count": count.to_json()}
            for cands, count in results
        ]

    def search_block_batch(self, body: dict) -> list:
        """search_batch with each query's candidates as one packed block."""
        sqs = [SearchQuery.from_json(b) for b in body["queries"]]
        from ..ranking.pipeline import NUM_PIPELINE_RANKING_RESULTS

        mc = int(body.get("max_candidates") or NUM_PIPELINE_RANKING_RESULTS)
        results = self.searcher.search_blocks_many(sqs, mc)
        return [
            {"block": block_to_wire(block, self.shard_id), "count": count.to_json()}
            for block, count in results
        ]

    def retrieve(self, body: dict) -> list:
        sq = SearchQuery.from_json(body["query"])
        ptrs, segs = resolve_wire_pointers(self.searcher.index, body["pointers"])
        live = [p for p in ptrs if p is not None]
        docs = iter(self.searcher.retrieve(sq, live, segments=segs))
        return [(next(docs) if p is not None else {}) for p in ptrs]

    def size(self, body=None) -> dict:
        return {"num_docs": self.searcher.index.num_docs}

    def _lookup(self, field: str, value: str) -> dict | None:
        from ..schema import text_field
        from ..utils.hashing import term_hash

        th = term_hash(text_field(field).id, value.strip().lower())
        for ord_, seg in enumerate(self.searcher.index.segments):
            docs, _ = seg.postings(th)
            if len(docs):
                return self.searcher.index.retrieve([DocPointer(ord_, int(docs[0]))])[0]
        return None

    def get_webpage(self, body: dict) -> dict | None:
        """Exact-url lookup through the url_no_tokenizer posting list."""
        return self._lookup("url_no_tokenizer", body["url"])

    def get_homepage(self, body: dict) -> dict | None:
        return self._lookup("site_if_homepage_no_tokenizer", body["site"])


def run(index_path: str, shard_id: int, host: str = "127.0.0.1", port: int = 0,
        gossip_addr=("127.0.0.1", 0), gossip_seeds=(), linear_model_path: str = "",
        mesh="auto", device="cuda"):
    """Start a search shard on `device`: the RPC server and its gossip
    membership → (server, cluster). A linear_model_path (LinearRegression
    JSON, either package's) adds the model's predictions to the shard's
    scores."""
    index = InvertedIndex(index_path, device)
    for seg in index.segments:
        index.device_segment_for(seg)  # upload before the first request
    linear_model = None
    if linear_model_path:
        from ..ranking.models.linear import LinearRegression

        with open(linear_model_path) as f:
            linear_model = LinearRegression.from_json(f.read())
    service = SearchService(index, shard_id=shard_id, linear_model=linear_model, mesh=mesh)
    server = serve_in_thread(service, host, port)
    cluster = Cluster.join(
        Service("search-server", host=server.addr, shard=shard_id),
        gossip_addr=gossip_addr,
        seeds=gossip_seeds,
    )
    return server, cluster
