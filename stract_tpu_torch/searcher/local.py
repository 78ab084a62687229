"""LocalSearcher — one shard's search (the port of stract_tpu/searcher/local.py).

Flow per batch of queries: Query.parse → pass 1 (InvertedIndex.
search_arrays_batch: stages A and B per segment on the device; or, with a
mesh of more than one entry, parallel/search.py MeshShardedSearcher: the
segments one per mesh entry, one two-stage program per query shape and the
mesh merge) → phrase filter → pass 2 (the signal rows; skipped in lazy mode,
where the coordinator materialises the final page's rows) → host column /
embedding gathers → one array-carried CandidateBlock per query.

A request's optic (SearchQuery.optic, host_rankings) is parsed into the
query: Optic.compile_groups lowers its Site, Domain and Url rules and its
blocked hosts into constraint groups of the device plan, so stages A and B
and pass 2 take them as posting slots; the residual runs at the
coordinator. A linear model (the shard servers' linear_model_path) turns
lazy mode off, so pass 2 runs over every query's candidates at search
time, and adds predict(signal rows) to each candidate's score.
"""

from __future__ import annotations

import numpy as np

from ..collector import ApproxCount
from ..index.inverted import InvertedIndex
from ..query.query import Query
from ..ranking.pipeline import NUM_PIPELINE_RANKING_RESULTS
from ..ranking.computer import TermGroup
from .query import SearchQuery

DEDUP_COLUMNS = [
    "url_without_query_hash1",
    "url_without_query_hash2",
    "title_hash1",
    "site_hash1",
    "sim_hash",
]


class LocalSearcher:
    def __init__(self, index: InvertedIndex, shard_id: int = 0, linear_model=None,
                 batcher=None, lazy_signals: bool = True, mesh=None):
        self.index = index
        self.shard_id = shard_id
        self.linear_model = linear_model
        self.batcher = batcher  # searcher/batcher.py QueryBatcher (shard servers)
        # with a mesh of more than one entry the index's segments are spread one
        # per entry and pass 1 runs the sharded two-stage program
        self._sharded = None
        if mesh is not None and int(mesh.devices.size) > 1:
            from ..parallel.search import MeshShardedSearcher

            self._sharded = MeshShardedSearcher(index, mesh)
        # lazy: no pass-2 signal rows at search time; the coordinator
        # materialises the final page's (materialize_signals). Shard servers
        # build with lazy_signals=False: their candidates cross sonic with
        # their rows, and one batched pass 2 here is cheaper than a pass per
        # query later. A linear model reads every candidate's rows.
        self.lazy_signals = lazy_signals and linear_model is None

    def parse_query(self, sq: SearchQuery) -> Query:
        optic = None
        if sq.optic:
            from ..optics import Optic

            optic = Optic.parse(sq.optic)
        q = Query.parse(sq.query, coefficients=sq.signal_coefficients,
                        selected_region=sq.selected_region, optic=optic)
        if sq.safe_search:
            q.groups.append(
                TermGroup("nsfw", ["safety_classification"], required=False, excluded=True,
                          scoring=False))
        if sq.host_rankings is not None:
            q.host_rankings = sq.host_rankings
        return q

    def search_initial(self, sq: SearchQuery, max_candidates: int = NUM_PIPELINE_RANKING_RESULTS):
        """→ (candidates: list[RankedCandidate], count: ApproxCount)."""
        if self.batcher is not None:
            return self.batcher.search_initial(sq, max_candidates)
        return self.search_initial_many([sq], max_candidates)[0]

    def search_initial_many(self, sqs: list, max_candidates: int = NUM_PIPELINE_RANKING_RESULTS):
        """search_blocks_many with per-result objects → list of (candidates,
        count)."""
        return [(block.to_candidates(), count)
                for block, count in self.search_blocks_many(sqs, max_candidates)]

    def search_blocks_many(self, sqs: list, max_candidates: int = NUM_PIPELINE_RANKING_RESULTS):
        """Shard-side flow for a batch of queries → list of (CandidateBlock,
        ApproxCount) aligned with sqs."""
        from ..ranking.pipeline.block import CandidateBlock

        qs = [self.parse_query(sq) for sq in sqs]
        ctxs = [q.context() for q in qs]
        out: list = [None] * len(sqs)
        live = [i for i, q in enumerate(qs) if not q.is_empty()]
        for i, q in enumerate(qs):
            if q.is_empty():
                out[i] = (CandidateBlock.empty(), ApproxCount(0, True))
        if not live:
            return out

        if self._sharded is not None:
            batch_res = []
            for ptrs, scores in self._sharded.search_batch([ctxs[i] for i in live],
                                                           top_k=max_candidates):
                n = len(ptrs)
                batch_res.append((np.fromiter((p.segment for p in ptrs), np.int32, n),
                                  np.fromiter((p.doc for p in ptrs), np.int64, n),
                                  np.asarray(scores, dtype=np.float32)))
        else:
            batch_res = self.index.search_arrays_batch([ctxs[i] for i in live],
                                                       top_k=max_candidates)
        # every ctx carries the segment-list snapshot its ordinals index
        snap = getattr(ctxs[live[0]], "_segments", None)
        seg_names = [s.name for s in snap] if snap is not None else None

        per_query: list = []
        counts: dict = {}
        for j, i in enumerate(live):
            segs_a, docs_a, scores_a = batch_res[j]
            if qs[i].phrases or qs[i].field_phrases:
                keep = self.index.filter_phrases_arr(
                    segs_a, docs_a, qs[i].phrases, segments=snap,
                    field_phrases=qs[i].field_phrases)
                segs_a, docs_a, scores_a = segs_a[keep], docs_a[keep], scores_a[keep]
            n_found = len(docs_a)
            if n_found >= max_candidates:
                counts[i] = ApproxCount(max(self.index.estimate_count(ctxs[i]), n_found), False)
            else:
                counts[i] = ApproxCount(n_found, True)
            per_query.append((i, segs_a, docs_a, scores_a))

        # pass 2, batched across queries (skipped in lazy mode)
        if self.lazy_signals:
            sigs = [None] * len(per_query)
        else:
            sigs = self.index.compute_signals_arrays_many(
                [(ctxs[i], segs_a, docs_a) for i, segs_a, docs_a, _ in per_query])

        flat_segs = np.concatenate([s for _, s, _, _ in per_query])
        flat_docs = np.concatenate([d for _, _, d, _ in per_query])
        t_emb = self.index.gather_embeddings_arr(flat_segs, flat_docs, "title_embeddings",
                                                 segments=snap)
        k_emb = self.index.gather_embeddings_arr(flat_segs, flat_docs, "keyword_embeddings",
                                                 segments=snap)
        cols = self.index.gather_columns_arr(flat_segs, flat_docs,
                                             DEDUP_COLUMNS + ["host_node_id"], segments=snap)

        off = 0
        for (i, segs_a, docs_a, scores_a), sig in zip(per_query, sigs):
            n = len(docs_a)
            sl = slice(off, off + n)
            off += n
            scores = scores_a.astype(np.float32, copy=False)
            if self.linear_model is not None and n:
                scores = scores + np.asarray(self.linear_model.predict(sig), dtype=np.float32)
            block = CandidateBlock(
                shard=np.full(n, self.shard_id, dtype=np.int32),
                segment=segs_a.astype(np.int32, copy=False),
                doc=docs_a.astype(np.int64, copy=False),
                score=scores,
                dedup={name: cols[name][sl] for name in DEDUP_COLUMNS},
                host_id=cols["host_node_id"][sl],
                signals=sig,
                title_emb=t_emb[sl] if t_emb is not None else None,
                keyword_emb=k_emb[sl] if k_emb is not None else None,
                # the search-time ctx: page materialisation reuses its caches
                # (slots, stage-B factor columns, fused signal rows)
                ctxs={self.shard_id: ctxs[i]},
            )
            if seg_names is not None:
                block.seg_names = {self.shard_id: seg_names}
            block.cols.update(self._slop_columns(ctxs[i], segs_a, docs_a, snap))
            out[i] = (block, counts[i])
        return out

    def _slop_columns(self, ctx, seg_arr, doc_arr, snap) -> dict:
        """Recall-stage term-distance values from stored positions:
        {'title_slop', 'body_slop'} f64[N]."""
        from ..ranking.term_distance import SLOP_MAX, min_slop_block
        from ..schema import text_field
        from ..tokenizer import get_tokenizer
        from ..utils.hashing import term_hash

        n = len(doc_arr)
        terms = getattr(ctx, "simple_terms", None) or []
        tokens = (get_tokenizer("default").tokenize(" ".join(terms))
                  if len(terms) >= 2 else [])
        out = {"title_slop": np.full(n, SLOP_MAX), "body_slop": np.full(n, SLOP_MAX)}
        if len(tokens) < 2 or n == 0:
            return out
        segs = snap if snap is not None else self.index.segments
        for name, fname in (("title_slop", "title"), ("body_slop", "clean_body")):
            fid = text_field(fname).id
            for ord_ in np.unique(seg_arr):
                rows = np.nonzero(seg_arr == ord_)[0]
                out[name][rows] = min_slop_block(
                    segs[int(ord_)], fid, tokens, doc_arr[rows], term_hash)
        return out

    def materialize_signals(self, sq: SearchQuery, candidates: list) -> None:
        """Fill `signals` of lazily built candidates (pass 2 over just these
        pointers)."""
        self.materialize_signals_many([(sq, candidates)])

    def materialize_signals_many(self, items: list) -> None:
        """items = [(sq, candidates)]: one pass 2 across all queries; the
        search-time ctx the candidates carry is reused (its caches turn the
        factor fill into a gather)."""
        todo = []
        for sq, candidates in items:
            cands = [c for c in candidates if c.signals is None]
            if cands:
                ctx = getattr(cands[0], "_ctx", None)
                if ctx is None:
                    ctx = self.parse_query(sq).context()
                todo.append((ctx, cands))
        if not todo:
            return
        sigs = self.index.compute_signals_batch_many(
            [(ctx, [c.pointer for c in cands]) for ctx, cands in todo])
        for (_, cands), sig in zip(todo, sigs):
            for i, c in enumerate(cands):
                c.signals = sig[i]

    def retrieve(self, sq: SearchQuery, pointers: list, segments: list | None = None) -> list:
        q = self.parse_query(sq)
        return self.index.retrieve(pointers, q.simple_terms, segments=segments)

    def search(self, sq: SearchQuery) -> dict:
        """Single-shard end-to-end search (no coordinator pipeline)."""
        candidates, count = self.search_initial(sq)
        page = candidates[sq.offset() : sq.offset() + sq.num_results]
        snap = getattr(getattr(page[0], "_ctx", None), "_segments", None) if page else None
        docs = self.retrieve(sq, [c.pointer for c in page], segments=snap)
        for c, d in zip(page, docs):
            c.retrieved = d
        return {
            "webpages": [
                {**(c.retrieved or {}), "score": c.score, "shard": c.shard}
                for c in page
            ],
            "num_hits": count.to_json(),
        }
