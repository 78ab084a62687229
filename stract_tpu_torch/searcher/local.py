"""LocalSearcher — one shard's search (the port of stract_tpu/searcher/local.py,
without the multi-device mesh and the shard-server micro-batcher).

Flow per batch of queries: Query.parse → InvertedIndex.search_arrays_batch
(stages A and B on the device) → phrase filter → host column / embedding
gathers → one array-carried CandidateBlock per query. Signal matrices stay
lazy: the coordinator materialises the final page's rows.
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
    def __init__(self, index: InvertedIndex, shard_id: int = 0):
        self.index = index
        self.shard_id = shard_id

    def parse_query(self, sq: SearchQuery) -> Query:
        if sq.optic or sq.host_rankings is not None:
            # Optic.compile_groups builds the JAX package's constraint groups
            # (it imports stract_tpu.ranking.computer): a later slice
            raise NotImplementedError("optics are not ported yet")
        q = Query.parse(sq.query, coefficients=sq.signal_coefficients,
                        selected_region=sq.selected_region)
        if sq.safe_search:
            q.groups.append(
                TermGroup("nsfw", ["safety_classification"], required=False, excluded=True,
                          scoring=False))
        return q

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

        batch_res = self.index.search_arrays_batch([ctxs[i] for i in live], top_k=max_candidates)
        # every ctx carries the segment-list snapshot its ordinals index
        snap = getattr(ctxs[live[0]], "_segments", None)

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

        flat_segs = np.concatenate([s for _, s, _, _ in per_query])
        flat_docs = np.concatenate([d for _, _, d, _ in per_query])
        t_emb = self.index.gather_embeddings_arr(flat_segs, flat_docs, "title_embeddings",
                                                 segments=snap)
        k_emb = self.index.gather_embeddings_arr(flat_segs, flat_docs, "keyword_embeddings",
                                                 segments=snap)
        cols = self.index.gather_columns_arr(flat_segs, flat_docs,
                                             DEDUP_COLUMNS + ["host_node_id"], segments=snap)

        off = 0
        for i, segs_a, docs_a, scores_a in per_query:
            n = len(docs_a)
            sl = slice(off, off + n)
            off += n
            block = CandidateBlock(
                shard=np.full(n, self.shard_id, dtype=np.int32),
                segment=segs_a.astype(np.int32, copy=False),
                doc=docs_a.astype(np.int64, copy=False),
                score=scores_a.astype(np.float32, copy=False),
                dedup={name: cols[name][sl] for name in DEDUP_COLUMNS},
                host_id=cols["host_node_id"][sl],
                title_emb=t_emb[sl] if t_emb is not None else None,
                keyword_emb=k_emb[sl] if k_emb is not None else None,
                # the search-time ctx: page materialisation reuses its caches
                # (slots, stage-B factor columns, fused signal rows)
                ctxs={self.shard_id: ctxs[i]},
            )
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

    def retrieve(self, sq: SearchQuery, pointers: list, segments: list | None = None) -> list:
        q = self.parse_query(sq)
        return self.index.retrieve(pointers, q.simple_terms, segments=segments)
