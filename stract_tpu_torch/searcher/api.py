"""ApiSearcher — the coordinator's search flow (the port of
stract_tpu/searcher/api.py: bangs, batched shard fan-out, cross-shard merge,
the optics residual, recall stage, page signals, retrieve + snippets,
precision stage) and the page's side answers (spell correction, widgets,
the sidebar). The ranking pipeline is this package's copy of the JAX
package's host code; it takes the port's models duck-typed (dual encoder
`embed`, cross encoder `score_pairs`, forest `predict`). Without models its
stages are the linear rescoring and the slop signals.

An optic's Site, Domain and Url rules reach the shards as constraint groups
of their device plans (Query.parse → Optic.compile_groups); what is left,
the residual (boosts, content and schema patterns, discards that do not
compile), runs here after the merge, over the candidates' retrieved fields.
The sidebar is the entity sidebar first (a SidebarManager over a local entity
index, or a RemoteSidebarManager over gossip-found entity-search servers),
else the StackOverflow optic search, through the same block path and
residual.

search_websites is the object path for single-query callers: the shards'
candidates as objects (search_initial: K1, K2 on the card) through a
BucketCollector merge, then search_phase2's stages for a batch of one, the
lazy signal rows from ensure_signals_many (K3: the shard's pass 2)."""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from ..bangs import Bangs
from ..collector import BucketCollector
from ..ranking import signals as S
from ..ranking.pipeline import NUM_PIPELINE_RANKING_RESULTS, RankingPipeline
from ..ranking.pipeline.block import CandidateBlock, merge_blocks

from ..query.query import Query
from .query import SearchQuery

MAX_PRECISION_PAGE = 2  # precision rerank only for the first pages
# deep-paging cutoff: approximate offsets, no recall/precision ranking
MAX_APPROX_CANDIDATES = 4096


@dataclass
class WebsitesResult:
    webpages: list
    num_hits: dict
    search_duration_ms: float = 0.0
    has_more_results: bool = False

    def to_json(self):
        return {
            "type": "websites",
            "webpages": self.webpages,
            "numHits": self.num_hits,
            "searchDurationMs": self.search_duration_ms,
            "hasMoreResults": self.has_more_results,
        }


@dataclass
class BangResult:
    redirect_to: str

    def to_json(self):
        return {"type": "bang", "redirectTo": self.redirect_to}


class ApiSearcher:
    def __init__(self, distributed_searcher, pipeline: RankingPipeline | None = None,
                 bangs: Bangs | None = None, spell_checker=None, widget_manager=None,
                 sidebar_manager=None):
        self.searcher = distributed_searcher
        self.pipeline = pipeline or RankingPipeline()
        self.bangs = bangs or Bangs.builtin()
        self.spell_checker = spell_checker
        self.widgets = widget_manager
        self.sidebar = sidebar_manager

    def search(self, sq: SearchQuery):
        return self.search_many([sq])[0]

    def search_many(self, sqs: list) -> list:
        return self.search_phase2(self.search_phase1(sqs))

    def search_phase1(self, sqs: list):
        """Parse, bang short-circuit, batched shard fan-out (device work)."""
        t0 = time.perf_counter()
        results: list = [None] * len(sqs)
        live: list = []
        parsed: list = []
        for i, sq in enumerate(sqs):
            q = Query.parse(sq.query, coefficients=sq.signal_coefficients,
                            selected_region=sq.selected_region)
            hit = self.bangs.get(q) if q.bangs else None
            if hit is not None:
                results[i] = BangResult(hit.redirect_to)
            elif sq.offset() + sq.num_results > NUM_PIPELINE_RANKING_RESULTS:
                results[i] = self.search_websites_approx_offsets(sq)
            else:
                live.append(i)
                parsed.append(q)
        shard_res, qemb_fetch = [], None
        if live:
            # the query-side dual-encoder forward is queued first, so it runs
            # on the device behind the shard fan-out below; phase 2 (another
            # thread) fetches it
            dual = self.pipeline.recall.dual_encoder
            if dual is not None:
                qemb_fetch = dual.embed_async([sqs[i].query for i in live])
            shard_res = self.searcher.search_blocks_many([sqs[i] for i in live])
        return sqs, results, live, parsed, shard_res, t0, qemb_fetch

    def search_phase2(self, state) -> list:
        """Host tail: merge → optics residual → recall (with the prefetched
        query embeddings) → page cut → one batched page-signal
        materialisation → retrieve/snippets → precision."""
        sqs, results, live, parsed, shard_res, t0, qemb_fetch = state
        merged_items = []
        for j, i in enumerate(live):
            ctx, merged, count = self._merge_block(sqs[i], parsed[j], *shard_res[j])
            merged_items.append((i, ctx, merged, count))

        if self.pipeline.recall.has_scorers:
            self._ensure_blocks([(sqs[i], merged) for i, _, merged, _ in merged_items])
        ranked = self.pipeline.rank_recall_many_blocks(
            [(ctx, merged) for _, ctx, merged, _ in merged_items],
            qembs=qemb_fetch() if qemb_fetch is not None else None)

        staged = []
        for (i, ctx, _, count), block in zip(merged_items, ranked):
            offset = sqs[i].offset()
            page_block = block.take(slice(offset, offset + sqs[i].num_results))
            has_more = len(block) > offset + sqs[i].num_results
            staged.append((i, ctx, page_block, count, has_more))

        self._ensure_blocks([(sqs[i], pb) for i, _, pb, _, _ in staged])
        for _, _, pb, _, _ in staged:
            pb.fill_slop_signals()  # pass 2 does not compute the slop signals
        staged = [(i, ctx, pb.to_candidates(), count, has_more)
                  for i, ctx, pb, count, has_more in staged]
        for i, _, page, _, _ in staged:
            self.searcher.retrieve(sqs[i], [c for c in page if c.retrieved is None])

        prec_items = [(ctx, page) for i, ctx, page, _, _ in staged
                      if sqs[i].page < MAX_PRECISION_PAGE]
        prec_pages = iter(self.pipeline.rank_precision_many(prec_items))
        for i, ctx, page, count, has_more in staged:
            if sqs[i].page < MAX_PRECISION_PAGE:
                page = next(prec_pages)
            res = self._serialize_page(sqs[i], page, count, has_more)
            res.search_duration_ms = (time.perf_counter() - t0) * 1000
            results[i] = res
        return results

    def _merge_block(self, sq: SearchQuery, q: Query, block, count):
        """Array-carried merge → optics residual. Signals may still be lazy:
        the recall and page stages materialise them, batched across
        queries."""
        merged = merge_blocks([block], NUM_PIPELINE_RANKING_RESULTS)
        residual = self._residual(sq)
        if residual is not None:  # it reads retrieved fields: a bridge to objects
            cands = merged.to_candidates()
            self.searcher.retrieve(sq, [c for c in cands if c.retrieved is None])
            kept = residual.apply(cands, self._optic_fields)
            mb = CandidateBlock.from_candidates(kept)
            mb.ctxs, mb.seg_names = merged.ctxs, merged.seg_names
            # the page cut re-materialises these rows: keep the retrieved docs
            # so their snippets are not generated twice
            mb.retrieved_map = {
                (int(c.shard), int(c.pointer.segment), int(c.pointer.doc)): c.retrieved
                for c in kept if c.retrieved is not None}
            merged = mb
        return q.context(), merged, count

    @staticmethod
    def _residual(sq: SearchQuery):
        """The part of the request's optic that the shards' device plans do
        not hold (Optic.compile_groups), or None where there is none."""
        if not sq.optic:
            return None
        from ..optics import Optic

        _, residual = Optic.parse(sq.optic).compile_groups()
        if residual.rules or residual.host_rankings.blocked or residual.discard_non_matching:
            return residual
        return None

    def spell_correction(self, query: str):
        if self.spell_checker is None:
            return None
        return self.spell_checker.correct(query)

    def widget(self, query: str):
        if self.widgets is None:
            return None
        return self.widgets.widget(query)

    # reference searcher/api/stackoverflow.optic + sidebar.rs:109-157
    SO_SIDEBAR_OPTIC = (
        "DiscardNonMatching;\n"
        'Rule { Matches { Domain("stackoverflow.com"), Schema("QAPage"), '
        'Schema("acceptedAnswer") } }'
    )
    # the gate is on a [0, 1] relevance, the fraction of the query's terms in
    # the result's title (the fused score sits far above 1 for any weak match)
    SO_SIDEBAR_THRESHOLD = 0.5

    def sidebar_for(self, query: str):
        """Entity sidebar first, else a StackOverflow accepted-answer sidebar
        (reference sidebar.rs:158-173: an entity above the threshold wins,
        otherwise the stackoverflow-optic search's top result)."""
        if self.sidebar is not None:
            ent = self.sidebar.sidebar(query)
            if ent is not None:
                return ent
        return self.stackoverflow_sidebar(query)

    def stackoverflow_sidebar(self, query: str):
        """Search with the stackoverflow optic; its top result above the
        threshold → {type, title, answer} from its QAPage schema
        (sidebar.rs:109), else None."""
        import json

        from ..prettifier import _answer, _many, _one

        try:
            sq = SearchQuery(query=query, num_results=1, optic=self.SO_SIDEBAR_OPTIC)
            block, count = self.searcher.search_blocks_many([sq])[0]
            # the optic's Schema(...) matchers are residual host filters
            _, merged, _ = self._merge_block(sq, Query.parse(query), block, count)
        except Exception:  # noqa: BLE001 — a sidebar never fails a search
            return None
        if len(merged) == 0:
            return None
        top_block = merged.take(slice(0, 1))
        self._ensure_blocks([(sq, top_block)])
        top = top_block.to_candidates()[0]
        title_cov = float(top.signals[S.TITLE_COVERAGE.id]) if top.signals is not None else 0.0
        if title_cov < self.SO_SIDEBAR_THRESHOLD:
            return None
        if top.retrieved is None:
            self.searcher.retrieve(sq, [top])
        raw = (top.retrieved or {}).get("stored", {}).get("schema_org_json", "")
        try:
            items = json.loads(raw) if raw else []
        except ValueError:
            return None
        qa = next((it for it in items
                   if isinstance(it, dict) and "QAPage" in _many(it.get("@type"))), None)
        question = _one(qa.get("mainEntity")) if qa else None
        if not isinstance(question, dict):
            return None
        title = _one(question.get("name"))
        acc = _one(question.get("acceptedAnswer"))
        answer = _answer(acc, accepted=True) if acc is not None else None
        if not title or answer is None:
            return None
        return {"type": "stackOverflow", "title": str(title), "answer": answer}

    def _ensure_blocks(self, items: list) -> None:
        """Lazy signal rows of blocks, batched across the request batch.
        Shard servers send their rows with the block, so a searcher without
        ensure_blocks_many (DistributedSearcher) has nothing to do."""
        ensure = getattr(self.searcher, "ensure_blocks_many", None)
        if ensure is not None:
            ensure(items)

    def search_websites_approx_offsets(self, sq: SearchQuery) -> WebsitesResult:
        """Deep paging: per-shard offset skip, dedup merge, take num_results,
        retrieve; no recall or precision stages."""
        offset = min(sq.offset(), MAX_APPROX_CANDIDATES)
        mc = min(offset + sq.num_results + 1, MAX_APPROX_CANDIDATES)
        block, count = self.searcher.search_blocks_many([sq], max_candidates=mc)[0]
        parts, has_more = [], False
        for sid in np.unique(block.shard):
            rows = np.nonzero(block.shard == sid)[0]
            parts.append(rows[offset : offset + sq.num_results + 1])
            has_more = has_more or len(rows) > offset + sq.num_results
        cut = block.take(np.concatenate(parts)) if parts else block
        page_block = merge_blocks([cut], sq.num_results).take(slice(0, sq.num_results))
        self._ensure_blocks([(sq, page_block)])
        page_block.fill_slop_signals()
        page = page_block.to_candidates()
        self.searcher.retrieve(sq, [c for c in page if c.retrieved is None])
        return self._serialize_page(sq, page, count, has_more)

    # -- the object path (reference :554-642) -------------------------------------
    def search_websites(self, sq: SearchQuery, q: Query | None = None) -> WebsitesResult:
        """One query through the shard's candidate objects (search_initial),
        as the JAX package's object path. No role calls it yet: its merge
        and residual (_merge_candidates) copy _merge_block's, until its
        first caller, ltr, merges it into the block path (ROADMAP item 3b)."""
        q = q or Query.parse(sq.query, coefficients=sq.signal_coefficients,
                             selected_region=sq.selected_region)
        candidates, count = self.searcher.search_initial(sq)
        return self._finish(sq, q, candidates, count)

    def _finish(self, sq: SearchQuery, q: Query, candidates, count) -> WebsitesResult:
        """search_phase2's stages on candidate objects, a batch of one."""
        ctx, merged, count = self._merge_candidates(sq, q, candidates, count)
        if self.pipeline.recall.has_scorers:
            self._ensure_many([(sq, merged)])
        merged = self.pipeline.rank_recall(ctx, merged)
        page, has_more = self._page_from_ranked(sq, merged)
        self._ensure_many([(sq, page)])
        if sq.page < MAX_PRECISION_PAGE:
            page = self.pipeline.rank_precision(ctx, page)
        return self._serialize_page(sq, page, count, has_more)

    def _merge_candidates(self, sq: SearchQuery, q: Query, candidates, count):
        """Cross-shard merge with dedup (reference combine_results :412-465),
        then the optics residual. Signals may still be lazy."""
        collector = BucketCollector(NUM_PIPELINE_RANKING_RESULTS)
        collector.extend(candidates)
        merged = collector.into_sorted_vec()
        residual = self._residual(sq)
        if residual is not None:
            self.searcher.retrieve(sq, [c for c in merged if c.retrieved is None])
            merged = residual.apply(merged, self._optic_fields)
        return q.context(), merged, count

    def _page_from_ranked(self, sq: SearchQuery, merged: list):
        """The page's cut of the ranked candidates, retrieved (stored docs,
        snippets) → (page, has_more)."""
        offset = sq.offset()
        page = merged[offset : offset + sq.num_results]
        has_more = len(merged) > offset + sq.num_results
        self.searcher.retrieve(sq, [c for c in page if c.retrieved is None])
        return page, has_more

    def _ensure_many(self, items: list) -> None:
        """Lazy signal rows of [(sq, candidates)], one pass a shard across the
        items (remote shards send their rows with the candidates)."""
        self.searcher.ensure_signals_many(items)

    def _serialize_page(self, sq: SearchQuery, page, count, has_more) -> WebsitesResult:
        from ..prettifier import rich_snippet

        webpages = []
        for c in page:
            w = dict(c.retrieved or {})
            rich = rich_snippet(w)
            if rich is not None:
                w["richSnippet"] = rich
            w.pop("stored", None)
            w["score"] = c.score
            if sq.return_ranking_signals:
                w["rankingSignals"] = {
                    s.name: float(c.signals[s.id]) for s in S.SIGNALS if c.signals[s.id] != 0
                }
            webpages.append(w)
        return WebsitesResult(webpages=webpages, num_hits=count.to_json(),
                              has_more_results=has_more)

    @staticmethod
    def _optic_fields(c) -> dict:
        """A retrieved candidate's fields by optic match location."""
        d = c.retrieved or {}
        stored = d.get("stored", {})
        return {
            "site": d.get("site", ""),
            "url": d.get("url", ""),
            "domain": d.get("domain", ""),
            "title": d.get("title", ""),
            "description": d.get("description", ""),
            "content": stored.get("clean_text", d.get("snippet", "")),
            "schema": stored.get("schema_org_json", "") or d.get("schema_org_json", ""),
            "microformattag": "",
        }
