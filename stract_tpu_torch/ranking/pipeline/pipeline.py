"""Two-stage coordinator ranking pipeline (role of reference
ranking/pipeline/mod.rs:100,136 RankingPipeline<T> stage list):

    merged shard results (≤300, searcher/api/mod.rs:61)
      → RecallStage  (embeddings + lambdamart + inbound sim)
      → top 20 retrieved
      → PrecisionStage (cross-encoders, first 2 pages only)
"""

from __future__ import annotations

from .recall import RecallStage
from .precision import PrecisionStage

NUM_PIPELINE_RANKING_RESULTS = 300  # searcher/api/mod.rs:61
NUM_RESULTS_PER_PAGE = 20           # searcher/mod.rs NUM_RESULTS_PER_PAGE


class RankingPipeline:
    def __init__(self, recall: RecallStage | None = None, precision: PrecisionStage | None = None):
        self.recall = recall or RecallStage()
        self.precision = precision or PrecisionStage()

    def rank_recall(self, ctx, candidates: list) -> list:
        return self.recall.apply(ctx, candidates[:NUM_PIPELINE_RANKING_RESULTS])

    def rank_precision(self, ctx, candidates: list) -> list:
        return self.precision.apply(ctx, candidates)

    # batched variants — the coordinator serves query BATCHES, and each neural
    # model dispatch costs a device round trip: scoring every query's pairs in
    # one forward is the difference between 7 qps and ~10x that with the
    # cross-encoder enabled (measured, docs/perf_notes.md round 3)
    def rank_recall_many(self, items: list) -> list:
        """items: [(ctx, candidates)] → list of ranked candidate lists."""
        return self.recall.apply_many(
            [(ctx, cands[:NUM_PIPELINE_RANKING_RESULTS]) for ctx, cands in items])

    def rank_recall_many_blocks(self, items: list, qembs=None) -> list:
        """items: [(ctx, CandidateBlock)] → list of ranked blocks. qembs:
        optional prefetched query embeddings aligned with items."""
        cut = [(ctx, b.take(slice(0, NUM_PIPELINE_RANKING_RESULTS)) if
                len(b) > NUM_PIPELINE_RANKING_RESULTS else b) for ctx, b in items]
        if qembs is None:  # keep the positional API for stage doubles/subclasses
            return self.recall.apply_many_blocks(cut)
        return self.recall.apply_many_blocks(cut, qembs=qembs)

    def rank_precision_many(self, items: list) -> list:
        return self.precision.apply_many(items)
