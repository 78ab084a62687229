"""Candidate record flowing through the ranking pipeline (role of reference
pipeline's LocalRecalledWebpage / PrecisionRankingWebpage)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import signals as S


@dataclass
class RankedCandidate:
    shard: int                 # shard id the doc came from
    pointer: object            # index DocPointer within the shard
    score: float               # current pipeline score
    # f32[NUM_SIGNALS], or None while LAZY: the device already fused the core
    # signals into `score`, so the full matrix is only materialized for
    # candidates a later stage actually inspects (active recall scorers, the
    # precision page, rankingSignals responses) — see searcher ensure_signals.
    signals: np.ndarray | None
    title_embedding: np.ndarray | None = None
    keyword_embedding: np.ndarray | None = None
    dedup: dict = field(default_factory=dict)  # hash columns for BucketCollector
    host_id: int = 0           # HostNodeID for inbound-similarity
    retrieved: dict | None = None  # stored doc + snippet (set by retrieve phase)

    def set_signal(self, sig: S.Signal, value: float) -> None:
        if self.signals is None:
            raise RuntimeError(
                "signals not materialized — call searcher.ensure_signals first")
        self.signals[sig.id] = value

    def recompute_score(self, coeff_fn) -> None:
        """score = Σ coefficient(s) * signal value (reference pipeline scoring)."""
        coeffs = np.array([coeff_fn(s) for s in S.SIGNALS], dtype=np.float32)
        self.score = float(self.signals @ coeffs)
