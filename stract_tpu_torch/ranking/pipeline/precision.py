"""Precision stage (role of reference ranking/pipeline/stages/precision.rs:114):
cross-encoder BERT rerank of the final page of results — (query, snippet) and
(query, title) pairs, 128-token truncation — plus LambdaMART, then the final
linear combination. Applied to the first pages only (searcher/api/mod.rs:598-614).
"""

from __future__ import annotations

import numpy as np

from .. import signals as S


class PrecisionStage:
    def __init__(self, cross_encoder=None, lambdamart=None):
        self.cross_encoder = cross_encoder
        self.lambdamart = lambdamart

    def apply(self, ctx, candidates: list) -> list:
        return self.apply_many([(ctx, candidates)])[0]

    def apply_many(self, items: list) -> list:
        """Batched precision: ONE cross-encoder forward for every (query,
        title/snippet) pair of the whole request batch, one LambdaMART predict
        over the stacked features — per-query model dispatches cost a device
        round trip each (measured: 7.1 qps with per-query dispatches at
        D=10M/conc=64 vs 63.8 pipeline-off). items: [(ctx, candidates)]."""
        # slop signals: normally computed in the RECALL stage from stored
        # positions for all ~300 candidates (term_distance.py, reference
        # stages/recall.rs:311-312) and carried here in the signal matrix;
        # the retrieved-text estimate remains as a fallback for candidates
        # from legacy paths (old wire peers, object-path bridges)
        from ..proximity import min_slop, slop_score

        for ctx, candidates in items:
            terms = getattr(ctx, "simple_terms", [])
            if not terms:
                continue
            for c in candidates:
                if getattr(c, "_slop_from_positions", False):
                    continue
                d = c.retrieved or {}
                c.set_signal(S.MIN_TITLE_SLOP, slop_score(min_slop(terms, d.get("title", ""))))
                body = d.get("stored", {}).get("clean_text", "") or d.get("snippet", "")
                c.set_signal(S.MIN_CLEAN_BODY_SLOP, slop_score(min_slop(terms, body)))

        if self.cross_encoder is not None:
            pairs, owners = [], []
            for qi, (ctx, candidates) in enumerate(items):
                for c in candidates:
                    d = c.retrieved or {}
                    pairs.append((ctx.raw, d.get("snippet", "") or d.get("description", "")))
                    pairs.append((ctx.raw, d.get("title", "")))
                    owners.append((qi, c))
            scores = self.cross_encoder.score_pairs(pairs)
            for k, (qi, c) in enumerate(owners):
                c.set_signal(S.CROSS_ENCODER_SNIPPET, float(scores[2 * k]))
                c.set_signal(S.CROSS_ENCODER_TITLE, float(scores[2 * k + 1]))

        if self.lambdamart is not None:
            all_c = [c for _, candidates in items for c in candidates]
            if all_c:
                feats = np.stack([c.signals for c in all_c])
                preds = self.lambdamart.predict(feats)
                for c, v in zip(all_c, preds):
                    c.set_signal(S.LAMBDA_MART, float(v))

        from .recall import rescore

        out = []
        for ctx, candidates in items:
            if candidates:
                rescore(ctx, candidates)
                candidates.sort(key=lambda c: -c.score)
            out.append(candidates)
        return out
