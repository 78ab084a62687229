"""Recall stage (role of reference ranking/pipeline/stages/recall.rs:304):
re-rank the merged top-300 with
  - dual-encoder embedding similarity (Title/Keyword embeddings as one batched
    matmul on device — reference pipeline/scorers/embedding.rs dot-products)
  - LambdaMART over the signal feature matrix (tensorized forest, one jit call)
  - inbound-similarity modifier (bitvec cosine over backlink host sets)
then score = Σ coefficients × signals.
"""

from __future__ import annotations

import numpy as np

from .. import signals as S


class RecallStage:
    def __init__(self, lambdamart=None, dual_encoder=None, inbound_similarity=None):
        self.lambdamart = lambdamart
        self.dual_encoder = dual_encoder
        self.inbound = inbound_similarity

    @property
    def has_scorers(self) -> bool:
        return (self.dual_encoder is not None or self.inbound is not None
                or self.lambdamart is not None)

    def apply(self, ctx, candidates: list) -> list:
        return self.apply_many([(ctx, candidates)])[0]

    def apply_many(self, items: list) -> list:
        """Batched recall over a request batch: ONE dual-encoder forward for
        all query embeddings, one LambdaMART predict over the stacked feature
        matrices (per-query model dispatches each cost a device round trip).
        items: [(ctx, candidates)]."""
        todo = []
        out = [None] * len(items)
        for qi, (ctx, candidates) in enumerate(items):
            if not candidates:
                out[qi] = candidates
            elif not self.has_scorers and any(c.signals is None for c in candidates):
                # lazy-signal fast path: nothing modifies signals, and the
                # device pass already fused coefficients × signals into each
                # score — rescoring would just recompute the same number
                candidates.sort(key=lambda c: -c.score)
                out[qi] = candidates
            else:
                todo.append(qi)
        if not todo:
            return out

        # Embedding similarity: batch the query-side embeds, then one
        # [K, H] @ [H] matmul per (query, embedding field).
        if self.dual_encoder is not None:
            qembs = self.dual_encoder.embed([items[qi][0].raw for qi in todo])
            for qemb, qi in zip(qembs, todo):
                ctx, candidates = items[qi]
                for key, sig in (
                    ("title_embedding", S.TITLE_EMBEDDING_SIMILARITY),
                    ("keyword_embedding", S.KEYWORD_EMBEDDING_SIMILARITY),
                ):
                    mats = [getattr(c, key) for c in candidates]
                    if all(m is not None for m in mats):
                        M = np.stack(mats).astype(np.float32)
                        norms = np.linalg.norm(M, axis=1)
                        sims = np.where(norms > 1e-6, (M @ qemb) / np.maximum(norms, 1e-6), 0.0)
                        for c, v in zip(candidates, sims):
                            c.set_signal(sig, float(v))

        # Inbound similarity vs each query's liked/disliked hosts.
        if self.inbound is not None:
            for qi in todo:
                ctx, candidates = items[qi]
                host_ids = [c.host_id for c in candidates]
                sims = self.inbound.score(getattr(ctx, "host_rankings", None), host_ids)
                for c, v in zip(candidates, sims):
                    c.set_signal(S.INBOUND_SIMILARITY, float(v))

        # LambdaMART over the stacked signal matrices (one predict).
        if self.lambdamart is not None:
            all_c = [c for qi in todo for c in items[qi][1]]
            feats = np.stack([c.signals for c in all_c])
            preds = self.lambdamart.predict(feats)
            for c, v in zip(all_c, preds):
                c.set_signal(S.LAMBDA_MART, float(v))

        for qi in todo:
            ctx, candidates = items[qi]
            rescore(ctx, candidates)
            candidates.sort(key=lambda c: -c.score)
            out[qi] = candidates
        return out

    def apply_many_blocks(self, items: list, qembs=None) -> list:
        """Array-carried variant: items = [(ctx, CandidateBlock)] → ranked
        blocks. Same batching as apply_many, but every signal write is a
        column assignment instead of a per-candidate set_signal loop.
        qembs: optional prefetched f32[len(items), H] query embeddings (the
        coordinator dispatches the dual-encoder forward during phase 1)."""
        todo = []
        out = [None] * len(items)
        for qi, (ctx, block) in enumerate(items):
            if len(block) == 0:
                out[qi] = block
            elif not self.has_scorers and block.signals is None:
                # lazy-signal fast path: the device already fused
                # coefficients × signals into each score — only the recall
                # slop signals (host-computed, stages/recall.rs:311-312) are
                # missing from it
                delta = block.slop_score_delta(ctx.coeff)
                if delta is not None:
                    block.score = block.score + delta.astype(np.float32)
                out[qi] = block.sort_desc()
            else:
                todo.append(qi)
        if not todo:
            return out

        if self.dual_encoder is not None:
            if qembs is None:
                todo_embs = self.dual_encoder.embed([items[qi][0].raw for qi in todo])
            else:
                todo_embs = np.asarray(qembs)[todo]
            for qemb, qi in zip(todo_embs, todo):
                block = items[qi][1]
                for mat, sig in ((block.title_emb, S.TITLE_EMBEDDING_SIMILARITY),
                                 (block.keyword_emb, S.KEYWORD_EMBEDDING_SIMILARITY)):
                    if mat is not None and block.signals is not None:
                        M = mat.astype(np.float32, copy=False)
                        norms = np.linalg.norm(M, axis=1)
                        sims = np.where(norms > 1e-6, (M @ qemb) / np.maximum(norms, 1e-6), 0.0)
                        block.signals[:, sig.id] = sims

        if self.inbound is not None:
            for qi in todo:
                ctx, block = items[qi]
                sims = self.inbound.score(getattr(ctx, "host_rankings", None),
                                          block.host_id.tolist())
                block.signals[:, S.INBOUND_SIMILARITY.id] = np.asarray(sims, np.float32)

        for qi in todo:
            items[qi][1].fill_slop_signals()  # recall term-distance into the matrix

        # LambdaMART AFTER every other recall signal is in the matrix (slop,
        # embedding sims): its features must match the vectors ltr training
        # collects from served results (training_data.py joins judgments with
        # FINAL signal vectors — predicting on a pre-slop matrix would skew
        # every tree split trained on those columns)
        if self.lambdamart is not None:
            feats = np.concatenate([items[qi][1].signals for qi in todo])
            preds = np.asarray(self.lambdamart.predict(feats), np.float32)
            off = 0
            for qi in todo:
                block = items[qi][1]
                block.signals[:, S.LAMBDA_MART.id] = preds[off : off + len(block)]
                off += len(block)

        for qi in todo:
            ctx, block = items[qi]
            coeffs = np.array([ctx.coeff(s) for s in S.SIGNALS], dtype=np.float32)
            block.score = block.signals @ coeffs
            out[qi] = block.sort_desc()
        return out


def rescore(ctx, candidates: list) -> None:
    """score = signals @ coefficients for ALL candidates at once (the per-
    candidate recompute_score loop was 14k ctx.coeff() calls per query)."""
    coeffs = np.array([ctx.coeff(s) for s in S.SIGNALS], dtype=np.float32)
    feats = np.stack([c.signals for c in candidates])
    scores = feats @ coeffs
    for c, v in zip(candidates, scores):
        c.score = float(v)
