"""Cross-encoder reranker — the port of
stract_tpu/ranking/models/cross_encoder.py (role of reference
ranking/models/cross_encoder.rs:35-90: BERT + linear classifier over
(query, snippet/title) pairs, 128-token truncation).

The precision stage scores ~20 pages x 2 pairs per query; the coordinator
batches every query's pairs of a request batch into one bucketed forward."""

from __future__ import annotations

import numpy as np
import torch

from ...models.bert import BertConfig, BertForSequenceScore, random_init
from ...models.dual_encoder import batch_bucket, to_device
from ...models.wordpiece import WordPieceTokenizer, trim_to_bucket

MAX_TOKENS = 128  # reference cross_encoder.rs:30


class CrossEncoderModel:
    def __init__(self, cfg: BertConfig, model: BertForSequenceScore,
                 tokenizer: WordPieceTokenizer, max_len: int = MAX_TOKENS):
        self.cfg = cfg
        self.model = model.eval()
        self.tokenizer = tokenizer
        self.max_len = max_len

    @property
    def device(self) -> torch.device:
        return self.model.score.weight.device

    @classmethod
    def random_init(cls, cfg: BertConfig | None = None,
                    tokenizer: WordPieceTokenizer | None = None, seed: int = 0,
                    device="cuda") -> "CrossEncoderModel":
        cfg = cfg or BertConfig.tiny()
        tokenizer = tokenizer or WordPieceTokenizer.build(["the quick brown fox"],
                                                          vocab_size=cfg.vocab_size)
        model = random_init(BertForSequenceScore(cfg), seed).to(device)
        return cls(cfg, model, tokenizer, max_len=min(MAX_TOKENS, cfg.max_position_embeddings))

    @classmethod
    def from_masters(cls, cfg: BertConfig, model: BertForSequenceScore,
                     tokenizer: WordPieceTokenizer,
                     max_len: int = MAX_TOKENS) -> "CrossEncoderModel":
        """A trained cross encoder holding f32 masters (see
        DualEncoder.from_masters): scores as it is, saves the masters."""
        if model.bert.word_embeddings.weight.dtype != torch.float32:
            raise ValueError("from_masters takes a model holding f32 masters")
        return cls(cfg, model, tokenizer, max_len=max_len)

    def save(self, path: str) -> None:
        from ...models.store import save_encoder

        save_encoder(path, self.cfg, self.model.state_dict(), self.tokenizer, self.max_len,
                     "cross")

    @classmethod
    def load(cls, path: str, device="cuda") -> "CrossEncoderModel":
        """From a native checkpoint dir (either package's) or an HF
        safetensors dir."""
        from ...models.store import load_encoder

        cfg, sd, tok, max_len = load_encoder(path, "cross")
        model = BertForSequenceScore(cfg)
        model.load_state_dict(sd)
        return cls(cfg, model.to(device), tok, max_len=min(MAX_TOKENS, max_len))

    def score(self, query: str, texts: list[str]) -> np.ndarray:
        """Sigmoid relevance of (query, text) pairs → f32[len(texts)]."""
        return self.score_pairs([(query, t) for t in texts])

    def score_pairs(self, pairs: list) -> np.ndarray:
        """Sigmoid relevance of (query, text) pairs in one bucketed forward:
        pairs padded with ("", "") to the batch bucket, tokens cut to the
        smallest sequence bucket; the sigmoid follows the f32 score head."""
        if not pairs:
            return np.zeros(0, dtype=np.float32)
        padded = list(pairs) + [("", "")] * (batch_bucket(len(pairs)) - len(pairs))
        ids, mask, types = trim_to_bucket(*self.tokenizer.encode_batch(padded, self.max_len))
        with torch.inference_mode():
            logits = self.model(*to_device(ids, mask, types, self.device))
            return torch.sigmoid(logits[: len(pairs)]).cpu().numpy()
