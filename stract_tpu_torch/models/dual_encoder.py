"""Dual encoder — mean-pooled BERT sentence embeddings, the port of
stract_tpu/models/dual_encoder.py (role of reference
models/dual_encoder.rs:30-80, 256-token truncation).

The bf16 forward runs on the model's device (K5a-c on a card). Embeddings
are written into the index's dense embedding columns at indexing time
(index/embeddings.py) and compared with the query's in the recall stage
(the JAX package's ranking/pipeline/recall.py)."""

from __future__ import annotations

import numpy as np
import torch

from .bert import BertConfig, BertForEmbedding, random_init
from .wordpiece import WordPieceTokenizer, trim_to_bucket

MAX_TOKENS = 256  # reference dual_encoder.rs:33

_TORCH_DTYPES = {np.dtype(np.float16): torch.float16, np.dtype(np.float32): torch.float32}


def batch_bucket(n: int) -> int:
    """The batch bucket: the smallest power of two >= max(n, 8)."""
    b = 8
    while b < n:
        b *= 2
    return b


def to_device(ids, mask, types, device):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (ids, mask, types))


def fetch_later(out: torch.Tensor):
    """→ a closure that returns `out` as numpy. On a card the copy to the
    host is queued behind the forward on the launching stream and an event
    marks its end, so the closure may run on another thread: it waits on
    that event, not on its own thread's stream."""
    if not out.is_cuda:
        return lambda: out.numpy()
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def fetch():
        done.synchronize()
        return host.numpy()
    return fetch


class DualEncoder:
    def __init__(self, cfg: BertConfig, model: BertForEmbedding, tokenizer: WordPieceTokenizer,
                 max_len: int = MAX_TOKENS):
        self.cfg = cfg
        self.model = model.eval()
        self.tokenizer = tokenizer
        self.max_len = max_len

    @property
    def device(self) -> torch.device:
        return self.model.bert.word_embeddings.weight.device

    @classmethod
    def random_init(cls, cfg: BertConfig | None = None,
                    tokenizer: WordPieceTokenizer | None = None, seed: int = 0,
                    device="cuda") -> "DualEncoder":
        """Random-weight encoder for tests and the smoke run."""
        cfg = cfg or BertConfig.tiny()
        tokenizer = tokenizer or WordPieceTokenizer.build(["the quick brown fox"],
                                                          vocab_size=cfg.vocab_size)
        model = random_init(BertForEmbedding(cfg), seed).to(device)
        return cls(cfg, model, tokenizer, max_len=min(MAX_TOKENS, cfg.max_position_embeddings))

    @classmethod
    def from_masters(cls, cfg: BertConfig, model: BertForEmbedding,
                     tokenizer: WordPieceTokenizer, max_len: int = MAX_TOKENS) -> "DualEncoder":
        """A trained encoder: `model` holds f32 masters (the training form,
        `param_dtype=torch.float32`). It embeds as it is (cast per call: the
        same numbers as the bf16 serving form) and `save` writes the f32
        masters, as the JAX package saves its f32 params."""
        if model.bert.word_embeddings.weight.dtype != torch.float32:
            raise ValueError("from_masters takes a model holding f32 masters")
        return cls(cfg, model, tokenizer, max_len=max_len)

    def save(self, path: str) -> None:
        """The model's parameters as they are held: f32 masters for a trained
        encoder, the bf16 serving weights widened exactly otherwise."""
        from .store import save_encoder

        save_encoder(path, self.cfg, self.model.state_dict(), self.tokenizer, self.max_len, "dual")

    @classmethod
    def load(cls, path: str, device="cuda") -> "DualEncoder":
        """From a native checkpoint dir (either package's) or an HF
        safetensors dir."""
        from .store import load_encoder

        cfg, sd, tok, max_len = load_encoder(path, "dual")
        model = BertForEmbedding(cfg)
        model.load_state_dict(sd)
        return cls(cfg, model.to(device), tok, max_len=min(MAX_TOKENS, max_len))

    @property
    def embedding_dim(self) -> int:
        return self.cfg.hidden_size

    def embed(self, texts: list[str]) -> np.ndarray:
        """→ f32[len(texts), hidden] L2-normalised embeddings."""
        return self.embed_async(texts)()

    def embed_async(self, texts: list[str], out_dtype=None):
        """Queue the forward without waiting for it; → a fetch closure
        yielding [len(texts), hidden] (f32, or `out_dtype` cast on the
        device before the copy to the host). The batch is padded with ""
        to its bucket and cut to the smallest sequence bucket that holds it,
        as the JAX package does."""
        out_dtype = np.dtype(out_dtype or np.float32)
        if not texts:
            return lambda: np.zeros((0, self.cfg.hidden_size), dtype=out_dtype)
        n = len(texts)
        padded = list(texts) + [""] * (batch_bucket(n) - n)
        ids, mask, types = trim_to_bucket(*self.tokenizer.encode_batch(padded, self.max_len))
        with torch.inference_mode():
            out = self.model(*to_device(ids, mask, types, self.device))
            out = out[:n].to(_TORCH_DTYPES[out_dtype])
            return fetch_later(out)
