"""Stupid-backoff n-gram language model (the port's copy of
stract_tpu/spell/stupid_backoff.py; role of reference
crates/web-spell/src/stupid_backoff.rs): score(w | context) backs off from
trigram → bigram → unigram with a 0.4 multiplier per backoff step."""

from __future__ import annotations

import math
import os
from collections import Counter

import msgpack

from ..tokenizer import tokenize

BACKOFF = 0.4


class StupidBackoff:
    def __init__(self):
        self.unigrams: Counter = Counter()
        self.bigrams: Counter = Counter()
        self.trigrams: Counter = Counter()
        self.total = 0

    def observe_text(self, text: str) -> None:
        toks = tokenize(text)
        self.unigrams.update(toks)
        self.total += len(toks)
        self.bigrams.update(zip(toks, toks[1:]))
        self.trigrams.update(zip(toks, toks[1:], toks[2:]))

    def score(self, word: str, context: tuple = ()) -> float:
        """Stupid-backoff probability of `word` after `context` (last ≤2 words)."""
        ctx = tuple(context[-2:])
        if len(ctx) == 2:
            tri = self.trigrams.get((*ctx, word), 0)
            if tri > 0:
                return tri / max(self.bigrams.get(ctx, 1), 1)
            bi = self.bigrams.get((ctx[1], word), 0)
            if bi > 0:
                return BACKOFF * bi / max(self.unigrams.get(ctx[1], 1), 1)
            return BACKOFF * BACKOFF * self.unigrams.get(word, 0) / max(self.total, 1)
        if len(ctx) == 1:
            bi = self.bigrams.get((ctx[0], word), 0)
            if bi > 0:
                return bi / max(self.unigrams.get(ctx[0], 1), 1)
            return BACKOFF * self.unigrams.get(word, 0) / max(self.total, 1)
        return self.unigrams.get(word, 0) / max(self.total, 1)

    def log_score(self, word: str, context: tuple = ()) -> float:
        return math.log(max(self.score(word, context), 1e-12))

    def merge(self, other: "StupidBackoff") -> None:
        self.unigrams.update(other.unigrams)
        self.bigrams.update(other.bigrams)
        self.trigrams.update(other.trigrams)
        self.total += other.total

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        data = {
            "uni": dict(self.unigrams),
            "bi": {" ".join(k): v for k, v in self.bigrams.items()},
            "tri": {" ".join(k): v for k, v in self.trigrams.items()},
            "total": self.total,
        }
        with open(path, "wb") as fh:
            fh.write(msgpack.packb(data, use_bin_type=True))

    @classmethod
    def load(cls, path: str) -> "StupidBackoff":
        with open(path, "rb") as fh:
            data = msgpack.unpackb(fh.read(), raw=False)
        m = cls()
        m.unigrams = Counter(data["uni"])
        m.bigrams = Counter({tuple(k.split(" ")): v for k, v in data["bi"].items()})
        m.trigrams = Counter({tuple(k.split(" ")): v for k, v in data["tri"].items()})
        m.total = data["total"]
        return m
