"""Term frequency dictionaries for spell correction (the port's copy of
stract_tpu/spell/term_freqs.py; role of reference
crates/web-spell/src/term_freqs.rs)."""

from __future__ import annotations

import os
from collections import Counter

import msgpack

from ..tokenizer import tokenize


class TermFreqs:
    def __init__(self, counts: Counter | None = None):
        self.counts: Counter = counts or Counter()
        self.total = sum(self.counts.values())

    def observe_text(self, text: str) -> None:
        toks = tokenize(text)
        self.counts.update(toks)
        self.total += len(toks)

    def freq(self, term: str) -> int:
        return self.counts.get(term, 0)

    def prob(self, term: str) -> float:
        return self.counts.get(term, 0) / max(self.total, 1)

    def vocab(self):
        return self.counts.keys()

    def merge(self, other: "TermFreqs") -> None:
        self.counts.update(other.counts)
        self.total += other.total

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as fh:
            fh.write(msgpack.packb(dict(self.counts), use_bin_type=True))

    @classmethod
    def load(cls, path: str) -> "TermFreqs":
        with open(path, "rb") as fh:
            return cls(Counter(msgpack.unpackb(fh.read(), raw=False)))
