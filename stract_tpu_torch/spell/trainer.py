"""Spell-model training from web text (the port's copy of
stract_tpu/spell/trainer.py, which reads an index directory of either
package; role of reference web-spell
FirstTrainer/SecondTrainer + entrypoint/web_spell.rs: first pass counts term
freqs per chunk, second pass merges + builds the LM)."""

from __future__ import annotations

import os

from ..tokenizer import tokenize
from .stupid_backoff import StupidBackoff
from .term_freqs import TermFreqs


class FirstTrainer:
    """Per-chunk pass: term freqs + n-grams from page text."""

    def __init__(self):
        self.freqs = TermFreqs()
        self.lm = StupidBackoff()

    def observe(self, text: str) -> None:
        self.freqs.observe_text(text)
        self.lm.observe_text(text)

    def save(self, dir_path: str, chunk: int) -> None:
        self.freqs.save(os.path.join(dir_path, f"freqs_{chunk:04d}.bin"))
        self.lm.save(os.path.join(dir_path, f"lm_{chunk:04d}.bin"))


class SecondTrainer:
    """Merge pass → final checker artifacts."""

    @staticmethod
    def merge(dir_path: str, out_dir: str) -> None:
        freqs = TermFreqs()
        lm = StupidBackoff()
        for name in sorted(os.listdir(dir_path)):
            p = os.path.join(dir_path, name)
            if name.startswith("freqs_"):
                freqs.merge(TermFreqs.load(p))
            elif name.startswith("lm_"):
                lm.merge(StupidBackoff.load(p))
        os.makedirs(out_dir, exist_ok=True)
        freqs.save(os.path.join(out_dir, "term_freqs.bin"))
        lm.save(os.path.join(out_dir, "lm.bin"))


def train_from_index(index, out_dir: str) -> None:
    """Build spell artifacts from an index's stored docs (role of
    entrypoint/web_spell.rs run): term freqs + LM, then the trained error
    model harvested from the corpus's own likely-misspelling pairs."""
    t = FirstTrainer()
    for seg in index.segments:
        for doc_id in range(seg.num_docs):
            stored = seg.stored_doc(doc_id)
            t.observe(stored.get("title", "") + "\n" + stored.get("clean_text", ""))
    os.makedirs(out_dir, exist_ok=True)
    t.freqs.save(os.path.join(out_dir, "term_freqs.bin"))
    t.lm.save(os.path.join(out_dir, "lm.bin"))
    em = train_error_model(index, t.freqs, t.lm)
    em.save(os.path.join(out_dir, "error_model.json"))


def train_error_model(index, freqs, lm, rare_max: int = 2,
                      min_correction_freq: int = 10, max_contexts: int = 50):
    """Harvest (misspelling → correction) pairs from the corpus itself
    (reference SecondTrainer error-model pass, trainer.rs:120-190): a RARE
    term whose frequent edit-distance-1 neighbor is the most context-probable
    replacement across the rare term's occurrences is counted as an observed
    error; each distinct (term, correction) pair feeds ErrorModel.add — the
    model then knows WHICH character edits real text actually exhibits."""
    from collections import Counter

    from .checker import RARE_THRESHOLD, _edits1
    from .error_model import ErrorModel

    rare_contexts: dict = {}
    for seg in index.segments:
        for doc_id in range(seg.num_docs):
            stored = seg.stored_doc(doc_id)
            toks = tokenize(stored.get("title", "") + "\n" + stored.get("clean_text", ""))
            for k, term in enumerate(toks):
                if (freqs.freq(term) <= rare_max and term.isalpha()
                        and len(term) > 2):
                    ctxs = rare_contexts.setdefault(term, [])
                    if len(ctxs) < max_contexts:
                        ctxs.append((toks[k - 1] if k else "",
                                     toks[k + 1] if k + 1 < len(toks) else ""))

    em = ErrorModel()
    for term, ctxs in rare_contexts.items():
        cands = {w for w in _edits1(term)
                 if freqs.freq(w) >= max(min_correction_freq, RARE_THRESHOLD + 1)}
        if not cands:
            continue
        counts: Counter = Counter()
        for prev, nxt in ctxs:
            best = max(cands, key=lambda c: (
                lm.trigrams.get((prev, c, nxt), 0) * 4
                + lm.bigrams.get((prev, c), 0) + lm.bigrams.get((c, nxt), 0),
                freqs.freq(c), c))
            counts[best] += 1
        # one observation per DISTINCT correction (trainer.rs:177-187 into_keys)
        for cand in counts:
            em.add(term, cand)
    return em


def load_checker(dir_path: str):
    from .checker import SpellChecker
    from .error_model import ErrorModel

    em_path = os.path.join(dir_path, "error_model.json")
    return SpellChecker(
        TermFreqs.load(os.path.join(dir_path, "term_freqs.bin")),
        StupidBackoff.load(os.path.join(dir_path, "lm.bin")),
        error_model=ErrorModel.load(em_path) if os.path.exists(em_path) else None,
    )
