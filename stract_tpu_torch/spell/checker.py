"""Spell checker (the port's copy of stract_tpu/spell/checker.py; role of reference crates/web-spell/src/lib.rs SpellChecker +
error_model.rs): unknown/rare terms get edit-distance candidates from the
corpus vocabulary, scored by error probability × stupid-backoff LM context."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..tokenizer import tokenize
from .stupid_backoff import StupidBackoff
from .term_freqs import TermFreqs

_ALPHABET = "abcdefghijklmnopqrstuvwxyz"
RARE_THRESHOLD = 2           # terms seen fewer times are correction candidates
CORRECTION_GAIN = 50.0       # uniform-model fallback: candidate must be this much more likely
# reference web-spell/src/config.rs defaults
MISSPELLED_PROB = 0.1
LM_PROB_WEIGHT = 5.77
CORRECTION_THRESHOLD = 6.0   # log2 score diff to accept a correction; the
# reference default (50, tuned for its web-scale LM counts) rejects nearly
# everything on the corpus sizes this engine trains on — threshold is a
# config knob there too (config.rs:26)


@dataclass
class Correction:
    original: str
    corrected: str
    terms: list = field(default_factory=list)  # [(text, corrected: bool)]

    def to_json(self):
        return {
            "original": self.original,
            "corrected": self.corrected,
            "highlighted": [
                {"text": t, "corrected": c} for t, c in self.terms
            ],
        }


def _edits1(word: str):
    splits = [(word[:i], word[i:]) for i in range(len(word) + 1)]
    deletes = (l + r[1:] for l, r in splits if r)
    transposes = (l + r[1] + r[0] + r[2:] for l, r in splits if len(r) > 1)
    replaces = (l + c + r[1:] for l, r in splits if r for c in _ALPHABET)
    inserts = (l + c + r for l, r in splits for c in _ALPHABET)
    return set(deletes) | set(transposes) | set(replaces) | set(inserts)


class SpellChecker:
    def __init__(self, term_freqs: TermFreqs, lm: StupidBackoff | None = None,
                 error_model=None):
        self.freqs = term_freqs
        self.lm = lm
        # trained edit-sequence probabilities (spell/error_model.py, reference
        # error_model.rs) — None falls back to the uniform-edit heuristic
        self.error_model = error_model

    def _candidates(self, word: str) -> set[str]:
        e1 = {w for w in _edits1(word) if self.freqs.freq(w) > RARE_THRESHOLD}
        if e1:
            return e1
        # distance-2 only when nothing at distance 1 (error model: closer is likelier)
        out = set()
        for e in _edits1(word):
            out |= {w for w in _edits1(e) if self.freqs.freq(w) > RARE_THRESHOLD}
            if len(out) > 2000:
                break
        return out

    def _score(self, word: str, context: tuple) -> float:
        if self.lm is not None:
            return self.lm.score(word, context)
        return self.freqs.prob(word)

    def correct_term(self, word: str, context: tuple = ()) -> str | None:
        if self.freqs.freq(word) > RARE_THRESHOLD:
            return None
        if self.error_model is not None:
            return self._correct_term_trained(word, context)
        best, best_score = None, self._score(word, context) * CORRECTION_GAIN
        for cand in self._candidates(word):
            s = self._score(cand, context)
            if s > best_score:
                best, best_score = cand, s
        return best

    def _correct_term_trained(self, word: str, context: tuple) -> str | None:
        """Reference scoring (spell_checker.rs:78-121,156-170):
        score(cand) = lm_prob_weight · log2 P_lm(cand | ctx)
                      + log2(1 − misspelled_prob) + P_err(edit sequence);
        the observed term scores lm_w · log2 P_lm(term) + log2(1 − p_miss);
        accept when the diff clears the correction threshold."""
        import math

        from .error_model import possible_errors

        lg = lambda w: math.log2(max(self._score(w, context), 1e-12))
        orig = LM_PROB_WEIGHT * lg(word) + math.log2(1.0 - MISSPELLED_PROB)
        best, best_score = None, None
        for cand in self._candidates(word):
            if cand == word:
                continue
            seq = possible_errors(word, cand)
            score = (LM_PROB_WEIGHT * lg(cand)
                     + math.log2(1.0 - MISSPELLED_PROB)
                     + (self.error_model.log_prob(seq) if seq else 0.0))
            if best_score is None or score > best_score:
                best, best_score = cand, score
        if best is not None and best_score - orig > CORRECTION_THRESHOLD:
            return best
        return None

    def correct(self, query: str) -> Correction | None:
        """(role of SpellChecker::correct; used by ApiSearcher spell check :340)"""
        terms = tokenize(query)
        if not terms:
            return None
        out_terms = []
        changed = False
        corrected_terms = []
        for i, t in enumerate(terms):
            ctx = tuple(corrected_terms[-2:])
            c = self.correct_term(t, ctx)
            if c is not None and c != t:
                out_terms.append((c, True))
                corrected_terms.append(c)
                changed = True
            else:
                out_terms.append((t, False))
                corrected_terms.append(t)
        if not changed:
            return None
        return Correction(query, " ".join(t for t, _ in out_terms), out_terms)
