"""Snippet generation (role of reference snippet.rs:150-375).

Same algorithm family as the reference (lucene UnifiedHighlighter style): the
document text is split into sentence passages, each passage is BM25-scored as
a document in the corpus-of-passages, the best passage starts the snippet and
subsequent passages are appended until the configured length window
(desired ± delta chars, config defaults from reference config/defaults.rs:70-84)
is reached. Highlighting runs with plain tokens first and retries with stemmed
tokens when nothing matched (snippet.rs:295-316 snippet_string).

Host-side, string-heavy by nature; stays in the coordinator tail budget via a
word cap (reference configs use max_considered_words = 10_000) and a memoized
token-match cache (body words repeat heavily).
"""

from __future__ import annotations

import functools
import math
import re
from dataclasses import dataclass, field

from .tokenizer import tokenize
from .tokenizer.stemmer import stem


# body words repeat heavily ACROSS documents and requests — cache word-level
# tokenization and stemming at module scope (profile: snippet tokenization was
# ~40% of the coordinator host tail at serving shapes before these caches)
@functools.lru_cache(maxsize=262144)
def _word_tokens(w: str) -> tuple:
    return tuple(tokenize(w))


@functools.lru_cache(maxsize=262144)
def _word_stem(t: str) -> str:
    return stem(t)

MAX_CONSIDERED_WORDS = 10_000
DESIRED_NUM_CHARS = 275
DELTA_NUM_CHARS = 50
MIN_PASSAGE_WIDTH = 20
EMPTY_QUERY_SNIPPET_WORDS = 50
K1 = 1.2
B = 0.75

_SENTENCE_END = re.compile(r"(?<=[.!?\n])\s+")
_ABBREV = ("mr.", "ms.", "dr.")


@dataclass
class TextSnippet:
    fragments: list = field(default_factory=list)  # [(text, is_highlighted)]

    def text(self) -> str:
        return "".join(t for t, _ in self.fragments)

    def html(self) -> str:
        out = []
        for t, hl in self.fragments:
            esc = t.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
            out.append(f"<b>{esc}</b>" if hl else esc)
        return "".join(out)


def sentence_passages(text: str) -> list[str]:
    """Sentence split (role of web-spell sentence_ranges, lib.rs:142: heuristic
    end-of-sentence boundaries, skipping common abbreviations), filtered to
    passages wider than MIN_PASSAGE_WIDTH chars (snippet.rs:157)."""
    parts = []
    buf = ""
    for piece in _SENTENCE_END.split(text):
        buf = f"{buf} {piece}".strip() if buf else piece
        # a split right after an abbreviation is not a sentence boundary
        if buf.lower().rstrip().endswith(_ABBREV):
            continue
        parts.append(buf)
        buf = ""
    if buf:
        parts.append(buf)
    return [p for p in parts if len(p) > MIN_PASSAGE_WIDTH]


def _score_passages(passage_terms: list[dict], qterms: set) -> list[float]:
    """BM25 over the corpus-of-passages (snippet.rs:181-222): idf from
    passage doc frequency, length normalization over DISTINCT term counts."""
    n_p = len(passage_terms)
    idf = {}
    for t in qterms:
        n = sum(1 for d in passage_terms if t in d)
        idf[t] = math.log((n_p - n + 0.5) / (n + 0.5) + 1.0)
    avg_d = max(sum(len(d) for d in passage_terms) // max(n_p, 1), 1)
    scores = []
    for d in passage_terms:
        s = 0.0
        for t in qterms:
            f = float(d.get(t, 0))
            s += idf[t] * (f * (K1 + 1.0)) / (f + K1 * (1.0 - B + B * (len(d) / avg_d)))
        scores.append(s)
    return scores


def _expand_query_terms(query_terms: list[str]) -> tuple[set, set]:
    """→ (plain token set, stemmed token set) of the query."""
    plain = set()
    for term in query_terms:
        plain.update(tokenize(term.lower()))
    return plain, {_word_stem(t) for t in plain}


def _highlight(fragment: str, qset: set, stemmed_q: set | None = None) -> list:
    """Word-level highlight fragments [(text, is_highlighted)] — the plain
    pass marks exact token matches; the stemmed fallback (snippet.rs:295
    snippet_string's second builder) marks stem matches."""
    words = fragment.split()
    cache: dict = {}

    def is_match(w: str) -> bool:
        v = cache.get(w)
        if v is None:
            toks = _word_tokens(w)
            v = any(t in qset for t in toks)
            if not v and stemmed_q:
                v = any(_word_stem(t) in stemmed_q for t in toks)
            cache[w] = v
        return v

    fragments = []
    buf: list[str] = []
    cur_hl = False
    for w in words:
        hl = is_match(w)
        if hl != cur_hl and buf:
            fragments.append((" ".join(buf) + " ", cur_hl))
            buf = []
        cur_hl = hl
        buf.append(w)
    if buf:
        fragments.append((" ".join(buf), cur_hl))
    return fragments


def generate(query_terms: list[str], text: str, description: str = "",
             dirty_text: str = "") -> TextSnippet:
    """Passage-BM25 snippet (reference snippet.rs:317 generate)."""
    body = text or description or dirty_text
    if not body:
        return TextSnippet([("", False)])
    body = " ".join(body.split()[:MAX_CONSIDERED_WORDS])

    qset, stemmed_q = _expand_query_terms(query_terms)
    if not qset:
        # empty query → leading words (defaults::Snippet::empty_query_snippet_words)
        frag = " ".join(body.split()[:EMPTY_QUERY_SNIPPET_WORDS])
        return TextSnippet([(frag, False)])

    passages = sentence_passages(body)
    if not passages:
        frag = body[:DESIRED_NUM_CHARS]
        return _build(frag, qset, stemmed_q, ellipsis=len(body) > len(frag))

    # count terms per passage via the module word-token cache (corpus words
    # repeat across docs; tokenizing whole passages re-pays regex every call)
    passage_terms = []
    for p in passages:
        d: dict = {}
        for w in p.lower().split():
            for t in _word_tokens(w):
                d[t] = d.get(t, 0) + 1
        passage_terms.append(d)

    scores = _score_passages(passage_terms, qset)
    best_idx = max(range(len(passages)), key=lambda i: scores[i])

    frag = passages[best_idx]
    if len(frag) > DESIRED_NUM_CHARS + DELTA_NUM_CHARS:
        frag = frag[: DESIRED_NUM_CHARS + DELTA_NUM_CHARS]
    else:
        # append subsequent passages in document order (snippet.rs:276-287)
        nxt = best_idx + 1
        while len(frag) < DESIRED_NUM_CHARS - DELTA_NUM_CHARS and nxt < len(passages):
            frag = f"{frag} {passages[nxt]}"
            nxt += 1
        if len(frag) > DESIRED_NUM_CHARS + DELTA_NUM_CHARS:
            frag = frag[: DESIRED_NUM_CHARS + DELTA_NUM_CHARS]
    return _build(frag, qset, stemmed_q, ellipsis=True)


def _build(frag: str, qset: set, stemmed_q: set, ellipsis: bool) -> TextSnippet:
    # plain-token highlight first; stemmed fallback only when nothing matched
    fragments = _highlight(frag, qset)
    if not any(hl for _, hl in fragments):
        fragments = _highlight(frag, qset, stemmed_q)
    if ellipsis:
        fragments.append(("…", False))
    return TextSnippet(fragments)
