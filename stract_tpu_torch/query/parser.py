"""Query parser (role of reference query/parser/mod.rs + parser/term.rs — a
nom-based grammar; here a hand-rolled tokenizer with the same term language):

    plain terms          rust tutorial
    phrases              "exact phrase"
    site filter          site:example.com
    field terms          intitle:rust  inbody:fast  inurl:docs
    exact url            exacturl:https://example.com/page
    exclusion            -spam
    bangs                !g query   !!w query
    or patterns          left || right
    optic inline         (handled by optics/, not here)

MAX_TERMS_PER_QUERY = 32 (parser/mod.rs:17).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

MAX_TERMS_PER_QUERY = 32


class TermKind(enum.Enum):
    SIMPLE = "simple"
    PHRASE = "phrase"
    SITE = "site"
    TITLE = "intitle"
    BODY = "inbody"
    URL = "inurl"
    EXACT_URL = "exacturl"
    NOT = "not"
    BANG = "bang"
    OR = "or"


@dataclass
class Term:
    kind: TermKind
    text: str = ""
    sub: list = field(default_factory=list)  # NOT → [term]; PHRASE → words; OR → branches

    def __repr__(self):
        if self.kind == TermKind.SIMPLE:
            return f"'{self.text}'"
        if self.kind == TermKind.NOT:
            return f"NOT({self.sub[0]!r})"
        if self.kind == TermKind.PHRASE:
            return f'"{self.text}"'
        if self.kind == TermKind.OR:
            return " || ".join(repr(s) for s in self.sub)
        return f"{self.kind.value}:{self.text}"


_FIELD_PREFIXES = {
    "site:": TermKind.SITE,
    "intitle:": TermKind.TITLE,
    "inbody:": TermKind.BODY,
    "inurl:": TermKind.URL,
    "exacturl:": TermKind.EXACT_URL,
}


def _lex(q: str) -> list[str]:
    """Split into raw tokens, keeping quoted phrases together and || separate."""
    out: list[str] = []
    i, n = 0, len(q)
    while i < n:
        c = q[i]
        if c.isspace():
            i += 1
            continue
        if c == '"':
            j = q.find('"', i + 1)
            if j == -1:
                out.append(q[i:])
                break
            out.append(q[i : j + 1])
            i = j + 1
            continue
        if q.startswith("||", i):
            out.append("||")
            i += 2
            continue
        j = i
        while j < n and not q[j].isspace():
            j += 1
        out.append(q[i:j])
        i = j
    return out


def _parse_one(tok: str) -> Term | None:
    if not tok:
        return None
    if tok.startswith('"') :
        body = tok.strip('"')
        if not body:
            return None
        return Term(TermKind.PHRASE, body, sub=body.split())
    if tok.startswith("!!"):
        return Term(TermKind.BANG, tok[2:]) if len(tok) > 2 else None
    if tok.startswith("!"):
        return Term(TermKind.BANG, tok[1:]) if len(tok) > 1 else None
    if tok.startswith("-") and len(tok) > 1 and not tok[1].isspace():
        inner = _parse_one(tok[1:])
        if inner is None:
            return None
        return Term(TermKind.NOT, sub=[inner])
    low = tok.lower()
    for prefix, kind in _FIELD_PREFIXES.items():
        if low.startswith(prefix) and len(tok) > len(prefix):
            return Term(kind, tok[len(prefix) :])
    if not any(c.isalnum() for c in tok):
        return None  # pure punctuation (lone '-', '?', ...)
    return Term(TermKind.SIMPLE, tok.lower())


def parse_terms(q: str) -> list[Term]:
    """Parse into a term list; adjacent `a || b` groups collapse into OR terms."""
    raw = _lex(q)
    terms: list[Term] = []
    for tok in raw:
        if tok == "||":
            if terms:
                prev = terms[-1]
                if prev.kind != TermKind.OR:
                    terms[-1] = Term(TermKind.OR, sub=[prev])
                terms[-1].sub.append(None)  # placeholder: next term joins the OR
            continue
        t = _parse_one(tok)
        if t is None:
            continue
        if terms and terms[-1].kind == TermKind.OR and terms[-1].sub and terms[-1].sub[-1] is None:
            terms[-1].sub[-1] = t
            continue
        terms.append(t)
        if len(terms) >= MAX_TERMS_PER_QUERY:
            break
    # drop dangling OR placeholders
    for t in terms:
        if t.kind == TermKind.OR:
            t.sub = [s for s in t.sub if s is not None]
    return terms
