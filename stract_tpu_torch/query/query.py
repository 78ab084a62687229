"""Query — parsed query + planning into term groups (the port of
stract_tpu/query/query.py; role of reference query/mod.rs:77 Query::parse:
term→field expansion + boolean plan + optics).

Maps the term AST (parser.py) onto ranking/computer.py TermGroups:
  SIMPLE    → required group over the default field expansion
  PHRASE    → one required group per word (adjacency is approximated until the
              position index lands; reference uses tantivy phrase queries)
  SITE      → required, non-scoring group over site/domain identity fields
  TITLE/BODY/URL → required group restricted to those fields
  EXACT_URL → required group on url_no_tokenizer
  NOT(x)    → excluded group
  OR        → one group whose slots span all branches (match any)
  BANG      → extracted for the coordinator's bang redirect (bangs.py)
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..ranking.computer import QueryContext, TermGroup, SIMPLE_TERM_FIELDS
from .parser import Term, TermKind, parse_terms

SITE_FIELDS = ["site_no_tokenizer", "domain_no_tokenizer", "url_for_site_operator"]
TITLE_FIELDS = ["title", "stemmed_title"]
BODY_FIELDS = ["clean_body", "stemmed_clean_body", "all_body"]
URL_FIELDS = ["url"]
EXACT_URL_FIELDS = ["url_no_tokenizer"]


@dataclass
class Query:
    raw: str
    terms: list = field(default_factory=list)
    simple_terms: list = field(default_factory=list)
    phrases: list = field(default_factory=list)  # [[word, ...]] exact-adjacency groups
    # [(field_name, [word, ...])] adjacency checks scoped to ONE field —
    # multi-token site: operators (reference compiles them to a tantivy
    # PhraseQuery over url_for_site_operator, query/plan/mod.rs:151)
    field_phrases: list = field(default_factory=list)
    bangs: list = field(default_factory=list)
    groups: list = field(default_factory=list)
    coefficients: dict = field(default_factory=dict)
    selected_region: int = 0
    current_ts: float = 0.0
    host_rankings: object = None  # optics HostRankings (liked/disliked/blocked)
    optic: object = None
    optic_residual: object = None  # host post-filter part after device compilation

    @classmethod
    def parse(
        cls,
        raw: str,
        coefficients: dict | None = None,
        selected_region: int = 0,
        current_ts: float = 0.0,
        optic=None,
    ) -> "Query":
        q = cls(
            raw=raw,
            terms=parse_terms(raw),
            coefficients=dict(coefficients or {}),
            selected_region=selected_region,
            current_ts=current_ts,
            optic=optic,
        )
        for t in q.terms:
            q._plan_term(t)
        if optic is not None:
            q.coefficients = {**optic.coefficients(), **q.coefficients}
            q.host_rankings = optic.host_rankings
            # compile site/url/domain constraints into the device candidate
            # plan (reference query/optic.rs); prepended so the MAX_GROUPS
            # truncation never drops a filter before a scoring term
            optic_groups, q.optic_residual = optic.compile_groups()
            q.groups = optic_groups + q.groups
        return q

    def _plan_term(self, t: Term, excluded: bool = False) -> None:
        k = t.kind
        if k == TermKind.SIMPLE:
            if not excluded:
                self.simple_terms.append(t.text)
            self.groups.append(
                TermGroup(t.text, list(SIMPLE_TERM_FIELDS), required=not excluded, excluded=excluded)
            )
        elif k == TermKind.PHRASE:
            words = [w.lower() for w in t.sub]
            if not excluded and len(words) > 1:
                self.phrases.append(words)
            for w in words:
                if not excluded:
                    self.simple_terms.append(w)
                self.groups.append(
                    TermGroup(w, list(SIMPLE_TERM_FIELDS), required=not excluded, excluded=excluded)
                )
        elif k == TermKind.SITE:
            from ..tokenizer import get_tokenizer

            toks = get_tokenizer("url").tokenize(t.text.strip().lower())
            if excluded:
                # -site:python.org must NOT become OR-of-url-tokens (the 'org'
                # token would exclude every .org page); exclusion matches the
                # exact identity fields only
                self.groups.append(TermGroup(
                    t.text, ["site_no_tokenizer", "domain_no_tokenizer"],
                    required=False, excluded=True, scoring=False))
            elif len(toks) <= 1:
                self.groups.append(TermGroup(
                    t.text, list(SITE_FIELDS), required=True, excluded=False,
                    scoring=False))
            else:
                # reference parity (query/plan/node.rs:129 + mod.rs:151): a
                # multi-token site: term is a PHRASE over url_for_site_operator
                # — tokens adjacent in order. Candidate plan: AND of per-token
                # required groups (OR-of-tokens let 'org' alone satisfy the
                # filter); adjacency enforced by the position verify.
                for w in toks:
                    self.groups.append(TermGroup(
                        w, ["url_for_site_operator"], required=True,
                        excluded=False, scoring=False))
                self.field_phrases.append(("url_for_site_operator", toks))
        elif k == TermKind.TITLE:
            if not excluded:
                self.simple_terms.append(t.text.lower())
            self.groups.append(TermGroup(t.text, list(TITLE_FIELDS), required=not excluded, excluded=excluded))
        elif k == TermKind.BODY:
            if not excluded:
                self.simple_terms.append(t.text.lower())
            self.groups.append(TermGroup(t.text, list(BODY_FIELDS), required=not excluded, excluded=excluded))
        elif k == TermKind.URL:
            self.groups.append(TermGroup(t.text, list(URL_FIELDS), required=not excluded, excluded=excluded))
        elif k == TermKind.EXACT_URL:
            self.groups.append(
                TermGroup(t.text, list(EXACT_URL_FIELDS), required=not excluded, excluded=excluded, scoring=False)
            )
        elif k == TermKind.NOT:
            self._plan_term(t.sub[0], excluded=True)
        elif k == TermKind.BANG:
            self.bangs.append(t.text)
        elif k == TermKind.OR:
            # One group matching any branch: merge branch expansions.
            fields: list[str] = []
            texts = []
            for b in t.sub:
                if b.kind == TermKind.SIMPLE:
                    texts.append(b.text)
                    self.simple_terms.append(b.text)
            if texts:
                # represent as one group per branch but all sharing one id is not
                # expressible via TermGroup(text); emit a multi-text group:
                self.groups.append(
                    OrTermGroup(texts, list(SIMPLE_TERM_FIELDS), required=not excluded, excluded=excluded)
                )

    def is_empty(self) -> bool:
        return not self.groups and not self.bangs

    def context(self) -> QueryContext:
        return QueryContext(
            raw=self.raw,
            simple_terms=list(self.simple_terms),
            groups=list(self.groups),
            coefficients=dict(self.coefficients),
            selected_region=self.selected_region,
            current_ts=self.current_ts,
        )


class OrTermGroup(TermGroup):
    """Group matching any of several texts (`a || b`)."""

    def __init__(self, texts: list, fields: list, required: bool = True, excluded: bool = False):
        super().__init__(text=" ".join(texts), fields=fields, required=required, excluded=excluded)
        self.texts = texts
