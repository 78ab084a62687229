"""Builds per-query device inputs (the port of stract_tpu/ranking/computer.py;
role of reference SignalComputer,
ranking/computer/mod.rs:210 — but instead of a per-doc callback it precomputes
slot arrays + aggregation matrices that drive the fused device pass).

A *slot* is one (text field, query token) pair with its posting range in the
segment, its idf, the coefficients of every signal it feeds, and the term-group
it belongs to (boolean semantics: required / optional / excluded — mirrors the
reference plan's MUST/SHOULD/MUST_NOT composition, query/plan/mod.rs:350-410).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

from ..ranking import signals as S
from ..schema import text_field
from ..tokenizer import get_tokenizer
from ..utils.hashing import term_hash

from ..ops import scoring as O

# Fields whose BM25 scores feed signals — only these need device field-length
# rows (index/device.py uploads them in this order).
BM25_FIELDS = [
    "title",
    "clean_body",
    "stemmed_title",
    "stemmed_clean_body",
    "all_body",
    "keywords",
    "backlink_text",
    "title_bigrams",
    "title_trigrams",
    "clean_body_bigrams",
    "clean_body_trigrams",
]
BM25_FIELD_ROW = {name: i for i, name in enumerate(BM25_FIELDS)}

_BM25_SIGNAL_FIELDS = {s.field: s for s in S.SIGNALS if s.kind == "bm25"}
_IDF_SIGNAL_FIELDS = {s.field: s for s in S.SIGNALS if s.kind == "idf_sum"}
_COV_SIGNAL_FIELDS = {s.field: s for s in S.SIGNALS if s.kind == "coverage"}

# Fields expanded for a plain query term (everything feeding a non-ngram text
# signal — role of Query::parse field expansion, reference query/mod.rs:77).
SIMPLE_TERM_FIELDS = sorted(
    set(f for f in _BM25_SIGNAL_FIELDS if "bigram" not in f and "trigram" not in f)
    | set(_IDF_SIGNAL_FIELDS)
)
NGRAM_FIELDS = ["title_bigrams", "clean_body_bigrams", "title_trigrams", "clean_body_trigrams"]


@dataclass
class TermGroup:
    """One boolean unit of the query: a simple term, a filter, or an exclusion."""

    text: str
    fields: list            # field names expanded for this group
    required: bool = True   # MUST
    excluded: bool = False  # MUST_NOT (overrides required)
    scoring: bool = True    # contributes text-signal scores


class OpticConstraintGroup(TermGroup):
    """Constraint group lowering optic patterns into the DEVICE candidate plan
    (role of reference query/optic.rs compiling optic rules into the tantivy
    boolean query, query/optic.rs:1-200). Slots are explicit (field, value)
    pairs, plus wildcard site/domain patterns expanded against each segment's
    distinct-value dictionary at slot-build time (PatternQuery role). The group
    matches a doc if ANY slot matches — so one excluded group carries every
    discard/blocked pattern and one required group carries DiscardNonMatching
    membership."""

    MAX_EXPANSIONS = 256  # wildcard safety cap (host residual still re-filters)

    def __init__(self, pairs=(), patterns=(), required: bool = True, excluded: bool = False):
        super().__init__(text="", fields=[], required=required, excluded=excluded, scoring=False)
        self.pairs = list(pairs)
        # patterns: [(dict_name 'site'|'domain', field_name, Matching)]
        self.patterns = list(patterns)

    def expand(self, segment) -> list:
        out = list(self.pairs)
        for dict_name, fname, matching in self.patterns:
            values = segment.value_dict(dict_name)
            hits = [v for v in values if matching.matches(v)]
            out.extend((fname, v) for v in hits[: self.MAX_EXPANSIONS])
        return out


@dataclass
class QueryContext:
    """Parsed-query inputs to slot construction."""

    raw: str
    simple_terms: list
    groups: list = None  # list[TermGroup]; built from simple_terms if None
    coefficients: dict = field(default_factory=dict)
    selected_region: int = 0  # 0 = All
    current_ts: float = 0.0   # unix seconds; 0 → time.time()

    def __post_init__(self):
        if self.groups is None:
            self.groups = [TermGroup(t, list(SIMPLE_TERM_FIELDS)) for t in self.simple_terms]

    def coeff(self, sig: S.Signal) -> float:
        return float(self.coefficients.get(sig.name, sig.default_coefficient))


def _next_bucket(n: int, minimum: int = O.DEFAULT_P) -> int:
    p = minimum
    while p < n:
        p *= 2
    return p


def uses_default_static(ctx) -> bool:
    """True when the query keeps the default coefficients for every static
    column signal — the gather-minimal precombined path applies."""
    for sid in O.STATIC_SIGNAL_IDS:
        sig = S.signal(sid)
        if abs(ctx.coeff(sig) - sig.default_coefficient) > 1e-12:
            return False
    return True


def choose_L(lens: np.ndarray, default: int | None = None) -> int:
    """Adaptive per-query posting budget: smallest power of two covering the
    longest slot, capped at DEFAULT_L (rare-term queries compile to tiny sorts)."""
    cap = default or O.DEFAULT_L
    longest = int(lens.max()) if len(lens) else 0
    L = 128
    while L < min(longest, cap):
        L *= 2
    return min(L, cap)


def _soft_bonus(w_bm25, w_bm25f, w_presence, static_coeffs, lut,
                coeff_region, coeff_update) -> float:
    """Soft-required bonus for the stage-A candidate cut, scaled so a FULL
    boolean match always outranks a partial one regardless of how extreme the
    query's (user/optic) coefficients are: bonus > max_score - min_score.

    Per-posting contribs are bounded by |w|·f_max (f1/f2 quantized to
    65535/FACTOR_SCALE = K1+1) plus |w_presence|; static columns are
    score-transformed (bounded by ~10 with margin), region by the lut max,
    update-timestamp score by 1."""
    fmax = 65535.0 / O.FACTOR_SCALE
    text = float(np.sum((np.abs(w_bm25) + np.abs(w_bm25f)) * fmax + np.abs(w_presence)))
    static = 10.0 * float(np.sum(np.abs(static_coeffs)))
    static += abs(float(coeff_region)) * float(np.max(np.abs(lut), initial=0.0))
    static += abs(float(coeff_update))
    return max(O.SOFT_REQUIRED_BONUS, 8.0 * (text + static))


def build_slots(
    ctx: QueryContext,
    segment,
    total_docs: int,
    region_scores: np.ndarray | None = None,
    P: int | None = None,
    df_lookup=None,
) -> tuple:
    """→ (QuerySlots, QueryAggregates). segment: index.Segment (host,
    memory-mapped); total_docs: index-level doc count for idf; region_scores:
    f32[NUM_REGIONS] corpus region frequencies; df_lookup: optional
    fn(u64 hashes) → index-level merged doc frequencies, so multi-segment
    scores use one consistent idf (role of tantivy Searcher::doc_freq which
    sums df across segments).

    Memoized per (ctx, segment): pass 1, pass 2 and the count estimator all
    need the same slots within one request."""
    cache = ctx.__dict__.setdefault("_slots_cache", {})
    cache_key = (id(segment), P)
    if cache_key in cache:
        return cache[cache_key]
    n_terms = max(len(ctx.simple_terms), 1)

    # ---- expand groups into slots ------------------------------------------------
    # the ~47 text fields share a handful of tokenizer TYPES — tokenize each
    # (tokenizer, text) pair once per query, not once per field (~1 ms/query
    # of host tail at serving shapes)
    tok_cache: dict = {}

    def toks(tokenizer_name: str, text: str) -> list:
        key = (tokenizer_name, text)
        v = tok_cache.get(key)
        if v is None:
            v = list(dict.fromkeys(get_tokenizer(tokenizer_name).tokenize(text)))
            tok_cache[key] = v
        return v

    slots = []  # (field_name, token, group_id, scoring)
    gid = 0
    n_required = 0
    for g in ctx.groups[: O.MAX_GROUPS]:
        if g.excluded:
            group_id = O.EXCLUDED_GROUP
        elif g.required:
            group_id = gid
            gid += 1
            n_required += 1
        else:
            group_id = O.OPTIONAL_GROUP
        expand = getattr(g, "expand", None)
        if expand is not None:
            # compiled constraint group (optics): explicit (field, value) pairs,
            # possibly expanded against this segment's value dictionaries
            for fname, value in expand(segment):
                for tok in toks(text_field(fname).tokenizer, value):
                    slots.append((fname, tok, group_id, False))
            continue
        for fname in g.fields:
            for tok in toks(text_field(fname).tokenizer, g.text):
                slots.append((fname, tok, group_id, g.scoring and not g.excluded))

    # n-gram booster slots over the full simple-term sequence (optional).
    joined = " ".join(ctx.simple_terms)
    if len(ctx.simple_terms) >= 2:
        for fname in NGRAM_FIELDS:
            for tok in toks(text_field(fname).tokenizer, joined):
                slots.append((fname, tok, O.OPTIONAL_GROUP, True))

    P = P or _next_bucket(len(slots))
    starts = np.zeros(P, dtype=np.int32)
    lens = np.zeros(P, dtype=np.int32)
    group = np.full(P, O.OPTIONAL_GROUP, dtype=np.int32)
    idf = np.zeros(P, dtype=np.float32)
    w_bm25 = np.zeros(P, dtype=np.float32)
    w_bm25f = np.zeros(P, dtype=np.float32)
    w_presence = np.zeros(P, dtype=np.float32)
    agg_bm25 = np.zeros((S.NUM_SIGNALS, P), dtype=np.float32)
    agg_bm25f = np.zeros((1, P), dtype=np.float32)
    agg_idf = np.zeros((S.NUM_SIGNALS, P), dtype=np.float32)
    agg_cov = np.zeros((S.NUM_SIGNALS, P), dtype=np.float32)

    slots = slots[:P]
    if slots:
        hashes = np.array(
            [term_hash(text_field(f).id, t) for f, t, _, _ in slots], dtype=np.uint64
        )
        t_starts, t_lens = segment.lookup_terms(hashes)
        merged_dfs = df_lookup(hashes) if df_lookup is not None else t_lens

    for i, (fname, tok, group_id, scoring) in enumerate(slots):
        f = text_field(fname)
        starts[i] = t_starts[i]
        lens[i] = t_lens[i]
        group[i] = group_id
        df = int(merged_dfs[i])
        x = (max(total_docs - df, 0) + 0.5) / (df + 0.5)
        idf[i] = np.log1p(x)
        if not scoring:
            continue

        bsig = _BM25_SIGNAL_FIELDS.get(fname)
        if bsig is not None:
            w_bm25[i] = ctx.coeff(bsig) * idf[i]
            agg_bm25[bsig.id, i] = 1.0
        if fname in S.BM25F_FIELD_COEFFS:
            w_bm25f[i] = ctx.coeff(S.BM25_F) * idf[i]
            agg_bm25f[0, i] = 1.0
        isig = _IDF_SIGNAL_FIELDS.get(fname)
        if isig is not None:
            w_presence[i] += ctx.coeff(isig) * idf[i]
            agg_idf[isig.id, i] = 1.0
        csig = _COV_SIGNAL_FIELDS.get(fname)
        if csig is not None:
            w_presence[i] += ctx.coeff(csig) / n_terms
            agg_cov[csig.id, i] = 1.0 / n_terms

    static_coeffs = np.array(
        [ctx.coeff(S.signal(sid)) for sid in O.STATIC_SIGNAL_IDS], dtype=np.float32
    )
    lut = np.zeros(O.NUM_REGIONS, dtype=np.float32)
    if region_scores is not None:
        lut[: len(region_scores)] = region_scores
    if ctx.selected_region > 0:
        lut[ctx.selected_region % O.NUM_REGIONS] += 50.0

    # host-side numpy arrays: the host planning (driver-group selection,
    # choose_L, weight checks) reads them; ops.scoring moves them to the device
    slots_t = O.QuerySlots(
        starts=starts,
        lens=lens,
        group=group,
        n_required=np.int32(n_required),
        idf=idf,
        w_bm25=w_bm25,
        w_bm25f=w_bm25f,
        w_presence=w_presence,
        static_coeffs=static_coeffs,
        region_lut=lut,
        coeff_region=np.float32(ctx.coeff(S.REGION)),
        coeff_update=np.float32(ctx.coeff(S.UPDATE_TIMESTAMP)),
        current_ts=np.float32(ctx.current_ts or time.time()),
        soft_bonus=np.float32(_soft_bonus(w_bm25, w_bm25f, w_presence,
                                          static_coeffs, lut,
                                          ctx.coeff(S.REGION),
                                          ctx.coeff(S.UPDATE_TIMESTAMP))),
    )
    aggs = O.QueryAggregates(
        agg_bm25=agg_bm25,
        agg_bm25f=agg_bm25f,
        agg_idf=agg_idf,
        agg_cov=agg_cov,
    )
    cache[cache_key] = (slots_t, aggs)
    return slots_t, aggs
