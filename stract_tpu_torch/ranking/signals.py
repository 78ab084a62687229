"""Ranking signal registry (role of reference ranking/signals/mod.rs:108-221).

All 46 SignalEnum variants, same order (ids are stable — they index the device
signal matrix and the LTR feature vectors). Each signal carries:
  - default_coefficient: the linear-combination weight (reference values)
  - core: computed per-shard (device fused pass); non-core signals are filled by
    the coordinator pipeline stages (cross-encoders, lambdamart, embeddings, ...)
  - kind/field: how the device pass computes it:
      'bm25'      — BM25 over one text field
      'bm25f'     — fused BM25F across weighted fields
      'idf_sum'   — Σ idf of matched terms in one field
      'coverage'  — matched-terms fraction in one field
      'column'    — transform of one numerical column
      'external'  — coordinator-computed

On TPU the per-doc loop of the reference's SignalComputer (computer/mod.rs:62-95)
becomes one one-hot matmul: slot-level BM25/presence matrices [P, K] are folded
into the signal matrix [S, K] by aggregation matrices built from this registry
(see ops/scoring.py).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Signal:
    id: int
    name: str
    default_coefficient: float
    core: bool = True
    kind: str = "external"
    field: str = ""  # text field name (text kinds) or numerical column name

    def __str__(self) -> str:
        return self.name


_REGISTRY: dict[str, Signal] = {}


def _sig(name: str, coeff: float, kind: str = "external", field: str = "", core: bool = True) -> Signal:
    s = Signal(id=len(_REGISTRY), name=name, default_coefficient=coeff, core=core, kind=kind, field=field)
    _REGISTRY[name] = s
    return s


# Order mirrors reference SignalEnum (signals/mod.rs:108-155).
BM25_F = _sig("bm25_f", 0.1, "bm25f")
BM25_TITLE = _sig("bm25_title", 0.0063, "bm25", "title")
TITLE_COVERAGE = _sig("title_coverage", 0.01, "coverage", "title")
BM25_TITLE_BIGRAMS = _sig("bm25_title_bigrams", 0.005, "bm25", "title_bigrams")
BM25_TITLE_TRIGRAMS = _sig("bm25_title_trigrams", 0.005, "bm25", "title_trigrams")
BM25_CLEAN_BODY = _sig("bm25_clean_body", 0.005, "bm25", "clean_body")
CLEAN_BODY_COVERAGE = _sig("clean_body_coverage", 0.01, "coverage", "clean_body")
BM25_CLEAN_BODY_BIGRAMS = _sig("bm25_clean_body_bigrams", 0.005, "bm25", "clean_body_bigrams")
BM25_CLEAN_BODY_TRIGRAMS = _sig("bm25_clean_body_trigrams", 0.005, "bm25", "clean_body_trigrams")
BM25_STEMMED_TITLE = _sig("bm25_stemmed_title", 0.003, "bm25", "stemmed_title")
BM25_STEMMED_CLEAN_BODY = _sig("bm25_stemmed_clean_body", 0.001, "bm25", "stemmed_clean_body")
BM25_ALL_BODY = _sig("bm25_all_body", 0.0, "bm25", "all_body")
BM25_KEYWORDS = _sig("bm25_keywords", 0.001, "bm25", "keywords")
BM25_BACKLINK_TEXT = _sig("bm25_backlink_text", 0.003, "bm25", "backlink_text")
IDF_SUM_URL = _sig("idf_sum_url", 0.0006, "idf_sum", "url")
IDF_SUM_SITE = _sig("idf_sum_site", 0.00015, "idf_sum", "site_without")
IDF_SUM_DOMAIN = _sig("idf_sum_domain", 0.0003, "idf_sum", "domain")
IDF_SUM_SITE_NO_TOKENIZER = _sig("idf_sum_site_no_tokenizer", 0.00015, "idf_sum", "site_no_tokenizer")
IDF_SUM_DOMAIN_NO_TOKENIZER = _sig("idf_sum_domain_no_tokenizer", 0.0036, "idf_sum", "domain_no_tokenizer")
IDF_SUM_DOMAIN_NAME_NO_TOKENIZER = _sig(
    "idf_sum_domain_name_no_tokenizer", 0.0002, "idf_sum", "domain_name_no_tokenizer"
)
IDF_SUM_DOMAIN_IF_HOMEPAGE = _sig("idf_sum_domain_if_homepage", 0.0004, "idf_sum", "domain_if_homepage")
IDF_SUM_DOMAIN_NAME_IF_HOMEPAGE_NO_TOKENIZER = _sig(
    "idf_sum_domain_name_if_homepage_no_tokenizer", 0.0036, "idf_sum", "domain_name_if_homepage_no_tokenizer"
)
IDF_SUM_DOMAIN_IF_HOMEPAGE_NO_TOKENIZER = _sig(
    "idf_sum_domain_if_homepage_no_tokenizer", 0.0036, "idf_sum", "domain_if_homepage_no_tokenizer"
)
IDF_SUM_TITLE_IF_HOMEPAGE = _sig("idf_sum_title_if_homepage", 0.001, "idf_sum", "title_if_homepage")
CROSS_ENCODER_SNIPPET = _sig("cross_encoder_snippet", 0.17, core=False)
CROSS_ENCODER_TITLE = _sig("cross_encoder_title", 0.17, core=False)
HOST_CENTRALITY = _sig("host_centrality", 2.0, "column", "host_centrality")
HOST_CENTRALITY_RANK = _sig("host_centrality_rank", 0.02, "column", "host_centrality_rank")
PAGE_CENTRALITY = _sig("page_centrality", 2.0, "column", "page_centrality")
PAGE_CENTRALITY_RANK = _sig("page_centrality_rank", 0.02, "column", "page_centrality_rank")
IS_HOMEPAGE = _sig("is_homepage", 0.01, "column", "is_homepage")
FETCH_TIME_MS = _sig("fetch_time_ms", 0.001, "column", "fetch_time_ms")
UPDATE_TIMESTAMP = _sig("update_timestamp", 0.75, "column", "last_updated")
TRACKER_SCORE = _sig("tracker_score", 0.1, "column", "tracker_score")
REGION = _sig("region", 0.15, "column", "region")
# declared-but-never-computed, as in the reference: QueryCentrality sits in
# the enum + ALL_SIGNALS with default_coefficient 0.0 and has NO compute impl
# anywhere in crates/core (signals/non_core/non_text.rs:31-36) — kept for
# signal-id/API parity (rankingSignals responses, optic coefficient names)
QUERY_CENTRALITY = _sig("query_centrality", 0.0, core=False)
INBOUND_SIMILARITY = _sig("inbound_similarity", 0.25, core=False)
LAMBDA_MART = _sig("lambda_mart", 10.0, core=False)
URL_DIGITS = _sig("url_digits", 0.01, "column", "num_path_and_query_digits")
URL_SLASHES = _sig("url_slashes", 0.1, "column", "num_path_and_query_slashes")
LINK_DENSITY = _sig("link_density", 0.0, "column", "link_density")
TITLE_EMBEDDING_SIMILARITY = _sig("title_embedding_similarity", 0.01, core=False)
KEYWORD_EMBEDDING_SIMILARITY = _sig("keyword_embedding_similarity", 0.01, core=False)
HAS_ADS = _sig("has_ads", 0.01, "column", "likely_has_ads")
MIN_TITLE_SLOP = _sig("min_title_slop", 0.1, core=False)
MIN_CLEAN_BODY_SLOP = _sig("min_clean_body_slop", 0.1, core=False)

SIGNALS: list[Signal] = list(_REGISTRY.values())
NUM_SIGNALS = len(SIGNALS)
CORE_SIGNALS: list[Signal] = [s for s in SIGNALS if s.core]
_BY_NAME = dict(_REGISTRY)
_BY_ID = {s.id: s for s in SIGNALS}

# Fields fused into the BM25F signal with their per-field tf coefficients
# (title weighted above body, mirroring the reference's field boosts).
BM25F_FIELD_COEFFS: dict[str, float] = {"title": 4.0, "clean_body": 1.0}


def signal(key) -> Signal:
    if isinstance(key, Signal):
        return key
    if isinstance(key, int):
        return _BY_ID[key]
    return _BY_NAME[key]


def default_coefficients() -> dict[str, float]:
    return {s.name: s.default_coefficient for s in SIGNALS}


def text_signal_for_field(field_name: str, kind: str) -> Signal | None:
    """Which signal a (field, kind) pair feeds, if any."""
    for s in SIGNALS:
        if s.kind == kind and s.field == field_name:
            return s
    return None
