"""Numerical (columnar) field schema (role of reference schema/numerical_field.rs:134-175).

Every variant of the reference's NumericalFieldEnum is present. On disk each field
is one dense array over doc ids (the reference's columnfields); at query time the
arrays used by ranking signals are resident in HBM and gathered per candidate doc
inside the fused signal pass (ops/scoring.py) — no per-doc host reads.

dtype map:
  f32 / f64  → float columns (centralities, scores)
  u32 / u64  → integer columns (ranks, hashes, node ids, timestamps)
  bool       → stored as u8
  emb        → dense [num_docs, dim] f16 matrix in its own file (embeddings)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class NumericalField:
    id: int
    name: str
    dtype: str = "f32"  # f32|f64|u32|u64|bool|emb
    default: float = 0.0

    def np_dtype(self):
        return {
            "f32": np.float32,
            "f64": np.float64,
            "u32": np.uint32,
            "u64": np.uint64,
            "bool": np.uint8,
            "emb": np.float16,
        }[self.dtype]

    def __str__(self) -> str:
        return self.name


_REGISTRY: dict[str, NumericalField] = {}


def _nf(name: str, dtype: str = "f32", default: float = 0.0) -> NumericalField:
    f = NumericalField(id=len(_REGISTRY), name=name, dtype=dtype, default=default)
    _REGISTRY[name] = f
    return f


# Mirrors NumericalFieldEnum order (reference schema/numerical_field.rs:134-175).
IS_HOMEPAGE = _nf("is_homepage", "bool")
HOST_CENTRALITY = _nf("host_centrality", "f64")
HOST_CENTRALITY_RANK = _nf("host_centrality_rank", "u64", default=float(2**40))
PAGE_CENTRALITY = _nf("page_centrality", "f64")
PAGE_CENTRALITY_RANK = _nf("page_centrality_rank", "u64", default=float(2**40))
FETCH_TIME_MS = _nf("fetch_time_ms", "u64")
LAST_UPDATED = _nf("last_updated", "u64")
TRACKER_SCORE = _nf("tracker_score", "f64")
REGION = _nf("region", "u64")
NUM_URL_TOKENS = _nf("num_url_tokens", "u64")
NUM_TITLE_TOKENS = _nf("num_title_tokens", "u64")
NUM_CLEAN_BODY_TOKENS = _nf("num_clean_body_tokens", "u64")
NUM_DESCRIPTION_TOKENS = _nf("num_description_tokens", "u64")
NUM_URL_FOR_SITE_OPERATOR_TOKENS = _nf("num_url_for_site_operator_tokens", "u64")
NUM_DOMAIN_TOKENS = _nf("num_domain_tokens", "u64")
NUM_MICROFORMAT_TAGS_TOKENS = _nf("num_microformat_tags_tokens", "u64")
SITE_HASH1 = _nf("site_hash1", "u64")
SITE_HASH2 = _nf("site_hash2", "u64")
URL_WITHOUT_QUERY_HASH1 = _nf("url_without_query_hash1", "u64")
URL_WITHOUT_QUERY_HASH2 = _nf("url_without_query_hash2", "u64")
TITLE_HASH1 = _nf("title_hash1", "u64")
TITLE_HASH2 = _nf("title_hash2", "u64")
URL_HASH1 = _nf("url_hash1", "u64")
URL_HASH2 = _nf("url_hash2", "u64")
DOMAIN_HASH1 = _nf("domain_hash1", "u64")
DOMAIN_HASH2 = _nf("domain_hash2", "u64")
URL_WITHOUT_TLD_HASH1 = _nf("url_without_tld_hash1", "u64")
URL_WITHOUT_TLD_HASH2 = _nf("url_without_tld_hash2", "u64")
PRE_COMPUTED_SCORE = _nf("pre_computed_score", "f64")
HOST_NODE_ID = _nf("host_node_id", "u64", default=float(2**63))
SIM_HASH = _nf("sim_hash", "u64")
NUM_FLATTENED_SCHEMA_TOKENS = _nf("num_flattened_schema_tokens", "u64")
NUM_PATH_AND_QUERY_SLASHES = _nf("num_path_and_query_slashes", "u64")
NUM_PATH_AND_QUERY_DIGITS = _nf("num_path_and_query_digits", "u64")
LIKELY_HAS_ADS = _nf("likely_has_ads", "bool")
LIKELY_HAS_PAYWALL = _nf("likely_has_paywall", "bool")
LINK_DENSITY = _nf("link_density", "f64")
TITLE_EMBEDDINGS = _nf("title_embeddings", "emb")
KEYWORD_EMBEDDINGS = _nf("keyword_embeddings", "emb")
SUFFIX_ID = _nf("suffix_id", "u64")

NUMERICAL_FIELDS: list[NumericalField] = list(_REGISTRY.values())
NUM_NUMERICAL_FIELDS = len(NUMERICAL_FIELDS)
_BY_NAME = dict(_REGISTRY)
_BY_ID = {f.id: f for f in NUMERICAL_FIELDS}


def numerical_field(key) -> NumericalField:
    if isinstance(key, NumericalField):
        return key
    if isinstance(key, int):
        return _BY_ID[key]
    return _BY_NAME[key]
