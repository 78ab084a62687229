"""BM25 / BM25F math shared by host oracle and device kernels.

Formulas match the reference (ranking/bm25.rs, ranking/bm25f.rs, both derived
from tantivy's BM25):
    idf(df, N)            = ln(1 + (N - df + 0.5) / (df + 0.5))
    norm(len, avg)        = k1 * (1 - b + b * len / avg)
    bm25(tf, ...)         = idf * tf * (k1 + 1) / (tf + norm)
    bm25f(tf, coeff, ...) = idf * (tf * coeff) * (k1 + 1) / (tf * coeff + norm)
with k1 = 1.2, b = 0.75 (bm25.rs:8-9).

Deviation from the reference: field lengths are exact u32 columns instead of
tantivy's 256-bucket quantized fieldnorm ids — on TPU the exact length is a
dense gather, so there is no reason to quantize. Scores therefore differ from
the reference by the fieldnorm quantization error only.

These functions are written on jnp-compatible primitives so they can be traced
inside jit (ops/scoring.py) and also run on numpy arrays for host-side oracles.
"""

from __future__ import annotations

import math

K1 = 1.2
B = 0.75


def idf(doc_freq, doc_count):
    """ln(1 + (N - df + 0.5)/(df + 0.5)) — guards df > N (can happen across shards)."""
    df = min(doc_freq, doc_count) if isinstance(doc_freq, (int, float)) else doc_freq
    x = ((doc_count - df) + 0.5) / (df + 0.5)
    return math.log1p(x) if isinstance(x, float) else None


def idf_np(doc_freq, doc_count, xp):
    """Array version: xp is numpy or jax.numpy."""
    df = xp.minimum(doc_freq, doc_count)
    x = ((doc_count - df) + 0.5) / (df + 0.5)
    return xp.log1p(x)


def bm25_norm(field_len, avg_field_len, k1: float = K1, b: float = B):
    return k1 * (1.0 - b + b * field_len / avg_field_len)


def bm25_tf_factor(tf, field_len, avg_field_len, k1: float = K1, b: float = B):
    """tf*(k1+1)/(tf+norm); 0 when tf==0 (holds naturally since numerator is 0)."""
    norm = bm25_norm(field_len, avg_field_len, k1, b)
    return tf * (k1 + 1.0) / (tf + norm)


def bm25f_tf_factor(tf, coeff, field_len, avg_field_len, k1: float = K1, b: float = B):
    norm = bm25_norm(field_len, avg_field_len, k1, b)
    stf = tf * coeff
    return stf * (k1 + 1.0) / (stf + norm)


# -- non-text signal score transforms (reference signals/core/non_text.rs) ----

RANK_NUM_GROUPS = 10.0
RANK_LOG_BASE = 8.0
UPDATE_HALF_LIFE_HOURS = 24.0 * 3.0
UPDATE_CACHE_HOURS = 3 * 365 * 24
FETCH_TIME_CACHE_MS = 1000


def score_rank(rank, xp):
    """max(0, 10 - log8(1 + rank)) (non_text.rs:50-59)."""
    return xp.maximum(0.0, RANK_NUM_GROUPS - xp.log(1.0 + rank) / math.log(RANK_LOG_BASE))


def score_reciprocal(v, xp=None):
    """1/(v+1) — trackers, url digits, url slashes, and the fetch-time cache."""
    return 1.0 / (v + 1.0)


def score_fetch_time(ms, xp):
    return xp.where(ms < FETCH_TIME_CACHE_MS, 1.0 / (ms + 1.0), 0.0)


def score_update_timestamp(ts, current_ts, xp):
    """72h half-life freshness decay, 0 beyond 3 years or future timestamps
    (non_text.rs:25-47)."""
    hours = xp.maximum((current_ts - ts), 1.0) // 3600
    fresh = UPDATE_HALF_LIFE_HOURS / (hours + UPDATE_HALF_LIFE_HOURS)
    valid = (ts < current_ts) & (ts > 0) & (hours < UPDATE_CACHE_HOURS)
    return xp.where(valid, fresh, 0.0)


def score_link_density(ld, xp):
    return xp.where(ld > 0.5, 0.0, 1.0 - ld)


def score_has_ads(has_ads, xp):
    return xp.where(has_ads > 0, 0.0, 1.0)
