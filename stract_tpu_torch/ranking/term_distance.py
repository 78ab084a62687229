"""Recall-stage term-distance (slop) signals from STORED POSITIONS (role of
reference ranking/pipeline/scorers/term_distance.rs + stages/recall.rs:311-312:
TitleDistanceScorer / BodyDistanceScorer run over ALL ~300 recall candidates,
so proximity can change WHICH docs reach the page — not just reorder it).

Reference semantics (term_distance.rs:23-55), matched exactly:
  min_slop_two_positions(a, b) = min over (x in a, y in b, y > x) of (y - x)
                                 — u32::MAX when no ordered pair exists;
  min_slop(term positions in query order) = MAX over adjacent term pairs
                                 — u32::MAX for single-term queries;
  score = 1 / (slop + 1).

Everything is vectorized across the candidate set: positions for all docs
come from one batched range gather per term (segment.positions_for_docs), and
the ordered-pair min-gap merge is one searchsorted over doc-disambiguated
keys (doc_row << 20 | position) instead of a per-doc cursor loop."""

from __future__ import annotations

import numpy as np

SLOP_MAX = float(2**32 - 1)  # u32::MAX sentinel, as in the reference

_ROW_SHIFT = 20  # positions are u16 (< 2^16) — 2^20 keeps rows disjoint


def _pair_min_gap(pos_a, row_a, pos_b, row_b, n_rows: int) -> np.ndarray:
    """Per-row min over ordered pairs (b > a) of (b - a); SLOP_MAX where no
    ordered pair exists. Rows are merged in ONE searchsorted by packing
    (row, position) into a single sortable key."""
    out = np.full(n_rows, SLOP_MAX, dtype=np.float64)
    if len(pos_a) == 0 or len(pos_b) == 0:
        return out
    key_a = (row_a.astype(np.int64) << _ROW_SHIFT) | pos_a
    key_b = (row_b.astype(np.int64) << _ROW_SHIFT) | pos_b
    # both inputs arrive row-major and position-ascending within a row
    # (positions_for_docs gathers ranges in row order), so keys are sorted
    # for each a-occurrence: the smallest b in the same row with b > a
    # (reference's two-cursor loop, term_distance.rs:23-46, vectorized)
    idx = np.searchsorted(key_b, key_a, side="right")
    valid = idx < len(key_b)
    iv = np.minimum(idx, len(key_b) - 1)
    ok = valid & (row_b[iv] == row_a) & (pos_b[iv] > pos_a)
    gap = (pos_b[iv] - pos_a).astype(np.float64)
    np.minimum.at(out, row_a[ok], gap[ok])
    return out


def min_slop_block(seg, field_id: int, tokens: list, doc_ids: np.ndarray,
                   term_hash_fn) -> np.ndarray:
    """Reference min_slop for every doc in doc_ids: f64[N] slop values
    (SLOP_MAX where any adjacent pair has no ordered occurrence)."""
    n = len(doc_ids)
    if len(tokens) < 2:
        return np.full(n, SLOP_MAX, dtype=np.float64)
    per_term = [seg.positions_for_docs(term_hash_fn(field_id, t), doc_ids)
                for t in tokens]
    out = np.zeros(n, dtype=np.float64)
    for (pa, ra), (pb, rb) in zip(per_term, per_term[1:]):
        np.maximum(out, _pair_min_gap(pa, ra, pb, rb, n), out)
    return out


def score_slop(slop: np.ndarray) -> np.ndarray:
    return (1.0 / (np.asarray(slop, dtype=np.float64) + 1.0)).astype(np.float32)


# reference parity check (term_distance.rs test_min_slop):
#   positions [[13,18,22],[8,15,30],[9,16]] → min_slop == 2
def _min_slop_listform(positions: list) -> float:
    """Direct port of the reference's per-doc algorithm — used by tests to
    cross-check the vectorized path."""
    best = 0.0
    if len(positions) < 2:
        return SLOP_MAX
    for a, b in zip(positions, positions[1:]):
        cur = SLOP_MAX
        for x in a:
            larger = [y for y in b if y > x]
            if larger:
                cur = min(cur, min(larger) - x)
        best = max(best, cur)
    return best
