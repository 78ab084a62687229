"""Shared fixtures and comparisons for the PyTorch port's parity tests
(tests/test_torch_*.py): inputs are made with numpy from a seed and handed
to both packages."""

from __future__ import annotations

import numpy as np

from stract_tpu.ops import scoring as OJ
from stract_tpu.ranking import bm25_math as BM
from stract_tpu.ranking import signals as S


def rich_fixture(rng, D=3000, n_terms=40, L=256, DB=4096, n_impact=3, df=(5, 400)):
    """A segment's arrays as numpy (the JAX package's SegmentArrays fields):
    doc-ordered posting ranges with distinct bm25 / bm25f factors (q1 often
    >= 32768, i.e. negative packed words), per-doc static, region and
    freshness carried in the aux word, plus tf-factor-ordered impact ranges
    (rows NOT doc-sorted) for the n_impact longest terms; term lengths drawn
    from [df[0], df[1]).
    → (seg, term_starts, term_lens, impact {term: (start, len)}, L)."""
    dfs = rng.integers(df[0], df[1], n_terms)
    starts = np.concatenate([[0], np.cumsum(dfs)[:-1]]).astype(np.int64)
    total = int(dfs.sum())
    docs = np.empty(total, dtype=np.int64)
    for i in range(n_terms):
        docs[starts[i]: starts[i] + dfs[i]] = np.sort(rng.choice(D, size=dfs[i], replace=False))
    tfs = rng.integers(1, 12, total).astype(np.float64)
    flen = rng.integers(10, 300, D).astype(np.float64)
    norm = BM.K1 * (1 - BM.B + BM.B * flen[docs] / 100.0)
    f1 = tfs * (BM.K1 + 1) / (tfs + norm)
    f2 = 4 * tfs * (BM.K1 + 1) / (4 * tfs + norm)
    q1 = np.clip(np.round(f1 * OJ.FACTOR_SCALE), 1, 65535).astype(np.int64)
    q2 = np.clip(np.round(f2 * OJ.FACTOR_SCALE), 1, 65535).astype(np.int64)
    factors = ((q1 << 16) | q2).astype(np.int64).astype(np.int32)
    assert (factors < 0).any()  # the negative packed word is exercised

    static = np.zeros((OJ.NUM_STATIC, DB), np.float32)
    static[:, :D] = rng.random((OJ.NUM_STATIC, D)).astype(np.float32) * 0.1
    static_default = (OJ.DEFAULT_STATIC_COEFFS[:, None] * static).sum(0)
    static_scale = np.float32(max(float(static_default[:D].max()), 1e-6) / 65535.0)
    region = np.zeros(DB, np.int32)
    region[:D] = rng.integers(0, OJ.NUM_REGIONS, D)
    last_updated = np.zeros(DB, np.float32)
    fresh = rng.random(D) < 0.7
    last_updated[:D] = np.where(fresh, rng.integers(1_690_000_000, 1_700_000_000, D), 0)
    lu = last_updated[:D].astype(np.float64)
    days = np.clip((lu - OJ.DAYS_EPOCH) / 86400.0, 0, 4095).astype(np.int64)
    days = np.where(lu > 0, np.maximum(days, 1), 0)
    static_q = np.clip(np.round(static_default[:D] / static_scale), 0, 65535).astype(np.int64)
    doc_aux = ((static_q << 16) | (region[:D].astype(np.int64) << OJ.AUX_REGION_SHIFT)
               | days).astype(np.int32)

    rows = np.stack([docs.astype(np.int32), factors, doc_aux[docs]], axis=1)
    impact = {}
    chunks = [rows]
    pos = total
    for t in np.argsort(-dfs)[:n_impact]:
        r = rows[starts[t]: starts[t] + dfs[t]]
        r = r[np.argsort(-((r[:, 1] >> 16) & 0xFFFF), kind="stable")]  # tf-factor desc
        chunks.append(r)
        impact[int(t)] = (pos, len(r))
        pos += len(r)
    pad = np.zeros((L, 3), np.int32)
    pad[:, 0] = D
    postings = np.concatenate(chunks + [pad]).astype(np.int32)
    seg = OJ.SegmentArrays(
        postings=postings, static_cols=static, static_default=static_default,
        static_scale=static_scale, region_ids=region, last_updated=last_updated,
        num_docs=np.int32(D))
    return seg, starts, dfs, impact, L


def query_batch(rng, seg, starts, dfs, impact, B=5, P=16, default_static=True):
    """Batched QuerySlots + QueryAggregates (numpy) over the fixture: two
    required groups, an excluded slot in some queries, optional slots, and
    an impact-prefix slot for the first term when it has one. Under
    default_static=False the static coefficients are custom and one slot
    weight is negative (signed sums)."""
    D = int(seg.num_docs)
    n_terms = len(dfs)
    q_starts = np.zeros((B, P), np.int32)
    q_lens = np.zeros((B, P), np.int32)
    group = np.full((B, P), OJ.OPTIONAL_GROUP, np.int32)
    big = list(impact)
    for b in range(B):
        terms = rng.integers(0, n_terms, 6)
        terms[0] = big[b % len(big)]
        q_starts[b, :6] = starts[terms]
        q_lens[b, :6] = dfs[terms]
        group[b, 0], group[b, 1] = 0, 1
        if b % 2:
            group[b, 2] = OJ.EXCLUDED_GROUP
        ist, iln = impact[int(terms[0])]
        q_starts[b, 6], q_lens[b, 6], group[b, 6] = ist, iln, 0
    idf = np.log1p((D - q_lens + 0.5) / (q_lens + 0.5)).astype(np.float32)
    idf[q_lens == 0] = 0
    w_bm25 = idf * 0.5
    w_bm25f = idf * 0.1
    w_presence = idf * 0.05 + 0.1 * (q_lens > 0)
    for w in (w_bm25, w_bm25f, w_presence):
        w[group == OJ.EXCLUDED_GROUP] = 0
    coeffs = np.tile(OJ.DEFAULT_STATIC_COEFFS, (B, 1))
    if not default_static:
        coeffs = rng.normal(0, 1, (B, OJ.NUM_STATIC)).astype(np.float32)
        w_bm25[:, 3] = -np.abs(w_bm25[:, 3])
    w_presence[:, 6] = w_presence[:, 0]
    qs = OJ.QuerySlots(
        starts=q_starts, lens=q_lens, group=group,
        n_required=np.full(B, 2, np.int32), idf=idf,
        w_bm25=w_bm25.astype(np.float32), w_bm25f=w_bm25f.astype(np.float32),
        w_presence=w_presence.astype(np.float32),
        static_coeffs=coeffs.astype(np.float32),
        region_lut=rng.random((B, OJ.NUM_REGIONS)).astype(np.float32),
        coeff_region=np.full(B, 0.15, np.float32), coeff_update=np.full(B, 0.75, np.float32),
        current_ts=np.full(B, 1.7e9, np.float32),
        soft_bonus=np.full(B, OJ.SOFT_REQUIRED_BONUS, np.float32),
    )
    bm25_rows = [s.id for s in S.SIGNALS if s.kind == "bm25"]
    idf_rows = [s.id for s in S.SIGNALS if s.kind == "idf_sum"]
    cov_rows = [s.id for s in S.SIGNALS if s.kind == "coverage"]
    agg_bm25 = np.zeros((B, S.NUM_SIGNALS, P), np.float32)
    agg_bm25f = np.zeros((B, 1, P), np.float32)
    agg_idf = np.zeros((B, S.NUM_SIGNALS, P), np.float32)
    agg_cov = np.zeros((B, S.NUM_SIGNALS, P), np.float32)
    for b in range(B):
        for p in range(P):
            if q_lens[b, p] == 0 or group[b, p] == OJ.EXCLUDED_GROUP:
                continue
            agg_bm25[b, rng.choice(bm25_rows), p] = 1.0
            agg_bm25f[b, 0, p] = float(p % 2)
            agg_idf[b, rng.choice(idf_rows), p] = 1.0
            agg_cov[b, rng.choice(cov_rows), p] = 1.0 / 6
    aggs = OJ.QueryAggregates(agg_bm25=agg_bm25, agg_bm25f=agg_bm25f, agg_idf=agg_idf,
                              agg_cov=agg_cov)
    return qs, aggs


def host_factors(seg, qs, cands):
    """Stage-B factor matrices i32[B, P, K] by binary search over each slot's
    (doc-ordered) posting range — what the host join produces."""
    B, P = qs.starts.shape
    K = cands.shape[1]
    out = np.zeros((B, P, K), np.int32)
    post = np.asarray(seg.postings)
    for b in range(B):
        for p in range(P):
            s, l = int(qs.starts[b, p]), int(qs.lens[b, p])
            if l == 0:
                continue
            dp = post[s: s + l, 0]
            pos = np.minimum(np.searchsorted(dp, cands[b]), l - 1)
            found = dp[pos] == cands[b]
            out[b, p, found] = post[s + pos[found], 1]
    return out


def driver_candidates(rng, seg, B, Kd):
    """Candidate columns: random docs, the last tenth padded with num_docs."""
    D = int(seg.num_docs)
    cands = np.stack([np.sort(rng.choice(D, Kd, replace=False)) for _ in range(B)])
    cands[:, -Kd // 10:] = D
    return cands.astype(np.int32)


def doc_only(qs):
    """Slots restricted to doc-ordered posting ranges (stage B's compacted
    slots never carry impact prefixes)."""
    lens = np.asarray(qs.lens).copy()
    lens[:, 6:] = 0
    return qs._replace(lens=lens)


def row_layout_of(seg, row_layout: str):
    """The fixture's segment with its posting rows in `row_layout`."""
    from stract_tpu_torch.index.device import quantize_rows_q8

    if row_layout == "q16":
        return seg
    return seg._replace(postings=quantize_rows_q8(np.asarray(seg.postings)))


def ub_inputs(rng, qs):
    """Per-slot bounds of the size _augment_with_impact produces: 0 on short
    and excluded slots, a positive bound on the long ones (the impact slot
    carries its source slot's bound)."""
    B, P = qs.starts.shape
    ub = (rng.random((B, P)) * 2.0).astype(np.float32)
    ub[(qs.lens < 100) | (qs.group == OJ.EXCLUDED_GROUP)] = 0
    ub[:, 6] = ub[:, 0]
    total = ub[:, :6].sum(axis=1).astype(np.float32)
    return ub, total


def assert_topk_match(docs_a, scores_a, docs_b, scores_b, num_docs, rtol, atol):
    """Two top-k results of one query agree: the sorted scores match within
    the tolerance, and every doc scored clearly above the cut (the k-th
    score, where top-k tie order may differ) is in both, with its score."""
    docs_a, docs_b = np.asarray(docs_a), np.asarray(docs_b)
    scores_a, scores_b = np.asarray(scores_a), np.asarray(scores_b)
    fa, fb = np.isfinite(scores_a), np.isfinite(scores_b)
    assert fa.sum() == fb.sum(), (fa.sum(), fb.sum())
    assert (docs_a[~fa] == num_docs).all() and (docs_b[~fb] == num_docs).all()
    sa, sb = np.sort(scores_a[fa])[::-1], np.sort(scores_b[fb])[::-1]
    np.testing.assert_allclose(sa, sb, rtol=rtol, atol=atol)
    if not fa.any():
        return
    full = fa.all()
    cut = sa[-1] + (abs(sa[-1]) * rtol + atol) * 2 if full else -np.inf
    ma = dict(zip(docs_a[fa].tolist(), scores_a[fa].tolist()))
    mb = dict(zip(docs_b[fb].tolist(), scores_b[fb].tolist()))
    for d, s in ma.items():
        if s > cut:
            assert d in mb, f"doc {d} (score {s}) missing"
            np.testing.assert_allclose(mb[d], s, rtol=rtol, atol=atol)


def assert_topk_runs_match(docs_a, scores_a, docs_b, scores_b, num_docs, rtol, atol):
    """assert_topk_match for results in which a doc may stand several times
    (stage A under the merge, over rows that are not doc-ascending): the
    sorted scores match within the tolerance, and every entry scored clearly
    above the cut is matched by an entry of the same doc in the other result
    with its score within the tolerance, each entry used once."""
    docs_a, docs_b = np.asarray(docs_a), np.asarray(docs_b)
    scores_a, scores_b = np.asarray(scores_a), np.asarray(scores_b)
    fa, fb = np.isfinite(scores_a), np.isfinite(scores_b)
    assert fa.sum() == fb.sum(), (fa.sum(), fb.sum())
    assert (docs_a[~fa] == num_docs).all() and (docs_b[~fb] == num_docs).all()
    sa, sb = np.sort(scores_a[fa])[::-1], np.sort(scores_b[fb])[::-1]
    np.testing.assert_allclose(sa, sb, rtol=rtol, atol=atol)
    if not fa.any():
        return
    cut = sa[-1] + (abs(sa[-1]) * rtol + atol) * 2 if fa.all() else -np.inf
    left: dict = {}
    for d, s in zip(docs_b[fb].tolist(), scores_b[fb].tolist()):
        left.setdefault(d, []).append(s)
    for d, s in zip(docs_a[fa].tolist(), scores_a[fa].tolist()):
        if s <= cut:
            continue
        near = [x for x in left.get(d, []) if abs(x - s) <= atol + rtol * abs(s)]
        assert near, f"doc {d} (score {s}) missing"
        left[d].remove(min(near, key=lambda x: abs(x - s)))
