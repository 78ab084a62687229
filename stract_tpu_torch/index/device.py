"""DeviceSegment — a segment's query-time tensors, on the device the caller
names (the port of stract_tpu/index/device.py).

The numpy builders are the JAX package's, copied: the [n, 3] q16 posting rows
cached on disk as device_postings.bin (the host factor join binary-searches
the same file), the impact prefixes cached as impact_prefix.npz (both
packages share these caches: the files are byte-identical), and the q8 row
layout cached as device_postings_q8.bin (byte-identical too).

DeviceSegment(seg, device, row_layout) holds either layout: "q16", the
[PB, 3] rows of 12 bytes, or "q8", the [PB, 2] rows of 8 bytes that stage A
and the device factor join decode on the card (the JAX package's
STRACT_TPU_ROW_LAYOUT switch, here an argument). Beside the rows it keeps
the block-max side of the impact prefixes: the tf-factor of every prefix
row in the scan's currency, from which impact_bound_f1 bounds what an
L-deep scan has not seen.
"""

from __future__ import annotations

import os
import weakref

import numpy as np
import torch

from ..ranking import bm25_math as BM
from ..ranking import signals as S
from ..schema import text_field

from ..ops import kernels
from ..ops import scoring as O
from .segment import Segment


def _bucket(n: int, minimum: int = 1024) -> int:
    """Next power of two ≥ n — the JAX package's padded shapes, kept so both
    packages hold the same arrays. Above 64M entries, power-of-two
    padding wastes up to half the device memory, so large arrays round to 16M-multiples
    instead (a 512M-posting segment pads ≤ 192MB, not 6GB)."""
    b = minimum
    while b < n and b < (1 << 26):
        b *= 2
    if b >= n:
        return b
    step = 1 << 24
    return ((n + step - 1) // step) * step


def _static_col(seg: Segment, name: str) -> np.ndarray:
    col = np.asarray(seg.column(name), dtype=np.float64)
    if name in ("host_centrality_rank", "page_centrality_rank"):
        return BM.score_rank(col, np)
    if name == "fetch_time_ms":
        return BM.score_fetch_time(col, np)
    if name in ("tracker_score", "num_path_and_query_digits", "num_path_and_query_slashes"):
        return BM.score_reciprocal(col)
    if name == "link_density":
        return BM.score_link_density(col, np)
    if name == "likely_has_ads":
        return BM.score_has_ads(col, np)
    return col  # raw: centralities, is_homepage


_BDP_CHUNK = 16 << 20  # postings per chunk — large fresh allocations fault at
                       # ~65MB/s on some VMs, so the builder reuses chunk buffers


def build_device_postings(seg: Segment) -> np.ndarray:
    """The [n_post, 3] device posting matrix (docs | packed factors | aux),
    cached on disk next to the segment so (a) re-opening skips the compute and
    (b) the DRIVER-mode host lookup can binary-search factors over FULL posting
    ranges via mmap (index/inverted.py _slot_factors_for).

    Chunked with REUSED scratch buffers: a 528M-posting segment's factor math
    involves ~15 array passes, and fresh numpy temporaries of that size spend
    minutes in page faults."""
    cache = os.path.join(seg.path, "device_postings.bin")
    n_post = len(seg.postings_docs)
    if os.path.exists(cache) and os.path.getsize(cache) == n_post * 3 * 4:
        return np.memmap(cache, dtype=np.int32, mode="r").reshape(n_post, 3)
    D = seg.num_docs
    if n_post == 0:
        return np.zeros((0, 3), dtype=np.int32)

    tmp = cache + ".tmp"
    try:
        out = np.memmap(tmp, dtype=np.int32, mode="w+", shape=(n_post, 3))
        on_disk = True
    except OSError:  # read-only segment dir
        out = np.zeros((n_post, 3), dtype=np.int32)
        on_disk = False

    # ---- per-doc arrays (D-sized, computed once) --------------------------------
    static = np.zeros((O.NUM_STATIC, D), dtype=np.float32)
    for i, name in enumerate(O.STATIC_COLUMNS):
        static[i] = _static_col(seg, name)
    static_default = (O.DEFAULT_STATIC_COEFFS[:, None] * static).sum(axis=0)
    del static
    static_scale = _static_scale(static_default)
    # per-doc aux template: q16(static) | region4 | days12 — packing once per
    # DOC then gathering per posting beats packing per posting
    region = np.asarray(seg.column("region"), dtype=np.int64).clip(0, O.NUM_REGIONS - 1)
    last_updated = np.asarray(seg.column("last_updated"), dtype=np.float64)
    static_q = np.clip(np.round(static_default / static_scale), 0, 65535).astype(np.int64)
    days = np.clip((last_updated - O.DAYS_EPOCH) / 86400.0, 0, 4095).astype(np.int64)
    days = np.where(last_updated > 0, np.maximum(days, 1), 0)
    doc_aux = ((static_q << 16) | ((region & 0xF) << O.AUX_REGION_SHIFT) | days).astype(np.int32)
    del static_q, days, region, last_updated, static_default

    # per-field constants + flattened field lens for flat-index gathers
    n_fields = seg.field_lens.shape[0]
    avg = np.array([seg.avg_field_len(fid) for fid in range(n_fields)], dtype=np.float32)
    cf = np.ones(n_fields, dtype=np.float32)
    for fname, c in S.BM25F_FIELD_COEFFS.items():
        cf[text_field(fname).id] = c
    flens_flat = np.ascontiguousarray(seg.field_lens, dtype=np.float32).reshape(-1)
    np.maximum(flens_flat, 1.0, out=flens_flat)
    field_per_posting = np.repeat(
        seg.term_fields().astype(np.int64), np.asarray(seg.term_lens, dtype=np.int64)
    )

    # ---- chunked factor math with reused buffers ----------------------------------
    C = min(_BDP_CHUNK, n_post)
    f32 = lambda: np.empty(C, dtype=np.float32)
    i64 = lambda: np.empty(C, dtype=np.int64)
    b_docs, b_idx = i64(), i64()
    b_t, b_norm, b_f, b_den = f32(), f32(), f32(), f32()
    b_q = np.empty(C, dtype=np.int64)
    b_packed = np.empty(C, dtype=np.int64)
    b_i32 = np.empty(C, dtype=np.int32)
    K1, B = np.float32(BM.K1), np.float32(BM.B)

    for s in range(0, n_post, C):
        e = min(s + C, n_post)
        m = e - s
        docs = b_docs[:m]
        np.copyto(docs, seg.postings_docs[s:e])
        out[s:e, 0] = docs
        fpp = field_per_posting[s:e]

        # flen = field_lens[field, doc] via flat index
        idx = b_idx[:m]
        np.multiply(fpp, D, out=idx)
        idx += docs
        flen = b_f[:m]
        np.take(flens_flat, idx, out=flen)

        # norm = K1*(1-B) + K1*B*flen/avg[field]
        norm = b_norm[:m]
        np.take(avg, fpp, out=norm)
        np.divide(flen, norm, out=norm)
        norm *= K1 * B
        norm += K1 * (np.float32(1.0) - B)

        t = b_t[:m]
        np.copyto(t, seg.postings_tfs[s:e])
        # f1 = t*(K1+1)/(t+norm) → q1
        den = b_den[:m]
        np.add(t, norm, out=den)
        f1 = flen  # reuse
        np.multiply(t, np.float32(BM.K1 + 1.0), out=f1)
        f1 /= den
        f1 *= np.float32(O.FACTOR_SCALE)
        np.rint(f1, out=f1)
        np.clip(f1, 1, 65535, out=f1)
        q = b_q[:m]
        np.copyto(q, f1, casting="unsafe")
        packed = b_packed[:m]
        np.left_shift(q, 16, out=packed)

        # f2 = stf*(K1+1)/(stf+norm) with stf = t*cf[field] → q2
        stf = den  # reuse
        np.take(cf, fpp, out=stf)
        stf *= t
        f2 = t  # reuse
        np.add(stf, norm, out=norm)  # norm := stf + norm
        np.multiply(stf, np.float32(BM.K1 + 1.0), out=f2)
        f2 /= norm
        f2 *= np.float32(O.FACTOR_SCALE)
        np.rint(f2, out=f2)
        np.clip(f2, 1, 65535, out=f2)
        np.copyto(q, f2, casting="unsafe")
        packed |= q
        i32 = b_i32[:m]
        np.copyto(i32, packed, casting="unsafe")  # wraps for q1 >= 32768, by design
        out[s:e, 1] = i32

        np.take(doc_aux, docs, out=i32)
        out[s:e, 2] = i32

    if on_disk:
        out.flush()
        del out
        os.replace(tmp, cache)
        return np.memmap(cache, dtype=np.int32, mode="r").reshape(n_post, 3)
    return out


def _q8_cached(seg: Segment, n_post: int) -> np.ndarray:
    """quantize_rows_q8 of the segment's posting rows, cached on disk next to
    the q16 cache (a segment is reopened several times; the one-pass
    conversion of a 528M-row segment costs ~20 s)."""
    cache = os.path.join(seg.path, "device_postings_q8.bin")
    if os.path.exists(cache) and os.path.getsize(cache) == n_post * 2 * 4:
        return np.memmap(cache, dtype=np.int32, mode="r").reshape(n_post, 2)
    rows = quantize_rows_q8(build_device_postings(seg))
    try:
        with open(cache + ".tmp", "wb") as fh:
            rows.tofile(fh)
        os.replace(cache + ".tmp", cache)
    except OSError:
        pass
    return rows


def _static_scale(static_default: np.ndarray) -> float:
    static_max = float(static_default.max()) if len(static_default) else 1.0
    return max(static_max, 1e-6) / 65535.0


IMPACT_L = 1024


def quantize_rows_q8(rows_q16: np.ndarray) -> np.ndarray:
    """[N, 3] q16 posting rows → the [N, 2] q8 layout (8 B/posting on the device):

        w0 = doc << 7 | region << 3          (doc ≤ 2^25-2, MAX_SEGMENT_DOCS)
        w1 = f1q8 << 24 | f2q8 << 16 | staticq8 << 8 | days8

    BASELINE.md named a 6 B/posting i16-doc-delta variant; measured on the 10M
    bench corpus 4.29% of within-term doc deltas overflow i16 (max delta 9.1M),
    so delta coding needs escape rows that break the fixed-stride tile fetch —
    the exact-doc q8 row is the buildable same-scan-shape point. Factor/static
    widening at decode is q8*257 (255*257 = 65535, so q8 quantization of the
    q16 value x has |q8*257 − x| ≤ 128); f-factors clip to ≥ 1 to keep the
    presence test (factors != 0) working; days quantize to 16-day buckets with
    a ceil that preserves days > 0 (freshness-presence). Only stage A consumes
    these rows — stage B verifies with exact q16 factors (host binary search
    over the disk cache) and exact static columns, so the quantization shifts
    only the candidate cut, not final scores. Chunked: int64 temps over 528M
    rows would otherwise allocate ~25 GB."""
    n = len(rows_q16)
    out = np.empty((n, 2), dtype=np.int32)
    C = 16 << 20
    for s in range(0, n, C):
        e = min(s + C, n)
        doc = rows_q16[s:e, 0].astype(np.int64)
        fac = rows_q16[s:e, 1].astype(np.int64) & 0xFFFFFFFF
        aux = rows_q16[s:e, 2].astype(np.int64) & 0xFFFFFFFF
        f1 = np.clip((((fac >> 16) & 0xFFFF) + 128) // 257, 1, 255)
        f2 = np.clip(((fac & 0xFFFF) + 128) // 257, 1, 255)
        s8 = (((aux >> 16) & 0xFFFF) + 128) // 257
        region = (aux >> O.AUX_REGION_SHIFT) & 0xF
        days = aux & O.AUX_DAYS_MASK
        days8 = np.where(days > 0, np.clip((days + 15) // 16, 1, 255), 0)
        w0 = (doc << 7) | (region << 3)
        w1 = (f1 << 24) | (f2 << 16) | (s8 << 8) | days8
        out[s:e, 0] = (w0 & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        out[s:e, 1] = (w1 & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return out


def build_impact_prefixes(seg: Segment):
    """IMPACT prefixes for long posting lists (the block-max/WAND role): for
    every term with more than IMPACT_L postings, the top-IMPACT_L rows by bm25
    tf-factor among positions >= IMPACT_L (the static-ordered scan already
    covers positions < IMPACT_L, so the two prefixes are DISJOINT and their
    contributions can be summed without dedup). Candidate generation scans the
    union: best-static docs + best-text docs per slot; the exact verify stage
    (ops.score_driver) then rescoring full-range makes pass 1 near-exact.

    → (rows i32[M, 3], starts i64[T], lens i32[T]); cached on disk."""
    cache = os.path.join(seg.path, "impact_prefix.npz")
    T = len(seg.term_hashes)
    if os.path.exists(cache):
        z = np.load(cache)
        # v2: rows within each prefix sorted by tf-factor DESC (any scan depth
        # L sees the best rows; the unseen remainder is bounded by row L-1)
        if len(z["starts"]) == T and int(z.get("v", 1)) >= 2:
            return z["rows"], z["starts"], z["lens"]
    pf = build_device_postings(seg)
    t_starts = np.asarray(seg.term_starts, dtype=np.int64)
    t_lens = np.asarray(seg.term_lens, dtype=np.int64)
    big = np.nonzero(t_lens > IMPACT_L)[0]
    starts = np.zeros(T, dtype=np.int64)
    lens = np.zeros(T, dtype=np.int32)
    chunks = []
    pos = 0
    for ti in big:
        s = int(t_starts[ti]) + IMPACT_L
        e = int(t_starts[ti]) + int(t_lens[ti])
        tail = pf[s:e]
        f1 = (tail[:, 1] >> 16) & 0xFFFF  # bm25 tf-factor quantized (impact key)
        k = min(IMPACT_L, e - s)
        top = np.argpartition(-f1, k - 1)[:k] if k < (e - s) else np.arange(e - s)
        top = top[np.argsort(-f1[top], kind="stable")]  # tf-factor DESC
        chunks.append(np.ascontiguousarray(tail[top]))
        starts[ti] = pos
        lens[ti] = k
        pos += k
    rows = np.concatenate(chunks) if chunks else np.zeros((0, 3), dtype=np.int32)
    try:
        np.savez(cache + ".tmp.npz", rows=rows, starts=starts, lens=lens, v=2)
        os.replace(cache + ".tmp.npz", cache)
    except OSError:
        pass
    return rows, starts, lens


def segment_arrays_from_numpy(*tuples, device):
    """The JAX package's SegmentArrays / QuerySlots / QueryAggregates (or any
    tuple with their field names), as numpy arrays, → the port's tuples of
    tensors on `device`, in the order given."""
    by_name = {cls.__name__: cls for cls in (O.SegmentArrays, O.QuerySlots, O.QueryAggregates)}
    out = []
    for t in tuples:
        cls = by_name[type(t).__name__]
        src = t._asdict() if hasattr(t, "_asdict") else dict(zip(cls._fields, t))
        out.append(O.to_tensors(cls(*[np.asarray(src[f]) for f in cls._fields]), device))
    return out[0] if len(out) == 1 else tuple(out)


class DeviceSegment:
    """Query-time tensors of one segment on `device` ("cuda" or "cpu"; a
    "cuda" device without a card raises in torch), with the posting rows in
    `row_layout` "q16" ([PB, 3]) or "q8" ([PB, 2])."""

    def __init__(self, seg: Segment, device, row_layout: str = "q16"):
        if row_layout not in ("q16", "q8"):
            raise ValueError(f"row_layout is 'q16' or 'q8', not {row_layout!r}")
        self.seg = seg
        self.device = torch.device(device)
        self.row_layout = row_layout
        self.num_docs = seg.num_docs
        D = seg.num_docs
        if D > O.MAX_SEGMENT_DOCS:
            raise ValueError(f"segment too large for packed keys ({D} docs); shard it")
        DB = _bucket(D + 1)

        static = np.zeros((O.NUM_STATIC, DB), dtype=np.float32)
        for i, name in enumerate(O.STATIC_COLUMNS):
            static[i, :D] = _static_col(seg, name)
        static_default = (O.DEFAULT_STATIC_COEFFS[:, None] * static).sum(axis=0)
        static_scale = _static_scale(static_default[:D])

        region = np.zeros(DB, dtype=np.int32)
        region[:D] = np.asarray(seg.column("region"), dtype=np.int64).clip(0, O.NUM_REGIONS - 1)
        last_updated = np.zeros(DB, dtype=np.float32)
        last_updated[:D] = np.asarray(seg.column("last_updated"), dtype=np.float64)

        n_post = len(seg.postings_docs)
        imp_rows, imp_starts, imp_lens = build_impact_prefixes(seg)
        # [doc-ascending postings | impact prefixes | pad]: impact slot ranges
        # live at offset n_post + imp_start; the headroom lets tile fetches
        # read [start, start + L) without clamping
        PB = _bucket(max(n_post + len(imp_rows), 1) + O.DEFAULT_L)
        if row_layout == "q8":
            postings = np.zeros((PB, 2), dtype=np.int32)
            postings[:, 0] = np.int64(D) << 7  # pad rows decode to the pad doc
            postings[:n_post] = _q8_cached(seg, n_post)
            imp_q8 = quantize_rows_q8(imp_rows)
            postings[n_post : n_post + len(imp_rows)] = imp_q8
        else:
            postings = np.zeros((PB, 3), dtype=np.int32)
            postings[:, 0] = D
            postings[:n_post] = build_device_postings(seg)
            postings[n_post : n_post + len(imp_rows)] = imp_rows
        # impact ranges in device offsets (host lookup by term index)
        self.impact_starts = imp_starts + n_post
        self.impact_lens = imp_lens
        # block-max bounds for UB scoring: prefix rows are sorted by tf-factor
        # descending, so rows an L-deep scan does not see (past prefix position
        # L-1, or outside the prefix) all have f1 <= f1[min(L, len)-1]. The
        # bounds are in the scan's currency: under q8 the scan sees the widened
        # q8*257 values, up to 128 above the true q16, and only a bound taken
        # over the widened rows stays an upper bound.
        self._impact_row_starts = imp_starts
        if len(imp_rows) == 0:
            self._impact_f1 = np.zeros(0, dtype=np.float32)
        elif row_layout == "q8":
            self._impact_f1 = (((imp_q8[:, 1] >> 24) & 0xFF) * 257).astype(np.float32)
        else:
            self._impact_f1 = ((imp_rows[:, 1] >> 16) & 0xFFFF).astype(np.float32)

        self.arrays = segment_arrays_from_numpy(O.SegmentArrays(
            postings=postings,
            static_cols=static,
            static_default=static_default,
            static_scale=np.float32(static_scale),
            region_ids=region,
            last_updated=last_updated,
            num_docs=np.int32(D),
        ), device=self.device)
        # the launch-argument cache holds this tuple until this copy goes
        weakref.finalize(self, kernels.forget_seg_args, self.arrays)

    def impact_bound_f1(self, ti: int, L: int) -> float:
        """Quantised-f1 upper bound of term ti's rows unseen by an L-deep scan
        of its impact prefix: the row at prefix position min(L, len)-1 bounds
        the prefix's own tail and every row outside the prefix; 65535 when the
        term has no prefix."""
        iln = int(self.impact_lens[ti])
        if iln == 0:
            return 65535.0
        # L = 0 (prefix not scanned at all) → row 0, the tail's maximum
        pos = int(self._impact_row_starts[ti]) + max(1, min(L, iln)) - 1
        return float(self._impact_f1[pos])
