"""On-disk index segment reader — the JAX package's format, read as is
(stract_tpu/index/segment.py writes it; bench_corpus.py here writes it too).

A segment directory holds:

    meta.json            num_docs, field stats (total token counts → avg lens),
                         embedding dims, format version
    term_hashes.bin      u64[T]   sorted (term = hash of (field_id, token))
    term_starts.bin      u64[T]   offset of each term's postings
    term_lens.bin        u32[T]   posting count (doc freq) per term
    term_max_tfs.bin     u16[T]   max tf per term
    postings_docs.bin    u32[P]   doc ids, ascending within each term
    postings_tfs.bin     u16[P]   term frequencies
    columns/<name>.bin   dense per-doc numerical columns (schema/numerical_field.py)
    field_lens.bin       u32[num_text_fields, num_docs] token counts (BM25 norms)
    embeddings/<n>.bin   f16[num_docs, dim] dense embedding matrices
    stored.bin+offsets   zlib(msgpack) row store for doc retrieval / snippets

Docs within a segment are ordered by descending pre-computed score, so ascending
doc id = descending static quality.
"""

from __future__ import annotations

import json
import os
import zlib

import msgpack
import numpy as np

from ..schema import TEXT_FIELDS, text_field
from ..schema import numerical_field as nfield
from ..ranking import bm25_math as BM

FORMAT_VERSION = 1

# Embedding fields get their own dense matrices.
EMBEDDING_FIELDS = ("title_embeddings", "keyword_embeddings")

# Fields with per-posting token positions (exact phrase verification).
PHRASE_FIELDS = ("title", "clean_body", "url_for_site_operator")


def pre_computed_score(columns: dict[str, np.ndarray]) -> np.ndarray:
    """Static (query-independent) quality score used to order docs in a segment.

    Linear combination of the static column signals with their default
    coefficients — the same signals the query-time fused pass uses, minus the
    query-dependent ones (region boost, freshness vs 'now'). Role of the
    reference's PreComputedScore field (schema/numerical_field.rs:163).
    """
    n = len(next(iter(columns.values())))
    out = np.zeros(n, dtype=np.float64)
    out += 2.0 * columns["host_centrality"]
    out += 2.0 * columns["page_centrality"]
    out += 0.02 * BM.score_rank(columns["host_centrality_rank"].astype(np.float64), np)
    out += 0.02 * BM.score_rank(columns["page_centrality_rank"].astype(np.float64), np)
    out += 0.01 * columns["is_homepage"]
    out += 0.001 * BM.score_fetch_time(columns["fetch_time_ms"].astype(np.float64), np)
    out += 0.1 * BM.score_reciprocal(columns["tracker_score"].astype(np.float64))
    out += 0.01 * BM.score_reciprocal(columns["num_path_and_query_digits"].astype(np.float64))
    out += 0.1 * BM.score_reciprocal(columns["num_path_and_query_slashes"].astype(np.float64))
    out += 0.01 * BM.score_has_ads(columns["likely_has_ads"].astype(np.float64), np)
    return out


class Segment:
    """Memory-mapped reader for one immutable segment."""

    def __init__(self, path: str):
        self.path = path
        self.name = os.path.basename(os.path.normpath(path))
        with open(os.path.join(path, "meta.json")) as fh:
            self.meta = json.load(fh)
        self.num_docs = self.meta["num_docs"]

        def mm(name, dtype):
            p = os.path.join(path, name)
            if os.path.getsize(p) == 0:
                return np.zeros(0, dtype=dtype)
            return np.memmap(p, dtype=dtype, mode="r")

        self.term_hashes = mm("term_hashes.bin", np.uint64)
        self.term_starts = mm("term_starts.bin", np.uint64)
        self.term_lens = mm("term_lens.bin", np.uint32)
        self.term_max_tfs = mm("term_max_tfs.bin", np.uint16)
        self._term_fields = (
            mm("term_fields.bin", np.uint8)
            if os.path.exists(os.path.join(path, "term_fields.bin"))
            else np.zeros(len(self.term_hashes), dtype=np.uint8)
        )
        self.postings_docs = mm("postings_docs.bin", np.uint32)
        self.postings_tfs = mm("postings_tfs.bin", np.uint16)
        self.positions_offsets = (
            mm("positions_offsets.bin", np.uint64)
            if os.path.exists(os.path.join(path, "positions_offsets.bin"))
            else np.zeros(1, np.uint64)
        )
        self._positions = (
            mm("positions.bin", np.uint16)
            if os.path.exists(os.path.join(path, "positions.bin"))
            else np.zeros(0, np.uint16)
        )
        self.field_lens = mm("field_lens.bin", np.uint32).reshape(len(TEXT_FIELDS), self.num_docs)
        self.stored_offsets = mm("stored_offsets.bin", np.uint64)
        self._stored_path = os.path.join(path, "stored.bin")
        self._stored_fh = None
        self._columns: dict[str, np.ndarray] = {}
        self._embeddings: dict[str, np.ndarray] = {}
        self._value_dicts: dict | None = None

    # -- term dictionary -------------------------------------------------------
    def lookup_terms(self, hashes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """hashes u64[K] → (starts i64[K], lens i64[K]); missing terms get len 0."""
        hashes = np.asarray(hashes, dtype=np.uint64)
        idx = np.searchsorted(self.term_hashes, hashes)
        idx_c = np.clip(idx, 0, max(len(self.term_hashes) - 1, 0))
        if len(self.term_hashes):
            found = self.term_hashes[idx_c] == hashes
        else:
            found = np.zeros(len(hashes), dtype=bool)
        starts = np.where(found, self.term_starts[idx_c].astype(np.int64), 0)
        lens = np.where(found, self.term_lens[idx_c].astype(np.int64), 0)
        return starts, lens

    def positions_for(self, term_h: int, doc_id: int) -> np.ndarray:
        """Token positions of a (phrase-tracked) term within one doc."""
        starts, lens = self.lookup_terms(np.array([term_h], dtype=np.uint64))
        s, l = int(starts[0]), int(lens[0])
        if l == 0 or len(self.positions_offsets) <= 1:
            return np.zeros(0, dtype=np.int64)
        docs = self.postings_docs[s : s + l]
        idx = int(np.searchsorted(docs, doc_id))
        if idx >= l or docs[idx] != doc_id:
            return np.zeros(0, dtype=np.int64)
        o0 = int(self.positions_offsets[s + idx])
        o1 = int(self.positions_offsets[s + idx + 1])
        return self._positions[o0:o1].astype(np.int64)

    def positions_for_docs(self, term_h: int, doc_ids: np.ndarray):
        """Batched positions gather: → (pos i64[M], row i32[M]) — token
        positions of the term in each requested doc, with `row` indexing back
        into doc_ids. ONE searchsorted over the term's posting range + one
        vectorized variable-length range gather (the per-doc positions_for
        loop was O(docs) binary searches — this is the recall-stage
        term-distance path's accessor, 300 docs × terms per query)."""
        empty = (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int32))
        starts, lens = self.lookup_terms(np.array([term_h], dtype=np.uint64))
        s, l = int(starts[0]), int(lens[0])
        if l == 0 or len(self.positions_offsets) <= 1 or len(doc_ids) == 0:
            return empty
        docs = self.postings_docs[s : s + l]
        idx = np.searchsorted(docs, doc_ids)
        idx_c = np.minimum(idx, l - 1)
        rows = np.nonzero(docs[idx_c] == doc_ids)[0]
        if len(rows) == 0:
            return empty
        pi = s + idx_c[rows]
        o0 = self.positions_offsets[pi].astype(np.int64)
        o1 = self.positions_offsets[pi + 1].astype(np.int64)
        counts = o1 - o0
        total = int(counts.sum())
        if total == 0:
            return empty
        # flat indices for [o0_k, o1_k) ranges without a Python loop
        rep_start = np.repeat(o0, counts)
        local = np.arange(total, dtype=np.int64) - np.repeat(
            np.cumsum(counts) - counts, counts)
        pos = np.asarray(self._positions[rep_start + local], dtype=np.int64)
        out_rows = np.repeat(rows, counts).astype(np.int32)
        return pos, out_rows

    def term_fields(self) -> np.ndarray:
        """u8[T]: owning text-field id per term (for per-posting factor precompute)."""
        return np.asarray(self._term_fields, dtype=np.uint8)

    def doc_freq(self, term_h: int) -> int:
        _, lens = self.lookup_terms(np.array([term_h], dtype=np.uint64))
        return int(lens[0])

    def postings(self, term_h: int) -> tuple[np.ndarray, np.ndarray]:
        starts, lens = self.lookup_terms(np.array([term_h], dtype=np.uint64))
        s, l = int(starts[0]), int(lens[0])
        return (
            self.postings_docs[s : s + l].astype(np.int64),
            self.postings_tfs[s : s + l].astype(np.int64),
        )

    # -- value dictionaries ------------------------------------------------------
    def value_dict(self, name: str) -> list:
        """Distinct values of an identity-indexed source ('site'/'domain') —
        used to expand wildcard optic patterns into exact term slots."""
        if self._value_dicts is None:
            p = os.path.join(self.path, "value_dicts.msgpack")
            if os.path.exists(p):
                with open(p, "rb") as fh:
                    self._value_dicts = msgpack.unpackb(fh.read(), raw=False)
            else:
                self._value_dicts = {}
        return self._value_dicts.get(name, [])

    # -- columns ----------------------------------------------------------------
    def column(self, name: str) -> np.ndarray:
        if name not in self._columns:
            nf = nfield(name)
            p = os.path.join(self.path, "columns", f"{name}.bin")
            self._columns[name] = (
                np.memmap(p, dtype=nf.np_dtype(), mode="r") if os.path.getsize(p) else np.zeros(0)
            )
        return self._columns[name]

    def embeddings(self, name: str) -> np.ndarray | None:
        dim = self.meta["embedding_dims"].get(name)
        if not dim:
            return None
        if name not in self._embeddings:
            p = os.path.join(self.path, "embeddings", f"{name}.bin")
            self._embeddings[name] = np.memmap(p, dtype=np.float16, mode="r").reshape(
                self.num_docs, dim
            )
        return self._embeddings[name]

    def avg_field_len(self, field_id: int) -> float:
        f = text_field(field_id)
        total = self.meta["field_total_tokens"].get(f.name, 0)
        return max(total / max(self.num_docs, 1), 1e-6)

    # -- row store ---------------------------------------------------------------
    def stored_doc(self, doc_id: int) -> dict:
        s, e = int(self.stored_offsets[doc_id]), int(self.stored_offsets[doc_id + 1])
        if self._stored_fh is None:
            self._stored_fh = open(self._stored_path, "rb")
        # positional read: concurrent shard threads share this handle, and a
        # seek+read pair interleaves (observed as truncated zlib streams)
        blob = os.pread(self._stored_fh.fileno(), e - s, s)
        return msgpack.unpackb(zlib.decompress(blob), raw=False)
