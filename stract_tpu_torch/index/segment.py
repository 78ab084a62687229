"""On-disk index segment — the port of stract_tpu/index/segment.py: the
writer (SegmentBuilder) and the memory-mapped reader (Segment) of the JAX
package's format, byte for byte (bench_corpus.py writes it too).

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
from collections import Counter
from dataclasses import dataclass

import msgpack
import numpy as np

from ..schema import TEXT_FIELDS, NUMERICAL_FIELDS, text_field
from ..schema import numerical_field as nfield
from ..tokenizer import get_tokenizer
from ..utils.hashing import term_hash
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


@dataclass
class _PendingDoc:
    terms: list  # [(term_hash, tf)]
    field_lens: np.ndarray
    columns: dict
    stored: dict
    embeddings: dict
    positions: dict  # term_hash → np.uint16 positions (phrase-tracked fields only)


class SegmentBuilder:
    """In-memory segment builder (role of tantivy's IndexWriter single-segment path).

    Accepts prepared documents (dicts produced by webpage/html parsing or tests),
    accumulates postings, and writes one immutable segment. Large corpora are
    built as many segments in parallel and merged (index/merge.py), mirroring the
    reference indexer (entrypoint/indexer/mod.rs:92-144).
    """

    def __init__(self, embedding_dim: int = 0):
        self.docs: list[_PendingDoc] = []
        self.embedding_dim = embedding_dim
        self._term_field: dict[int, int] = {}  # term hash → owning field id
        self._value_dicts: dict[str, set] = {}  # site/domain distinct values

    def add(self, doc: dict) -> None:
        """doc keys: text sources (title, clean_text, url, site, domain, ...),
        column values (host_centrality, ...), 'lang', optional 'title_embedding' /
        'keyword_embedding' vectors, optional 'stored' extras."""
        from .. import native

        lang = doc.get("lang", "en")
        is_homepage = bool(doc.get("is_homepage", False))
        term_counts: Counter = Counter()
        positions: dict = {}
        field_lens = np.zeros(len(TEXT_FIELDS), dtype=np.uint32)

        # native fast path: default/bigram/trigram tokenizers share one C++
        # tokenize pass per source text (hash streams, no Python token objects)
        native_cache: dict = {}

        def native_hashes(f, text):
            if f.tokenizer not in ("default", "bigram", "trigram"):
                return None
            if text not in native_cache:
                native_cache[text] = native.tokenize_hashes(text, ngrams=True)
            res = native_cache[text]
            if res is None:
                return None
            uni, bi, tri = res
            return {"default": uni, "bigram": bi, "trigram": tri}[f.tokenizer]

        for f in TEXT_FIELDS:
            if f.homepage_only and not is_homepage:
                continue
            text = doc.get(f.source, "")
            if not text:
                continue
            track_pos = f.name in PHRASE_FIELDS
            stream = native_hashes(f, text)
            if stream is not None:
                field_lens[f.id] = len(stream)
                if len(stream):
                    hashes = native.combine_field(stream, f.id)
                    uniq, counts = np.unique(hashes, return_counts=True)
                    for h, c in zip(uniq.tolist(), counts.tolist()):
                        term_counts[h] += c
                        self._term_field[h] = f.id
                    if track_pos:
                        order = np.argsort(hashes, kind="stable")
                        sorted_h = hashes[order]
                        bounds = np.concatenate([[0], np.nonzero(np.diff(sorted_h))[0] + 1, [len(sorted_h)]])
                        for bi in range(len(bounds) - 1):
                            h = int(sorted_h[bounds[bi]])
                            positions[h] = order[bounds[bi]:bounds[bi + 1]].astype(np.uint16)
                continue
            tokens = get_tokenizer(f.tokenizer).tokenize(text, lang)
            field_lens[f.id] = len(tokens)
            for i_tok, tok in enumerate(tokens):
                th = term_hash(f.id, tok)
                term_counts[th] += 1
                self._term_field[th] = f.id
                if track_pos:
                    positions.setdefault(th, []).append(min(i_tok, 65535))

        columns = {}
        for nf in NUMERICAL_FIELDS:
            if nf.dtype == "emb":
                continue
            columns[nf.name] = doc.get(nf.name, nf.default)
        # Token-count columns alias the text field lens (reference Num*Tokens fields).
        columns["num_url_tokens"] = int(field_lens[text_field("url").id])
        columns["num_title_tokens"] = int(field_lens[text_field("title").id])
        columns["num_clean_body_tokens"] = int(field_lens[text_field("clean_body").id])
        columns["num_description_tokens"] = int(field_lens[text_field("description").id])
        columns["num_url_for_site_operator_tokens"] = int(field_lens[text_field("url_for_site_operator").id])
        columns["num_domain_tokens"] = int(field_lens[text_field("domain").id])
        columns["num_microformat_tags_tokens"] = int(field_lens[text_field("microformat_tags").id])
        columns["num_flattened_schema_tokens"] = int(field_lens[text_field("flattened_schema_org_json").id])
        columns["is_homepage"] = 1 if is_homepage else 0

        stored = {
            "url": doc.get("url", ""),
            "title": doc.get("title", ""),
            "clean_text": doc.get("clean_text", ""),
            "description": doc.get("description", ""),
            "site": doc.get("site", ""),
            "domain": doc.get("domain", ""),
            "schema_org_json": doc.get("schema_org_json", ""),
            "keywords": doc.get("keywords", ""),
            "lang": lang,
            "region": int(doc.get("region", 0)),
            "likely_has_ads": bool(doc.get("likely_has_ads", False)),
            "likely_has_paywall": bool(doc.get("likely_has_paywall", False)),
            "last_updated": int(doc.get("last_updated", 0)),
        }
        if "stored" in doc:
            stored.update(doc["stored"])

        embeddings = {}
        if self.embedding_dim:
            for key, fname in (("title_embedding", "title_embeddings"), ("keyword_embedding", "keyword_embeddings")):
                v = doc.get(key)
                embeddings[fname] = (
                    np.zeros(self.embedding_dim, dtype=np.float16)
                    if v is None
                    else np.asarray(v, dtype=np.float16)
                )

        self.docs.append(
            _PendingDoc(
                sorted(term_counts.items()), field_lens, columns, stored, embeddings,
                {h: np.asarray(v, dtype=np.uint16) for h, v in positions.items()},
            )
        )
        # distinct-value dictionaries for wildcard optic compilation
        for key in ("site", "domain"):
            v = str(doc.get(key, "")).strip().lower()
            if v:
                self._value_dicts.setdefault(key, set()).add(v)

    def __len__(self) -> int:
        return len(self.docs)

    def build(self, path: str) -> "Segment":
        os.makedirs(path, exist_ok=True)
        os.makedirs(os.path.join(path, "columns"), exist_ok=True)
        os.makedirs(os.path.join(path, "embeddings"), exist_ok=True)
        n = len(self.docs)
        # API-boundary invariant: the device sort key packs doc ids into 25
        # bits (ops/scoring.py MAX_SEGMENT_DOCS = 33.5M); larger corpora must
        # be sharded across segments/nodes, matching the reference's per-shard
        # sizing (docs/architecture/search_index.md).
        from ..ops.scoring import MAX_SEGMENT_DOCS

        if n > MAX_SEGMENT_DOCS:
            raise ValueError(
                f"segment would hold {n} docs > MAX_SEGMENT_DOCS="
                f"{MAX_SEGMENT_DOCS}; split the build across segments/shards")

        # Column arrays in insertion order.
        columns: dict[str, np.ndarray] = {}
        for nf in NUMERICAL_FIELDS:
            if nf.dtype == "emb":
                continue
            columns[nf.name] = np.array(
                [d.columns[nf.name] for d in self.docs], dtype=nf.np_dtype()
            )

        # Order docs by descending pre-computed score (stable), assign new ids.
        pcs = pre_computed_score(columns) if n else np.zeros(0)
        order = np.argsort(-pcs, kind="stable")
        columns["pre_computed_score"] = pcs

        # Postings, term-major, doc ids already ascending by construction.
        postings: dict[int, list] = {}
        for new_id, old_id in enumerate(order):
            doc_positions = self.docs[old_id].positions
            for th, tf in self.docs[old_id].terms:
                postings.setdefault(th, []).append(
                    (new_id, min(tf, 65535), doc_positions.get(th))
                )

        term_hashes = np.array(sorted(postings.keys()), dtype=np.uint64)
        term_starts = np.zeros(len(term_hashes), dtype=np.uint64)
        term_lens = np.zeros(len(term_hashes), dtype=np.uint32)
        term_max_tfs = np.zeros(len(term_hashes), dtype=np.uint16)
        term_fields = np.zeros(len(term_hashes), dtype=np.uint8)
        for i, th in enumerate(term_hashes):
            term_fields[i] = self._term_field.get(int(th), 0)
        total = sum(len(v) for v in postings.values())
        p_docs = np.zeros(total, dtype=np.uint32)
        p_tfs = np.zeros(total, dtype=np.uint16)
        pos_offsets = np.zeros(total + 1, dtype=np.uint64)
        pos_chunks: list = []
        pos_total = 0
        off = 0
        for i, th in enumerate(term_hashes):
            plist = postings[int(th)]
            term_starts[i] = off
            term_lens[i] = len(plist)
            for d, tf, pos in plist:
                p_docs[off] = d
                p_tfs[off] = tf
                if pos is not None and len(pos):
                    pos_chunks.append(pos)
                    pos_total += len(pos)
                pos_offsets[off + 1] = pos_total
                off += 1
            term_max_tfs[i] = max(tf for _, tf, _ in plist)

        def w(name, arr):
            arr.tofile(os.path.join(path, name))

        w("term_hashes.bin", term_hashes)
        w("term_starts.bin", term_starts)
        w("term_lens.bin", term_lens)
        w("term_max_tfs.bin", term_max_tfs)
        w("term_fields.bin", term_fields)
        w("postings_docs.bin", p_docs)
        w("postings_tfs.bin", p_tfs)
        w("positions_offsets.bin", pos_offsets)
        w("positions.bin", np.concatenate(pos_chunks).astype(np.uint16) if pos_chunks else np.zeros(0, np.uint16))

        for name, arr in columns.items():
            w(os.path.join("columns", f"{name}.bin"), arr[order] if n else arr)

        field_lens = (
            np.stack([d.field_lens for d in self.docs])[order].T.copy()
            if n
            else np.zeros((len(TEXT_FIELDS), 0), dtype=np.uint32)
        )
        w("field_lens.bin", field_lens.astype(np.uint32))

        emb_dims = {}
        if self.embedding_dim:
            for fname in EMBEDDING_FIELDS:
                mat = np.stack([self.docs[o].embeddings[fname] for o in order]) if n else np.zeros(
                    (0, self.embedding_dim), dtype=np.float16
                )
                w(os.path.join("embeddings", f"{fname}.bin"), mat.astype(np.float16))
                emb_dims[fname] = self.embedding_dim

        # Row store.
        blobs = []
        offsets = np.zeros(n + 1, dtype=np.uint64)
        pos = 0
        for new_id, old_id in enumerate(order):
            blob = zlib.compress(msgpack.packb(self.docs[old_id].stored, use_bin_type=True), level=3)
            blobs.append(blob)
            pos += len(blob)
            offsets[new_id + 1] = pos
        with open(os.path.join(path, "stored.bin"), "wb") as fh:
            for b in blobs:
                fh.write(b)
        w("stored_offsets.bin", offsets)

        field_totals = {f.name: int(field_lens[f.id].sum()) for f in TEXT_FIELDS}
        meta = {
            "version": FORMAT_VERSION,
            "num_docs": n,
            "num_terms": int(len(term_hashes)),
            "num_postings": int(total),
            "field_total_tokens": field_totals,
            "embedding_dims": emb_dims,
        }
        with open(os.path.join(path, "value_dicts.msgpack"), "wb") as fh:
            fh.write(msgpack.packb(
                {k: sorted(v) for k, v in self._value_dicts.items()}, use_bin_type=True
            ))
        with open(os.path.join(path, "meta.json"), "w") as fh:
            json.dump(meta, fh)
        return Segment(path)


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
