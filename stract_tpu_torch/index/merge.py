"""Segment merge (role of reference indexer merge, entrypoint/indexer/mod.rs:92-144
and tantivy segment merging).

Fully vectorized with numpy: docs from all source segments are re-sorted by
pre-computed score globally, postings are remapped and re-sorted with one
lexsort, stored-doc blobs are copied without recompression.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..schema import TEXT_FIELDS, NUMERICAL_FIELDS
from .segment import Segment, FORMAT_VERSION


def merge_segments(segments: list[Segment], out_path: str) -> Segment:
    os.makedirs(out_path, exist_ok=True)
    os.makedirs(os.path.join(out_path, "columns"), exist_ok=True)
    os.makedirs(os.path.join(out_path, "embeddings"), exist_ok=True)

    doc_counts = [s.num_docs for s in segments]
    total_docs = sum(doc_counts)
    seg_offsets = np.cumsum([0] + doc_counts)

    # Global doc order by descending pre-computed score.
    pcs = np.concatenate([np.asarray(s.column("pre_computed_score"), dtype=np.float64) for s in segments])
    order = np.argsort(-pcs, kind="stable")  # new_id -> global old id
    new_id_of = np.empty(total_docs, dtype=np.int64)
    new_id_of[order] = np.arange(total_docs)

    # ---- postings ------------------------------------------------------------
    # Union term dictionary.
    union_hashes = np.unique(np.concatenate([np.asarray(s.term_hashes) for s in segments]))
    all_term_rank = []
    all_docs = []
    all_tfs = []
    all_pos_lens = []
    all_pos_starts = []
    all_positions = []
    pos_base = 0
    for si, s in enumerate(segments):
        if len(s.postings_docs) == 0:
            continue
        ranks = np.searchsorted(union_hashes, np.asarray(s.term_hashes))
        per_posting_rank = np.repeat(ranks, np.asarray(s.term_lens))
        remapped = new_id_of[np.asarray(s.postings_docs, dtype=np.int64) + seg_offsets[si]]
        all_term_rank.append(per_posting_rank)
        all_docs.append(remapped)
        all_tfs.append(np.asarray(s.postings_tfs))
        offs = np.asarray(s.positions_offsets, dtype=np.int64)
        if len(offs) == len(s.postings_docs) + 1:
            all_pos_lens.append(np.diff(offs))
            all_pos_starts.append(offs[:-1] + pos_base)
        else:
            all_pos_lens.append(np.zeros(len(s.postings_docs), dtype=np.int64))
            all_pos_starts.append(np.zeros(len(s.postings_docs), dtype=np.int64))
        all_positions.append(np.asarray(s._positions, dtype=np.uint16))
        pos_base += len(all_positions[-1])
    if all_docs:
        term_rank = np.concatenate(all_term_rank)
        docs = np.concatenate(all_docs)
        tfs = np.concatenate(all_tfs)
        pos_lens = np.concatenate(all_pos_lens)
        pos_starts = np.concatenate(all_pos_starts)
        src_positions = np.concatenate(all_positions) if pos_base else np.zeros(0, np.uint16)
        perm = np.lexsort((docs, term_rank))
        term_rank, docs, tfs = term_rank[perm], docs[perm], tfs[perm]
        pos_lens, pos_starts = pos_lens[perm], pos_starts[perm]
        # gather variable-length position chunks in the new posting order
        total_pos = int(pos_lens.sum())
        if total_pos:
            grp_starts = np.cumsum(pos_lens) - pos_lens
            within = np.arange(total_pos) - np.repeat(grp_starts, pos_lens)
            merged_positions = src_positions[np.repeat(pos_starts, pos_lens) + within]
        else:
            merged_positions = np.zeros(0, np.uint16)
        pos_offsets = np.zeros(len(docs) + 1, dtype=np.uint64)
        pos_offsets[1:] = np.cumsum(pos_lens)
    else:
        term_rank = np.zeros(0, dtype=np.int64)
        docs = np.zeros(0, dtype=np.int64)
        tfs = np.zeros(0, dtype=np.uint16)
        merged_positions = np.zeros(0, np.uint16)
        pos_offsets = np.zeros(1, dtype=np.uint64)

    term_lens = np.bincount(term_rank, minlength=len(union_hashes)).astype(np.uint32)
    term_starts = np.concatenate([[0], np.cumsum(term_lens)[:-1]]).astype(np.uint64)
    # max tf per term
    term_max = np.zeros(len(union_hashes), dtype=np.uint16)
    if len(tfs):
        np.maximum.at(term_max, term_rank, tfs)
    # owning field per term (any source segment that has the term)
    term_fields = np.zeros(len(union_hashes), dtype=np.uint8)
    for s in segments:
        if len(s.term_hashes):
            ranks = np.searchsorted(union_hashes, np.asarray(s.term_hashes))
            term_fields[ranks] = s.term_fields()

    def w(name, arr):
        arr.tofile(os.path.join(out_path, name))

    w("term_hashes.bin", union_hashes.astype(np.uint64))
    w("term_starts.bin", term_starts)
    w("term_lens.bin", term_lens)
    w("term_max_tfs.bin", term_max)
    w("term_fields.bin", term_fields)
    w("postings_docs.bin", docs.astype(np.uint32))
    w("postings_tfs.bin", tfs.astype(np.uint16))
    w("positions_offsets.bin", pos_offsets)
    w("positions.bin", merged_positions.astype(np.uint16))

    # ---- columns ---------------------------------------------------------------
    for nf in NUMERICAL_FIELDS:
        if nf.dtype == "emb":
            continue
        col = np.concatenate([np.asarray(s.column(nf.name), dtype=nf.np_dtype()) for s in segments])
        w(os.path.join("columns", f"{nf.name}.bin"), col[order])

    flens = np.concatenate([np.asarray(s.field_lens) for s in segments], axis=1)
    w("field_lens.bin", flens[:, order].astype(np.uint32).copy())

    # ---- embeddings --------------------------------------------------------------
    emb_dims = {}
    for name in ("title_embeddings", "keyword_embeddings"):
        mats = [s.embeddings(name) for s in segments]
        if all(m is not None for m in mats) and mats:
            mat = np.concatenate([np.asarray(m) for m in mats], axis=0)[order]
            w(os.path.join("embeddings", f"{name}.bin"), mat.astype(np.float16))
            emb_dims[name] = int(mat.shape[1])

    # ---- stored docs ----------------------------------------------------------------
    offsets = np.zeros(total_docs + 1, dtype=np.uint64)
    with open(os.path.join(out_path, "stored.bin"), "wb") as out:
        pos = 0
        handles = [open(os.path.join(s.path, "stored.bin"), "rb") for s in segments]
        try:
            for new_id, gid in enumerate(order):
                si = int(np.searchsorted(seg_offsets, gid, side="right") - 1)
                local = int(gid - seg_offsets[si])
                so = segments[si].stored_offsets
                s0, s1 = int(so[local]), int(so[local + 1])
                handles[si].seek(s0)
                blob = handles[si].read(s1 - s0)
                out.write(blob)
                pos += len(blob)
                offsets[new_id + 1] = pos
        finally:
            for h in handles:
                h.close()
    w("stored_offsets.bin", offsets)

    # ---- value dictionaries (site/domain, for wildcard optics) ----------------------
    import msgpack

    merged_dicts: dict[str, set] = {}
    for s in segments:
        for key in ("site", "domain"):
            vals = s.value_dict(key)
            if vals:
                merged_dicts.setdefault(key, set()).update(vals)
    with open(os.path.join(out_path, "value_dicts.msgpack"), "wb") as fh:
        fh.write(msgpack.packb({k: sorted(v) for k, v in merged_dicts.items()}, use_bin_type=True))

    field_totals = {f.name: sum(s.meta["field_total_tokens"].get(f.name, 0) for s in segments) for f in TEXT_FIELDS}
    meta = {
        "version": FORMAT_VERSION,
        "num_docs": int(total_docs),
        "num_terms": int(len(union_hashes)),
        "num_postings": int(len(docs)),
        "field_total_tokens": field_totals,
        "embedding_dims": emb_dims,
    }
    with open(os.path.join(out_path, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    return Segment(out_path)
