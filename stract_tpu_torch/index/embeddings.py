"""Doc-side embedding columns: every stored title (and keyword text)
through the dual encoder into the index's dense columns — the write half of
tools/build_bench_embeddings.py, without that tool's training step.

Per segment it writes segments/<s>/embeddings/title_embeddings.bin and
keyword_embeddings.bin, f16[num_docs, dim] (the layout both packages'
segment readers map), and sets meta.json's embedding_dims. Keywords fall
back to the title where a document stores none. Each file is written under
a .tmp name and renamed into place, and meta.json is replaced last: a run
cut short never leaves meta.json naming a half-written matrix.

Batches are double-buffered: batch k+1's row-store reads and tokenisation
run on the host while batch k's forward runs on the device.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

from .segment import Segment

NAMES = ("title_embeddings", "keyword_embeddings")


def write_embedding_columns(index_dir: str, encoder, batch: int = 4096, log=None) -> dict:
    """Embed every document of every segment of `index_dir` with
    `encoder.embed_async`; → {"docs", "dim", "seconds"}."""
    with open(os.path.join(index_dir, "index_meta.json")) as fh:
        names = json.load(fh)["segments"]
    dim = encoder.embedding_dim
    t0 = time.perf_counter()
    docs = 0
    for name in names:
        seg_path = os.path.join(index_dir, "segments", name)
        docs += _write_segment(Segment(seg_path), seg_path, encoder, dim, batch, log)
    return {"docs": docs, "dim": dim, "seconds": time.perf_counter() - t0}


def _write_segment(seg: Segment, seg_path: str, encoder, dim: int, batch: int, log) -> int:
    n = seg.num_docs
    emb_dir = os.path.join(seg_path, "embeddings")
    os.makedirs(emb_dir, exist_ok=True)
    tmp = {k: os.path.join(emb_dir, f"{k}.bin.tmp") for k in NAMES}
    if n:
        _embed_into(seg, n, tmp, encoder, dim, batch, log)
    else:  # an empty segment holds empty matrices (a memmap cannot be empty)
        for p in tmp.values():
            open(p, "wb").close()
    for k, p in tmp.items():
        os.replace(p, os.path.join(emb_dir, f"{k}.bin"))
    meta_p = os.path.join(seg_path, "meta.json")
    with open(meta_p) as fh:
        meta = json.load(fh)
    meta["embedding_dims"] = {k: dim for k in NAMES}
    with open(meta_p + ".tmp", "w") as fh:
        json.dump(meta, fh)
    os.replace(meta_p + ".tmp", meta_p)
    return n


def _embed_into(seg: Segment, n: int, tmp: dict, encoder, dim: int, batch: int, log) -> None:
    mms = {k: np.memmap(p, dtype=np.float16, mode="w+", shape=(n, dim)) for k, p in tmp.items()}

    def dispatch(lo: int):
        hi = min(lo + batch, n)
        titles, keywords = [], []
        for d in range(lo, hi):
            stored = seg.stored_doc(d)
            titles.append(stored.get("title", ""))
            keywords.append(stored.get("keywords", "") or stored.get("title", ""))
        t_fetch = encoder.embed_async(titles, out_dtype=np.float16)
        k_fetch = None if keywords == titles else encoder.embed_async(keywords,
                                                                     out_dtype=np.float16)
        return lo, hi, t_fetch, k_fetch

    t0 = time.perf_counter()
    inflight = dispatch(0)
    while inflight is not None:
        lo, hi, t_fetch, k_fetch = inflight
        inflight = dispatch(hi) if hi < n else None
        mms["title_embeddings"][lo:hi] = t_fetch()
        mms["keyword_embeddings"][lo:hi] = (mms["title_embeddings"][lo:hi] if k_fetch is None
                                            else k_fetch())
        if log is not None and (lo // batch) % 50 == 0:
            log(f"[emb] {hi}/{n} docs ({hi / max(time.perf_counter() - t0, 1e-9):.0f} docs/s)")
    for mm in mms.values():
        mm.flush()
