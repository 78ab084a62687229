"""Vectorized synthetic web-corpus segment writer (the port of
stract_tpu/bench_corpus.py: the same arrays and bytes for the same docs and
seed, so either package's reader opens the result).

SegmentBuilder processes one doc at a time in Python — fine for real indexing
throughput tests on WARCs, hopeless for standing up a 10M-doc segment in
minutes. This module writes the SAME on-disk segment format (index/segment.py)
with pure-numpy array construction:

  - zipf term distribution over a word vocabulary (documents share a head of
    common words + a long tail, like real web text);
  - per-(field, doc) postings built with one np.unique over packed keys;
  - docs ordered by descending pre-computed score (the serving layout);
  - a compact stored-doc row store so retrieve + snippets work;
  - site/domain identity fields + value dictionaries so site: operators and
    compiled optics work.

The result opens with the ordinary InvertedIndex/Segment readers — nothing in
the serving path is bench-specific. Corpus scale via docs=; the default query
workload generator is also here so chip_smoke.py and tests share it, and so is
synthetic_lightgbm, a seeded LightGBM text dump of random trees at production
sizes (500 trees of 31 leaves) for the forest walk.
"""

from __future__ import annotations

import json
import os
import time
import zlib

import msgpack
import numpy as np

from .schema import TEXT_FIELDS, NUMERICAL_FIELDS, text_field
from .utils.hashing import term_hash

from .index.segment import FORMAT_VERSION, pre_computed_score

VOCAB = 200_000
TITLE_TOKENS = 4
BODY_TOKENS = 60
SITES_PER_DOCS = 2_000  # ~docs/2000 sites


def _zipf_probs(n: int, s: float = 1.07) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1) ** s
    return p / p.sum()


def _draw_terms(rng, probs_cum, n: int) -> np.ndarray:
    return np.searchsorted(probs_cum, rng.random(n)).astype(np.int32)


def token_of(term_id: int) -> str:
    return f"w{term_id}"


def build_corpus_segment(path: str, docs: int, seed: int = 0, log=print) -> None:
    """Write one segment directory with `docs` synthetic pages."""
    os.makedirs(path, exist_ok=True)
    os.makedirs(os.path.join(path, "columns"), exist_ok=True)
    os.makedirs(os.path.join(path, "embeddings"), exist_ok=True)
    rng = np.random.default_rng(seed)
    t_start = time.time()
    D = docs
    n_sites = max(D // SITES_PER_DOCS, 16)

    # ---- columns (generated directly in serving order) ---------------------------
    # per-site centrality, zipf-ish; docs get their site's value
    site_centrality = np.sort(rng.pareto(1.5, n_sites) / 50.0)[::-1].clip(0, 1)
    site_of_doc = rng.integers(0, n_sites, D)
    cols: dict[str, np.ndarray] = {}
    cols["host_centrality"] = site_centrality[site_of_doc]
    cols["page_centrality"] = cols["host_centrality"] * rng.random(D) * 0.1
    cols["host_centrality_rank"] = (n_sites - np.searchsorted(
        np.sort(site_centrality), site_centrality[site_of_doc]
    )).astype(np.float64)
    cols["page_centrality_rank"] = rng.integers(1, D, D).astype(np.float64)
    cols["is_homepage"] = (rng.random(D) < 0.01).astype(np.float64)
    cols["fetch_time_ms"] = rng.integers(10, 2000, D).astype(np.float64)
    cols["tracker_score"] = rng.integers(0, 8, D).astype(np.float64)
    cols["num_path_and_query_digits"] = rng.integers(0, 6, D).astype(np.float64)
    cols["num_path_and_query_slashes"] = rng.integers(1, 5, D).astype(np.float64)
    cols["link_density"] = rng.random(D) * 0.4
    cols["likely_has_ads"] = (rng.random(D) < 0.3).astype(np.float64)

    pcs = pre_computed_score(cols)
    order = np.argsort(-pcs, kind="stable")
    for k in cols:
        cols[k] = cols[k][order]
    pcs = pcs[order]
    site_of_doc = site_of_doc[order]
    log(f"[corpus] columns ready {time.time()-t_start:.0f}s")

    # ---- term streams --------------------------------------------------------------
    # (drawn per ORIGINAL doc, immediately remapped into serving order so the
    # postings' doc ids match the reordered columns)
    probs_cum = np.cumsum(_zipf_probs(VOCAB))
    title_terms = _draw_terms(rng, probs_cum, D * TITLE_TOKENS).reshape(D, TITLE_TOKENS)[order]
    body_terms = _draw_terms(rng, probs_cum, D * BODY_TOKENS).reshape(D, BODY_TOKENS)[order]

    fid_title = text_field("title").id
    fid_body = text_field("clean_body").id
    fid_site = text_field("site_no_tokenizer").id
    fid_domain = text_field("domain_no_tokenizer").id

    # packed (field, doc, term) keys → np.unique gives the postings directly.
    # doc ids fit 24 bits only to 16M; use 34 bits for doc, 18 for term, 8 field.
    def pack(fid: int, doc_ids: np.ndarray, term_ids: np.ndarray) -> np.ndarray:
        return (np.int64(fid) << 56) | (doc_ids.astype(np.int64) << 22) | term_ids.astype(np.int64)

    doc_idx_title = np.repeat(np.arange(D, dtype=np.int64), TITLE_TOKENS)
    doc_idx_body = np.repeat(np.arange(D, dtype=np.int64), BODY_TOKENS)
    keys = np.concatenate([
        pack(fid_title, doc_idx_title, title_terms.reshape(-1)),
        pack(fid_body, doc_idx_body, body_terms.reshape(-1)),
        # one site + one domain identity term per doc (term id = VOCAB + site)
        pack(fid_site, np.arange(D, dtype=np.int64), VOCAB + site_of_doc),
        pack(fid_domain, np.arange(D, dtype=np.int64), VOCAB + site_of_doc),
    ])
    log(f"[corpus] packed {len(keys)/1e6:.0f}M tokens {time.time()-t_start:.0f}s")
    keys, tfs = np.unique(keys, return_counts=True)
    log(f"[corpus] {len(keys)/1e6:.0f}M postings {time.time()-t_start:.0f}s")

    p_field = (keys >> 56).astype(np.uint8)
    p_doc = ((keys >> 22) & ((1 << 34) - 1)).astype(np.uint32)
    p_term = (keys & ((1 << 22) - 1)).astype(np.int32)
    del keys

    # term hash per (field, term id) — vectorized over the (field, term) pairs
    ft_keys = (p_field.astype(np.int64) << 22) | p_term
    uniq_ft, ft_inv = np.unique(ft_keys, return_inverse=True)
    del ft_keys
    hashes_of_ft = np.empty(len(uniq_ft), dtype=np.uint64)
    for i, ft in enumerate(uniq_ft):
        fid, tid = int(ft >> 22), int(ft & ((1 << 22) - 1))
        tok = token_of(tid) if tid < VOCAB else f"site{tid - VOCAB}.com"
        hashes_of_ft[i] = term_hash(fid, tok)
    p_hash = hashes_of_ft[ft_inv]
    del ft_inv
    log(f"[corpus] hashed {len(uniq_ft)} terms {time.time()-t_start:.0f}s")

    # term-major, doc-ascending layout
    perm = np.lexsort((p_doc, p_hash))
    p_hash, p_doc, p_field, tfs = p_hash[perm], p_doc[perm], p_field[perm], tfs[perm]
    del perm
    term_hashes, term_starts_idx, term_lens = np.unique(
        p_hash, return_index=True, return_counts=True
    )
    term_fields = p_field[term_starts_idx]
    term_starts = np.concatenate([[0], np.cumsum(term_lens)[:-1]])
    tfs16 = np.minimum(tfs, 65535).astype(np.uint16)
    term_max = np.zeros(len(term_hashes), dtype=np.uint16)
    np.maximum.at(term_max, np.repeat(np.arange(len(term_hashes)), term_lens), tfs16)
    log(f"[corpus] postings laid out {time.time()-t_start:.0f}s")

    def w(name, arr):
        arr.tofile(os.path.join(path, name))

    w("term_hashes.bin", term_hashes.astype(np.uint64))
    w("term_starts.bin", term_starts.astype(np.uint64))
    w("term_lens.bin", term_lens.astype(np.uint32))
    w("term_max_tfs.bin", term_max)
    w("term_fields.bin", term_fields.astype(np.uint8))
    w("postings_docs.bin", p_doc.astype(np.uint32))
    w("postings_tfs.bin", tfs16)
    n_post = len(p_doc)
    n_terms = len(term_hashes)
    del p_hash, p_doc, p_field, tfs, tfs16

    # ---- columns on disk -------------------------------------------------------------
    for nf in NUMERICAL_FIELDS:
        if nf.dtype == "emb":
            continue
        if nf.name in cols:
            arr = cols[nf.name].astype(nf.np_dtype())
        elif nf.name == "pre_computed_score":
            arr = pcs.astype(np.float64)
        elif nf.name == "host_node_id":
            arr = site_of_doc.astype(np.uint64)
        elif nf.name == "region":
            arr = np.zeros(D, dtype=np.uint64)
        elif nf.name == "last_updated":
            arr = rng.integers(1_600_000_000, 1_700_000_000, D).astype(np.uint64)
        elif nf.name == "num_title_tokens":
            arr = np.full(D, TITLE_TOKENS, dtype=np.uint64)
        elif nf.name == "num_clean_body_tokens":
            arr = np.full(D, BODY_TOKENS, dtype=np.uint64)
        elif nf.name in ("url_without_query_hash1", "url_without_query_hash2",
                         "title_hash1", "title_hash2", "sim_hash"):
            arr = rng.integers(1, 2**63, D).astype(np.uint64)  # unique-ish: no dedup collisions
        elif nf.name == "site_hash1":
            arr = (site_of_doc + 1).astype(np.uint64)
        else:
            arr = np.full(D, nf.default, dtype=nf.np_dtype())
        w(os.path.join("columns", f"{nf.name}.bin"), arr)
    log(f"[corpus] columns written {time.time()-t_start:.0f}s")

    # ---- field lens --------------------------------------------------------------------
    flens = np.zeros((len(TEXT_FIELDS), D), dtype=np.uint32)
    flens[fid_title] = TITLE_TOKENS
    flens[fid_body] = BODY_TOKENS
    flens[fid_site] = 1
    flens[fid_domain] = 1
    w("field_lens.bin", flens)
    del flens

    # ---- stored docs (compact; retrieve/snippets need them) ----------------------------
    offsets = np.zeros(D + 1, dtype=np.uint64)
    toks = [token_of(t) for t in range(VOCAB)]
    body_stored = body_terms[:, :32]  # snippets only need a prefix
    with open(os.path.join(path, "stored.bin"), "wb") as fh:
        pos = 0
        for i in range(D):
            site = f"site{site_of_doc[i]}.com"
            title = " ".join([toks[t] for t in title_terms[i]])
            body = " ".join([toks[t] for t in body_stored[i]])
            blob = zlib.compress(msgpack.packb({
                "url": f"https://{site}/doc{i}",
                "title": title,
                "clean_text": body,
                "description": "",
                "site": site,
                "domain": site,
                "lang": "en",
                "region": 0,
            }, use_bin_type=True), 1)
            fh.write(blob)
            pos += len(blob)
            offsets[i + 1] = pos
    w("stored_offsets.bin", offsets)
    log(f"[corpus] stored docs written {time.time()-t_start:.0f}s")

    # ---- value dicts + meta -------------------------------------------------------------
    sites = [f"site{s}.com" for s in range(n_sites)]
    with open(os.path.join(path, "value_dicts.msgpack"), "wb") as fh:
        fh.write(msgpack.packb({"site": sites, "domain": sites}, use_bin_type=True))
    field_totals = {f.name: 0 for f in TEXT_FIELDS}
    field_totals["title"] = D * TITLE_TOKENS
    field_totals["clean_body"] = D * BODY_TOKENS
    field_totals["site_no_tokenizer"] = D
    field_totals["domain_no_tokenizer"] = D
    meta = {
        "version": FORMAT_VERSION,
        "num_docs": D,
        "num_terms": int(n_terms),
        "num_postings": int(n_post),
        "field_total_tokens": field_totals,
        "embedding_dims": {},
    }
    with open(os.path.join(path, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    log(f"[corpus] done: {D} docs, {n_post} postings, {time.time()-t_start:.0f}s")


def ensure_corpus(root: str, docs: int, seed: int = 0, log=print) -> str:
    """Idempotent: build the index dir (one segment) if absent; → index path."""
    index_path = os.path.join(root, f"bench-{docs}")
    seg_dir = os.path.join(index_path, "segments", "seg-bench")
    meta_p = os.path.join(index_path, "index_meta.json")
    if os.path.exists(meta_p) and os.path.exists(os.path.join(seg_dir, "meta.json")):
        with open(os.path.join(seg_dir, "meta.json")) as fh:
            if json.load(fh).get("num_docs") == docs:
                return index_path
    os.makedirs(os.path.join(index_path, "segments"), exist_ok=True)
    build_corpus_segment(seg_dir, docs, seed=seed, log=log)
    with open(meta_p, "w") as fh:
        json.dump({"segments": ["seg-bench"], "embedding_dim": 0}, fh)
    return index_path


def ensure_segmented_corpus(root: str, docs: list, seeds: list, log=print,
                            workers: int = 1) -> str:
    """Idempotent: an index dir of len(docs) segments, segment i holding
    docs[i] pages drawn from seeds[i] (a shard per segment on a mesh,
    parallel/search.py), written by up to `workers` processes at once;
    → index path."""
    name = "bench-" + "-".join(f"{d}s{s}" for d, s in zip(docs, seeds))
    index_path = os.path.join(root, name)
    names = [f"seg-{i}" for i in range(len(docs))]
    meta_p = os.path.join(index_path, "index_meta.json")
    if os.path.exists(meta_p):
        return index_path
    os.makedirs(os.path.join(index_path, "segments"), exist_ok=True)
    dirs = [os.path.join(index_path, "segments", seg) for seg in names]
    if workers > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(min(workers, len(docs)), mp_context=ctx) as pool:
            list(pool.map(build_corpus_segment, dirs, docs, seeds))
    else:
        for path, d, seed in zip(dirs, docs, seeds):
            build_corpus_segment(path, d, seed=seed, log=log)
    with open(meta_p, "w") as fh:
        json.dump({"segments": names, "embedding_dim": 0}, fh)
    return index_path


def sample_queries(rng, n: int, max_common: int = 300) -> list:
    """Realistic 2-term AND queries: one head term + one mid-frequency term."""
    out = []
    for _ in range(n):
        a = int(rng.integers(0, max_common))
        b = int(rng.integers(max_common, 20_000))
        out.append(f"{token_of(a)} {token_of(b)}")
    return out


def synthetic_lightgbm(num_trees: int, num_leaves: int, num_features: int, seed: int) -> str:
    """A LightGBM text dump of `num_trees` random trees of `num_leaves`
    leaves over `num_features` features, from a numpy seed: the shape of an
    ordinary LambdaRank dump (LightGBM's default num_leaves is 31), for
    exercising the forest walk at production sizes without LightGBM. Each
    tree grows leaf-wise as LightGBM's do: a random leaf of depth below
    ceil(log2(num_leaves)) + 2 (the depth parse_lightgbm walks) splits, the
    left child keeping its leaf index and the right taking the next;
    thresholds and leaf values are normal draws (leaf values scaled by
    0.1), printed to 17 digits."""
    rng = np.random.default_rng(seed)
    depth_cap = int(np.ceil(np.log2(max(num_leaves, 2)))) + 2
    lines = ["tree", "version=v4", "num_class=1", "num_tree_per_iteration=1",
             "label_index=0", f"max_feature_idx={num_features - 1}", "objective=lambdarank",
             "feature_names=" + " ".join(f"Column_{i}" for i in range(num_features)), ""]
    for t in range(num_trees):
        left, right = [], []
        leaf_at = [(None, 0)]  # leaf i: (its parent node, the side), at leaf_depth[i]
        leaf_depth = [0]
        open_leaves = [0]  # the leaves below the cap, in index order
        for _ in range(num_leaves - 1):
            i = open_leaves[rng.integers(len(open_leaves))]
            node, new = len(left), len(leaf_depth)
            parent, side = leaf_at[i]
            if parent is not None:
                (left if side == 0 else right)[parent] = node
            left.append(-(i + 1))
            right.append(-(new + 1))
            leaf_at[i], leaf_depth[i] = (node, 0), leaf_depth[i] + 1
            leaf_at.append((node, 1))
            leaf_depth.append(leaf_depth[i])
            if leaf_depth[i] >= depth_cap:
                open_leaves.remove(i)
            else:
                open_leaves.append(new)
        n = len(left)
        fmt = lambda a: " ".join(f"{v:.17g}" for v in a)  # noqa: E731
        lines += [f"Tree={t}", f"num_leaves={num_leaves}", "num_cat=0",
                  "split_feature=" + " ".join(str(int(f)) for f in
                                              rng.integers(0, num_features, n)),
                  "threshold=" + fmt(rng.normal(size=n)), "decision_type=" + " ".join(["2"] * n),
                  "left_child=" + " ".join(map(str, left)),
                  "right_child=" + " ".join(map(str, right)),
                  "leaf_value=" + fmt(0.1 * rng.normal(size=num_leaves)), "shrinkage=0.1", ""]
    return "\n".join(lines + ["end of trees", ""])
