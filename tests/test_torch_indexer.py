"""The port's index build (stract_tpu_torch/warc.py, index/segment.py
SegmentBuilder, index/merge.py, index/inverted.py's writer half,
entrypoint/indexer.py, canon_index.py) against the JAX package's on the same
seeded WARC files (stract_tpu_torch/warc_corpus.py), on the CPU.

Every file the two packages write is compared byte for byte: the WARC
records, each segment directory, the merged segment, index_meta.json, the
canonical-URL store. The clocks and names are pinned in both packages for
that (time.time stamps insertion_timestamp, time.perf_counter sets
fetch_time_ms, which orders the docs; uuid4 names the segments and the WARC
records): each package's run sees the same sequence.

The one exception is the embedding matrices, with a dual encoder attached:
the port's encoder computes in bf16 as the JAX package's does but rounds at
other places, so the stored f16 rows agree as test_torch_models.py holds the
embeddings (cosine >= 0.999, max abs <= 2e-2) plus the f16 store's rounding
(2^-11 of values below 1: atol 2e-2 + 1e-3 in all). Every other file stays
byte-equal.

A search over the port-built index equals the same search over the
JAX-built one: pass 1's top 10 and the result pages, scores to
test_torch_slice.py's rtol / atol 1e-3.
"""

from __future__ import annotations

import itertools
import os
import shutil
import uuid
from contextlib import ExitStack
from unittest import mock

import numpy as np
import pytest

from stract_tpu_torch import warc_corpus as WC
from torch_parity import assert_topk_match

EMB_COS, EMB_ATOL = 0.999, 2e-2 + 1e-3
SCORE_RTOL = SCORE_ATOL = 1e-3


def pinned(first_id: int = 1):
    """time.time, time.perf_counter, the WARC writers' clock and uuid.uuid4
    as fixed sequences (a fresh one for each package's run; uuids from
    `first_id` on, in the 48 bits a segment's name takes)."""
    ticks, ids = itertools.count(), itertools.count(first_id)
    stack = ExitStack()
    for warc in ("stract_tpu.warc", "stract_tpu_torch.warc"):
        stack.enter_context(mock.patch(f"{warc}._now", return_value=WC.WARC_DATE))
    stack.enter_context(mock.patch("time.time", return_value=1_700_000_000.0))
    stack.enter_context(mock.patch("time.perf_counter",
                                   side_effect=lambda: next(ticks) * 0.0037))
    stack.enter_context(mock.patch("uuid.uuid4",
                                   side_effect=lambda: uuid.UUID(int=next(ids) << 80)))
    return stack


def tree_diff(a: str, b: str, skip=()) -> list:
    """Relative paths whose bytes differ (or that one tree lacks)."""
    def files(root):
        return {os.path.relpath(os.path.join(d, f), root)
                for d, _, fs in os.walk(root) for f in fs}
    fa, fb = files(a), files(b)
    out = sorted(fa ^ fb)
    for rel in sorted(fa & fb):
        if any(rel.endswith(s) for s in skip):
            continue
        with open(os.path.join(a, rel), "rb") as x, open(os.path.join(b, rel), "rb") as y:
            if x.read() != y.read():
                out.append(rel)
    return out


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch-indexer")
    info = WC.write_warcs(str(root / "warc"), files=2, pages=60, seed=5, hosts=30,
                          words=(40, 300))
    return root, info


def _run(pkg: str, info, out: str, worker_kw=None, **kw):
    import importlib

    ind = importlib.import_module(f"{pkg}.entrypoint.indexer")
    if pkg == "stract_tpu_torch":
        kw.setdefault("device", "cpu")
    with pinned():
        return ind.run(info.paths, out, ind.IndexingWorker(**(worker_kw or {})), **kw)


@pytest.fixture(scope="module")
def built(corpus):
    """Both packages' unmerged indexes of the two WARC files."""
    root, info = corpus
    a = _run("stract_tpu", info, str(root / "jax"), merge=False)
    b = _run("stract_tpu_torch", info, str(root / "port"), merge=False)
    return a, b


def test_warc_records_match_jax(tmp_path):
    from stract_tpu.warc import WarcReader as JaxReader
    from stract_tpu.warc import WarcWriter as JaxWriter
    from stract_tpu_torch.warc import WarcReader, WarcWriter

    rng = np.random.default_rng(2)
    pages = [WC.page(rng, 0, i, ["a.org", "b.com"], (20, 80))[:2] for i in range(20)]
    for name, writer in (("jax", JaxWriter), ("port", WarcWriter)):
        with pinned(), writer.open(str(tmp_path / f"{name}.warc.gz")) as w:
            for k, (url, html) in enumerate(pages):
                w.write_record(url, html, status=200 if k % 7 else 404,
                               date="" if k % 3 else WC.WARC_DATE)
    assert (tmp_path / "jax.warc.gz").read_bytes() == (tmp_path / "port.warc.gz").read_bytes()
    recs = [(r.url, r.body, r.record_type, r.date, r.headers, r.http_headers)
            for r in WarcReader.open(str(tmp_path / "jax.warc.gz"))]
    assert recs == [(r.url, r.body, r.record_type, r.date, r.headers, r.http_headers)
                    for r in JaxReader.open(str(tmp_path / "port.warc.gz"))]
    assert [r[0] for r in recs] == [u for u, _ in pages]


def test_segments_match_jax_file_by_file(built, corpus):
    a, b = built
    _, info = corpus
    assert [s.num_docs for s in a.segments] == [s.num_docs for s in b.segments]
    assert b.num_docs == info.pages - info.noindex and len(b.segments) == 2
    for sa, sb in zip(a.segments, b.segments):
        assert tree_diff(sa.path, sb.path) == []
    assert tree_diff(a.path, b.path) == []  # index_meta.json included


def test_merge_matches_jax(built, tmp_path):
    """merge_segments byte-equal, then merge_all and merge_from: the
    manifests and every file."""
    from stract_tpu.index import InvertedIndex as JaxIndex
    from stract_tpu.index.merge import merge_segments as jax_merge
    from stract_tpu_torch.index.inverted import InvertedIndex
    from stract_tpu_torch.index.merge import merge_segments

    a, b = built
    ma = jax_merge(a.segments, str(tmp_path / "ma"))
    mb = merge_segments(b.segments, str(tmp_path / "mb"))
    assert mb.num_docs == sum(s.num_docs for s in b.segments)
    assert mb.meta["num_terms"] <= sum(s.meta["num_terms"] for s in b.segments)
    assert mb.meta["num_postings"] == sum(s.meta["num_postings"] for s in b.segments)
    assert tree_diff(str(tmp_path / "ma"), str(tmp_path / "mb")) == []
    assert ma.num_docs == mb.num_docs

    shutil.copytree(a.path, tmp_path / "ja")
    shutil.copytree(b.path, tmp_path / "pa")
    ja, pa = JaxIndex(str(tmp_path / "ja")), InvertedIndex(str(tmp_path / "pa"), "cpu")
    with pinned(100):
        ja.merge_all()
    with pinned(100):
        pa.merge_all()
    assert len(pa.segments) == 1 and pa.num_docs == b.num_docs
    assert tree_diff(str(tmp_path / "ja"), str(tmp_path / "pa")) == []

    jf, pf = JaxIndex(str(tmp_path / "jf")), InvertedIndex(str(tmp_path / "pf"), "cpu")
    with pinned(200):
        jf.merge_from(a)
        jf.merge_from(ja)
    with pinned(200):
        pf.merge_from(b)
        pf.merge_from(pa)
    assert pf.meta == jf.meta and len(pf.segments) == 3
    assert tree_diff(str(tmp_path / "jf"), str(tmp_path / "pf")) == []


def test_insert_commit_and_temporary_match_jax(tmp_path):
    """insert / commit of prepared docs (two commits), an empty commit, and
    an index opened where none was: the same directory."""
    from conftest import make_doc
    from stract_tpu.index import InvertedIndex as JaxIndex
    from stract_tpu_torch.index.inverted import InvertedIndex

    docs = [make_doc(url=f"https://s{i % 4}.com/p{i}", title=f"title {i} alpha",
                     body=f"body words {i} beta gamma " * (1 + i % 3),
                     host_centrality=0.01 * i) for i in range(30)]
    for name, make in (("jax", lambda p: JaxIndex(p)), ("port", lambda p: InvertedIndex(p, "cpu"))):
        with pinned():
            idx = make(str(tmp_path / name))
            idx.commit()
            for k, d in enumerate(docs):
                idx.insert(dict(d))
                if k == 11:
                    idx.commit()
            idx.commit()
            assert idx.num_docs == 30
    assert tree_diff(str(tmp_path / "jax"), str(tmp_path / "port")) == []
    t = InvertedIndex.temporary("cpu", embedding_dim=8)
    assert t.meta == {"segments": [], "embedding_dim": 8} and t.embedding_dim == 8
    assert InvertedIndex(t.path, "cpu").embedding_dim == 8
    shutil.rmtree(t.path)


def test_indexer_with_centrality_stores_matches_jax(corpus, tmp_path):
    """IndexingWorker with host and page centrality kv stores (as
    tests/test_webpage_indexer.py runs the JAX package's) and a safety
    classifier: the same merged index."""
    from stract_tpu.kv import Db as JaxDb
    from stract_tpu.webpage.safety import SafetyClassifier as JaxSC
    from stract_tpu_torch.kv import Db
    from stract_tpu_torch.webpage.safety import SafetyClassifier

    _, info = corpus
    texts = ["adult explicit nsfw", "cooking recipes", "search engine index", "xxx adult"]
    labels = ["nsfw", "sfw", "sfw", "nsfw"]
    stores = {}
    for name, db_cls in (("jax", JaxDb), ("port", Db)):
        hc = db_cls.open(str(tmp_path / f"{name}-hc"))
        pc = db_cls.open(str(tmp_path / f"{name}-pc"))
        for r, host in enumerate(info.hosts):
            hc.insert(host[4:].encode(), {"centrality": 1.0 / (r + 1), "rank": r})
        for r, url in enumerate(sorted(info.unique)[::3]):
            pc.insert(url.encode(), {"centrality": 0.5 / (r + 1), "rank": r})
        with pinned():
            hc.commit()
            pc.commit()
        stores[name] = (hc, pc)
    info1 = WC.CorpusInfo(paths=info.paths[:1])
    a = _run("stract_tpu", info1, str(tmp_path / "jax"), dict(
        host_centrality=stores["jax"][0], page_centrality=stores["jax"][1],
        safety_classifier=JaxSC.train(texts, labels)))
    b = _run("stract_tpu_torch", info1, str(tmp_path / "port"), dict(
        host_centrality=stores["port"][0], page_centrality=stores["port"][1],
        safety_classifier=SafetyClassifier.train(texts, labels)))
    assert tree_diff(a.path, b.path) == []
    hcol = np.asarray(b.segments[0].column("host_centrality"))
    assert (hcol > 0).all() and (np.asarray(b.segments[0].column("page_centrality")) > 0).any()


@pytest.fixture(scope="module")
def dual_dir(tmp_path_factory, corpus):
    from stract_tpu.models.bert import BertConfig
    from stract_tpu.models.dual_encoder import DualEncoder as JaxDual
    from stract_tpu.models.wordpiece import WordPieceTokenizer

    _, info = corpus
    rng = np.random.default_rng(9)
    texts = [WC.page(rng, 0, i, info.hosts, (40, 80))[1] for i in range(20)]
    tok = WordPieceTokenizer.build(texts, vocab_size=1024)
    path = str(tmp_path_factory.mktemp("dual"))
    jd = JaxDual.random_init(BertConfig.tiny(), tok, seed=4)
    jd.save(path)
    return jd, path


def _check_embeddings(a_dir, b_dir):
    """Every file byte-equal but the embedding matrices, which agree within
    the encoders' tolerance; returns the port's title matrix."""
    from stract_tpu_torch.index.segment import Segment

    assert tree_diff(a_dir, b_dir, skip=("_embeddings.bin",)) == []
    segs = sorted(os.listdir(os.path.join(a_dir, "segments")))
    assert segs == sorted(os.listdir(os.path.join(b_dir, "segments")))
    for name in segs:
        sa = Segment(os.path.join(a_dir, "segments", name))
        sb = Segment(os.path.join(b_dir, "segments", name))
        for field in ("title_embeddings", "keyword_embeddings"):
            ea = np.asarray(sa.embeddings(field), np.float32)
            eb = np.asarray(sb.embeddings(field), np.float32)
            assert ea.shape == eb.shape == (sb.num_docs, 64)
            cos = (ea * eb).sum(1) / (np.linalg.norm(ea, axis=1) * np.linalg.norm(eb, axis=1))
            assert cos.min() >= EMB_COS and np.abs(ea - eb).max() <= EMB_ATOL, field


def test_indexer_embeddings_match_jax(corpus, dual_dir, tmp_path):
    """IndexingWorker(dual_encoder=...) through the port's DualEncoder.embed
    on the CPU: title and keyword embeddings within the tolerance, every
    other file byte-equal, and the stored titles' rows equal to embed(titles)
    within the f16 store's rounding."""
    from stract_tpu_torch.index.segment import Segment
    from stract_tpu_torch.models.dual_encoder import DualEncoder

    _, info = corpus
    jd, path = dual_dir
    pd = DualEncoder.load(path, device="cpu")
    info1 = WC.CorpusInfo(paths=info.paths[:1])
    a = _run("stract_tpu", info1, str(tmp_path / "jax"), dict(dual_encoder=jd), embedding_dim=64)
    b = _run("stract_tpu_torch", info1, str(tmp_path / "port"), dict(dual_encoder=pd),
             embedding_dim=64)
    _check_embeddings(a.path, b.path)
    seg = Segment(b.segments[0].path)
    titles = [seg.stored_doc(d)["title"] for d in range(seg.num_docs)]
    np.testing.assert_allclose(np.asarray(seg.embeddings("title_embeddings"), np.float32),
                               pd.embed(titles), atol=1e-3, rtol=0)


def test_canonical_index_matches_jax(corpus, tmp_path):
    from stract_tpu.canon_index import build_from_warcs as jax_build
    from stract_tpu_torch.canon_index import build_from_warcs

    _, info = corpus
    with pinned():
        ca = jax_build(info.paths, str(tmp_path / "jax"))
    with pinned():
        cb = build_from_warcs(info.paths, str(tmp_path / "port"))
    assert tree_diff(str(tmp_path / "jax"), str(tmp_path / "port")) == []
    urls = sorted(info.unique)
    assert [cb.canonical_of(u) for u in urls] == [ca.canonical_of(u) for u in urls]
    assert sum(not cb.is_canonical(u) for u in urls) > 5


def test_phrases_and_gathers_match_jax(built, corpus, dual_dir, tmp_path):
    from stract_tpu.index import InvertedIndex as JaxIndex
    from stract_tpu.index.inverted import DocPointer as JaxPtr
    from stract_tpu_torch.index.inverted import DocPointer, InvertedIndex
    from stract_tpu_torch.models.dual_encoder import DualEncoder

    a, b = built
    rng = np.random.default_rng(1)
    ptrs = [(int(s), int(d)) for s in (0, 1) for d in
            rng.integers(0, b.segments[s].num_docs, 20)]
    pa, pb = [JaxPtr(*p) for p in ptrs], [DocPointer(*p) for p in ptrs]
    titles = [b.segments[s].stored_doc(d)["title"].lower().split() for s, d in ptrs]
    phrases = [titles[0][:2], titles[1][-2:], ["search", "engine"], ["the"]]
    for ph in phrases:
        assert b.filter_phrases(pb, [ph]) == a.filter_phrases(pa, [ph]), ph
    assert b.filter_phrases(pb, [], field_phrases=[("title", titles[2][:2])]) == \
        a.filter_phrases(pa, [], field_phrases=[("title", titles[2][:2])])
    assert len(b.filter_phrases(pb, [titles[0][:2]])) >= 1
    names = ["host_centrality_rank", "fetch_time_ms", "region", "num_title_tokens"]
    ga, gb = a.gather_columns(pa, names), b.gather_columns(pb, names)
    assert all(np.array_equal(ga[n], gb[n]) for n in names)
    assert b.gather_embeddings(pb, "title_embeddings") is None

    _, info = corpus
    jd, path = dual_dir
    info1 = WC.CorpusInfo(paths=info.paths[:1])
    ea = _run("stract_tpu", info1, str(tmp_path / "jax"), dict(dual_encoder=jd), embedding_dim=64)
    pd = DualEncoder.load(path, device="cpu")
    eb = _run("stract_tpu_torch", info1, str(tmp_path / "port"), dict(dual_encoder=pd),
              embedding_dim=64)
    one = [p for p in ptrs if p[0] == 0]
    ja = ea.gather_embeddings([JaxPtr(*p) for p in one], "title_embeddings")
    jb = eb.gather_embeddings([DocPointer(*p) for p in one], "title_embeddings")
    assert ja.dtype == jb.dtype == np.float32 and ja.shape == jb.shape == (len(one), 64)
    assert np.abs(ja - jb).max() <= EMB_ATOL
    seg_arr = np.array([p[0] for p in one]), np.array([p[1] for p in one])
    np.testing.assert_array_equal(eb.gather_embeddings_arr(*seg_arr, "title_embeddings"), jb)


def _queries(b) -> list:
    seg = b.segments[0]
    out = []
    for d in range(0, seg.num_docs, max(seg.num_docs // 6, 1)):
        words = seg.stored_doc(d)["title"].lower().split()
        out += [" ".join(words[:2]), words[-1]]
    return out + ["search engine", "connection", "running index"]


def test_search_over_the_port_built_index_matches_jax(built, tmp_path):
    """The merged indexes of both packages searched through each package:
    pass 1's top 10 (scores to rtol / atol 1e-3) and the result pages, as
    tests/test_torch_slice.py compares them; each page's own title token
    finds it at rank 1."""
    from stract_tpu.index import InvertedIndex as JaxIndex
    from stract_tpu.ranking.computer import QueryContext as JaxCtx
    from stract_tpu.searcher.query import SearchQuery as JaxSQ
    from stract_tpu_torch.index.inverted import InvertedIndex
    from stract_tpu_torch.ranking.computer import QueryContext
    from stract_tpu_torch.searcher.query import SearchQuery
    from test_torch_slice import _assert_pages_match, jax_searcher, port_searcher

    a, b = built
    shutil.copytree(a.path, tmp_path / "ja")
    shutil.copytree(b.path, tmp_path / "pb")
    ja, pb = JaxIndex(str(tmp_path / "ja")), InvertedIndex(str(tmp_path / "pb"), "cpu")
    with pinned(100):
        ja.merge_all()
    with pinned(100):
        pb.merge_all()
    pb = InvertedIndex(str(tmp_path / "pb"), "cpu")
    queries = _queries(pb)
    n = pb.segments[0].num_docs
    for q in queries:
        terms = q.split()
        pj, sj = ja.search_initial(JaxCtx(raw=q, simple_terms=terms, current_ts=1e9), top_k=10)
        pp, sp = pb.search_initial(QueryContext(raw=q, simple_terms=terms, current_ts=1e9),
                                   top_k=10)
        assert_topk_match([p.doc for p in pj], sj, [p.doc for p in pp], sp, n,
                          SCORE_RTOL, SCORE_ATOL)
    sj, sp = jax_searcher(str(tmp_path / "ja")), port_searcher(str(tmp_path / "pb"))
    for q in queries[:8]:
        r = {"query": q, "return_ranking_signals": True}
        _assert_pages_match(sj.search(JaxSQ.from_json(r)).to_json(),
                            sp.search(SearchQuery.from_json(r)).to_json())
    seg = pb.segments[0]
    for d in range(0, n, 9):
        stored = seg.stored_doc(d)
        tok = stored["title"].split()[-1]
        page = sp.search(SearchQuery.from_json({"query": tok})).to_json()
        assert page["webpages"][0]["url"] == stored["url"], tok


def test_segment_property_documents_build_byte_equal(tmp_path_factory):
    """The documents of tests/test_segment_props.py (hypothesis, few
    examples): each package's SegmentBuilder writes the same segment."""
    from hypothesis import HealthCheck, given, settings

    from stract_tpu.index.segment import SegmentBuilder as JaxBuilder
    from stract_tpu_torch.index.segment import SegmentBuilder
    from test_segment_props import corpus as docs_strategy

    @settings(max_examples=10, deadline=None,
              suppress_health_check=[HealthCheck.too_slow, HealthCheck.data_too_large,
                                     HealthCheck.function_scoped_fixture])
    @given(docs_strategy())
    def check(docs):
        root = tmp_path_factory.mktemp("props")
        for name, cls in (("jax", JaxBuilder), ("port", SegmentBuilder)):
            builder = cls()
            for d in docs:
                builder.add(dict(d))
            builder.build(str(root / name))
        assert tree_diff(str(root / "jax"), str(root / "port")) == []

    check()
