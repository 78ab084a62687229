"""The port stands alone: no module of stract_tpu_torch, and not
chip_smoke.py, imports the JAX package (an AST scan of every import
statement, lazy ones inside functions included), and each jax-free module
the port copied from the JAX package computes what its original computes on
the same seeded inputs (one case per copied module; the blocked-import run
of the search route and the centrality job is tests/test_torch_slice.py
test_port_imports_without_jax).
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
import os
import zlib

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEXT = ("Rust is a systems programming language; the quick brown fox jumps over "
        "the lazy dog. Running runners ran 3 races in 2021 — naïve café owners "
        "visit https://www.example.com/path?q=1 daily.\nSecond line: rust rust fox.")
WORDS = ["running", "runs", "programming", "languages", "caresses", "ponies", "fox",
         "generously", "relational", "hopefully", "sky", "naïve"]


def _port_sources() -> list:
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "stract_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _absolute_imports(path: str) -> list:
    """(line, module) of every absolute `import` and `from ... import` in a
    file, at any depth (lazy imports inside functions included)."""
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.append((node.lineno, node.module or ""))
    return out


def _names_package(name: str, packages) -> bool:
    return any(name == p or name.startswith(p + ".") for p in packages)


def test_no_port_module_imports_the_jax_package():
    """Every `import` and `from ... import` in the port and the smoke, at any
    depth of the file, names neither stract_tpu nor stract_tpu.*."""
    bad = [f"{os.path.relpath(path, REPO)}:{line} {name}" for path in _port_sources()
           for line, name in _absolute_imports(path) if _names_package(name, ("stract_tpu",))]
    assert len(_port_sources()) > 60 and not bad, bad


@pytest.mark.parametrize("module", ["ops/stage.py", "parallel/pipeline.py", "parallel/__init__.py"])
def test_pipeline_modules_import_neither_jax_nor_the_jax_package(module):
    """The pipeline's modules are in the scan above and import none of jax,
    jaxlib, flax, optax or stract_tpu."""
    path = os.path.join(REPO, "stract_tpu_torch", module)
    assert path in _port_sources()
    bad = [f"{line} {name}" for line, name in _absolute_imports(path)
           if _names_package(name, ("jax", "jaxlib", "flax", "optax", "stract_tpu"))]
    assert not bad, bad


def test_port_imports_no_nltk():
    """The port stems with its own Snowball copy (tokenizer/snowball.py): no
    file of the port or the smoke imports nltk, at any depth."""
    bad = [f"{os.path.relpath(path, REPO)}:{line} {name}" for path in _port_sources()
           for line, name in _absolute_imports(path) if _names_package(name, ("nltk",))]
    assert not bad, bad


def test_port_imports_no_lxml_at_module_level():
    """The card's machine has no lxml: no file of the port imports it at module
    level (entrypoint/entity.py parses with html.parser; leechy.py imports
    lxml inside the call that evaluates an engine's XPath)."""
    bad, lazy = [], []
    for path in _port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        top = {id(n) for n in tree.body}
        for line, name in _absolute_imports(path):
            if _names_package(name, ("lxml",)):
                node = next(n for n in ast.walk(tree) if getattr(n, "lineno", None) == line
                            and isinstance(n, (ast.Import, ast.ImportFrom)))
                (bad if id(node) in top else lazy).append(f"{os.path.relpath(path, REPO)}:{line}")
    assert not bad and [p.split(":")[0] for p in lazy] == ["stract_tpu_torch/leechy.py"], \
        (bad, lazy)


FRESHNESS = ["sitemap.py", "feed.py", "xml_recover.py", "live_index/__init__.py",
             "live_index/wal.py", "live_index/index.py", "live_index/crawler.py",
             "entrypoint/live_index.py", "crawler/__init__.py", "crawler/robots.py",
             "crawler/file_queue.py", "crawler/coordinator.py", "crawler/router.py",
             "crawler/wander_prioritiser.py", "crawler/worker.py", "crawler/planner.py"]


@pytest.mark.parametrize("module", FRESHNESS)
def test_freshness_modules_import_no_lxml_jax_or_nltk_at_any_depth(module):
    """The freshness tier and the crawler run on the card's machine, which
    has no lxml: their sources import none of lxml, jax, jaxlib, flax,
    optax, nltk or stract_tpu in any import statement, lazy ones inside
    functions included (feeds and sitemaps read on xml_recover.py)."""
    path = os.path.join(REPO, "stract_tpu_torch", module)
    assert path in _port_sources()
    bad = [f"{line} {name}" for line, name in _absolute_imports(path)
           if _names_package(name, ("lxml", "jax", "jaxlib", "flax", "optax", "nltk",
                                    "stract_tpu"))]
    with open(path) as fh:
        text = fh.read()
    assert not bad and "importlib" not in text and "__import__" not in text, bad


GRAPH = ["webgraph/betweenness.py", "webgraph/remote.py", "entrypoint/webgraph_server.py",
         "ampc/__init__.py", "ampc/job.py", "ampc/dht.py", "ampc/dht_conn.py", "ampc/worker.py",
         "ampc/coordinator.py", "ampc/harmonic.py", "ampc/shortest_path.py", "ampc/raft.py",
         "entrypoint/ampc.py"]


@pytest.mark.parametrize("module", GRAPH)
def test_graph_role_modules_import_no_lxml_jax_or_nltk_at_any_depth(module):
    """The webgraph servers and the AMPC roles run on the card's machine:
    their sources import none of lxml, jax, jaxlib, flax, optax, nltk or
    stract_tpu in any import statement, lazy ones inside functions
    included."""
    path = os.path.join(REPO, "stract_tpu_torch", module)
    assert path in _port_sources()
    bad = [f"{line} {name}" for line, name in _absolute_imports(path)
           if _names_package(name, ("lxml", "jax", "jaxlib", "flax", "optax", "nltk",
                                    "stract_tpu"))]
    with open(path) as fh:
        text = fh.read()
    assert not bad and "importlib" not in text and "__import__" not in text, bad


# ---- each copied module against its original -------------------------------------------
def _fields(obj) -> tuple:
    return tuple(sorted(dataclasses.asdict(obj).items()))


def _hashing(orig, copy, rng):
    data = [bytes(rng.integers(0, 256, int(n), dtype=np.uint8)) for n in rng.integers(0, 40, 200)]
    ints = rng.integers(0, 2 ** 63, 200, dtype=np.uint64).tolist()
    for d in data:
        assert copy.fnv1a64(d) == orig.fnv1a64(d)
    for a, b in zip(ints, ints[1:]):
        assert copy.splitmix64(a) == orig.splitmix64(a)
        assert copy.combine_u64s(a, b) == orig.combine_u64s(a, b)
    for s in ("www.example.com", "h7.example", "", "naïve.org"):
        assert copy.prehash(s) == orig.prehash(s) and copy.hash128(s) == orig.hash128(s)
        assert copy.term_hash(3, s) == orig.term_hash(3, s)
    np.testing.assert_array_equal(copy.fnv1a64_many(data), [orig.fnv1a64(d) for d in data])


def _kahan(orig, copy, rng):
    xs = (rng.normal(size=2000) * 10.0 ** rng.integers(-8, 8, 2000)).tolist()
    a, b = orig.KahanSum(), copy.KahanSum()
    for x in xs:
        a += x
        b += x
    assert a.value() == b.value()


def _metrics(orig, copy, rng):
    texts = []
    for mod in (orig, copy):
        reg = mod.PrometheusRegistry()
        c = reg.counter("reqs_total", "requests", status="ok")
        g = reg.gauge("launches", "kernel launches", kernel="k1")
        h = reg.histogram("latency_seconds", "latency")
        c.inc(7)
        g.set(3.5)
        for v in np.random.default_rng(1).exponential(0.2, 50):
            h.observe(float(v))
        texts.append(reg.render())
    assert texts[0] == texts[1]


def _bloom(orig, copy, rng):
    keys = rng.integers(0, 2 ** 63, 3000, dtype=np.uint64)
    a, b, c = orig.U64BloomFilter(3000), copy.U64BloomFilter(3000), copy.U64BloomFilter(3000)
    for k in keys.tolist():
        a.insert(k)
        b.insert(k)
    c.insert_many(keys)
    assert a.to_bytes() == b.to_bytes() == c.to_bytes()
    probes = rng.integers(0, 2 ** 63, 500, dtype=np.uint64).tolist()
    assert [a.contains(k) for k in probes] == [c.contains(k) for k in probes]


def _schema(orig, copy, rng):
    assert [_fields(f) for f in copy.TEXT_FIELDS] == [_fields(f) for f in orig.TEXT_FIELDS]
    assert [_fields(f) for f in copy.NUMERICAL_FIELDS] == \
        [_fields(f) for f in orig.NUMERICAL_FIELDS]


def _text_field(orig, copy, rng):
    assert [_fields(f) for f in copy.default_search_fields()] == \
        [_fields(f) for f in orig.default_search_fields()]
    assert _fields(copy.text_field("title")) == _fields(orig.text_field("title"))


def _numerical_field(orig, copy, rng):
    assert _fields(copy.numerical_field("host_centrality")) == \
        _fields(orig.numerical_field("host_centrality"))


def _tokenizer(orig, copy, rng):
    for kind in ("default", "stemmed", "identity", "bigram", "trigram", "url", "newline"):
        assert list(copy.get_tokenizer(kind).tokenize(TEXT)) == \
            list(orig.get_tokenizer(kind).tokenize(TEXT)), kind


def _stemmer(orig, copy, rng):
    assert [copy.stem(w) for w in WORDS] == [orig.stem(w) for w in WORDS]
    assert copy.stem_tokens(WORDS) == orig.stem_tokens(WORDS)


def _signals(orig, copy, rng):
    assert [_fields(s) for s in copy.SIGNALS] == [_fields(s) for s in orig.SIGNALS]
    assert copy.default_coefficients() == orig.default_coefficients()
    assert copy.NUM_SIGNALS == orig.NUM_SIGNALS


def _bm25_math(orig, copy, rng):
    df, tf = rng.integers(1, 1000, 100), rng.integers(0, 30, 100).astype(np.float32)
    flen = rng.integers(1, 500, 100).astype(np.float32)
    for name, args in (("idf_np", (df, 10_000, np)), ("bm25_norm", (flen, 120.0)),
                       ("bm25_tf_factor", (tf, flen, 120.0)),
                       ("bm25f_tf_factor", (tf, 1.5, flen, 120.0)),
                       ("score_rank", (flen, np)), ("score_reciprocal", (flen, np)),
                       ("score_fetch_time", (flen, np)),
                       ("score_update_timestamp", (flen * 1e6, 1.7e9, np)),
                       ("score_link_density", (tf / 30, np)),
                       ("score_has_ads", (tf > 3, np))):
        np.testing.assert_array_equal(getattr(copy, name)(*args), getattr(orig, name)(*args))
    assert copy.idf(17, 10_000) == orig.idf(17, 10_000)


def _proximity(orig, copy, rng):
    for terms in (["quick", "fox"], ["rust", "language"], ["fox", "rust", "line"], ["absent"]):
        assert copy.min_slop(terms, TEXT) == orig.min_slop(terms, TEXT)
    assert [copy.slop_score(s) for s in range(12)] == [orig.slop_score(s) for s in range(12)]


def _term_distance(orig, copy, rng):
    slop = rng.integers(0, 40, 100).astype(np.float64)
    np.testing.assert_array_equal(copy.score_slop(slop), orig.score_slop(slop))
    for _ in range(20):
        pos = [sorted(rng.choice(60, size=int(rng.integers(1, 6)), replace=False).tolist())
               for _ in range(int(rng.integers(2, 4)))]
        assert copy._min_slop_listform(pos) == orig._min_slop_listform(pos)


def _block_of(block_mod, rng_seed: int):
    rng = np.random.default_rng(rng_seed)
    n = 300
    return block_mod.CandidateBlock(
        shard=rng.integers(0, 2, n).astype(np.int32), segment=np.zeros(n, np.int32),
        doc=rng.permutation(n).astype(np.int64), score=rng.normal(size=n).astype(np.float32),
        dedup={k: rng.integers(0, 40, n).astype(np.int64) for k in block_mod.DEDUP_NAMES},
        host_id=rng.integers(0, 50, n).astype(np.int64))


def _pipeline_block(orig, copy, rng):
    a = orig.merge_blocks([_block_of(orig, 5), _block_of(orig, 6)], 100)
    b = copy.merge_blocks([_block_of(copy, 5), _block_of(copy, 6)], 100)
    for col in ("shard", "segment", "doc", "score", "host_id"):
        np.testing.assert_array_equal(getattr(b, col), getattr(a, col))
    ca, cb = a.to_candidates(), b.to_candidates()
    assert [(c.shard, c.pointer.segment, c.pointer.doc, c.score) for c in cb] == \
        [(c.shard, c.pointer.segment, c.pointer.doc, c.score) for c in ca]
    assert type(cb[0].pointer).__module__.startswith("stract_tpu_torch.")


def _candidate_and_collector(orig, copy, rng):
    """ranking.pipeline.candidate with collector: the same candidates
    de-ranked alike by the BucketCollector."""
    cand_o = importlib.import_module("stract_tpu.ranking.pipeline.candidate")
    cand_c = importlib.import_module("stract_tpu_torch.ranking.pipeline.candidate")
    seqs = []
    for cand, coll in ((cand_o, orig), (cand_c, copy)):
        r = np.random.default_rng(9)
        col = coll.BucketCollector(30)
        for i in range(120):
            col.insert(cand.RankedCandidate(
                shard=0, pointer=i, score=float(r.normal()), signals=None,
                dedup={"url_without_query_hash1": int(r.integers(0, 60)),
                       "url_without_query_hash2": 0, "title_hash1": int(r.integers(0, 80)),
                       "site_hash1": int(r.integers(0, 20)), "sim_hash": int(r.integers(0, 4))},
                host_id=int(r.integers(0, 20))))
        seqs.append([(c.pointer, c.score) for c in col.into_sorted_vec()])
    assert seqs[0] == seqs[1]
    assert (copy.ApproxCount(3, True) + copy.ApproxCount(4, False)).to_json() == \
        (orig.ApproxCount(3, True) + orig.ApproxCount(4, False)).to_json()


def _pipeline_stages(orig, copy, rng):
    """recall.rescore, the recall stage without models, the pipeline's
    defaults: the same scores for the same signal rows."""
    cand_o = importlib.import_module("stract_tpu.ranking.pipeline.candidate")
    cand_c = importlib.import_module("stract_tpu_torch.ranking.pipeline.candidate")
    sig = orig.__name__.replace("pipeline.recall", "signals")
    nsig = importlib.import_module(sig).NUM_SIGNALS
    rows = np.random.default_rng(4).random((20, nsig)).astype(np.float32)

    class Ctx:
        def coeff(self, s):
            return 1.0 + 0.01 * s.id

    out = []
    for cand, rec in ((cand_o, orig), (cand_c, copy)):
        cs = [cand.RankedCandidate(shard=0, pointer=i, score=0.0, signals=rows[i].copy())
              for i in range(20)]
        rec.rescore(Ctx(), cs)
        out.append([c.score for c in cs])
        assert not rec.RecallStage().has_scorers
    assert out[0] == out[1]


def _pipeline_package(orig, copy, rng):
    import types

    def names(pkg):  # submodules appear as attributes once something imports them
        return sorted(n for n in dir(pkg) if not n.startswith("_")
                      and not isinstance(getattr(pkg, n), types.ModuleType))
    assert copy.NUM_PIPELINE_RANKING_RESULTS == orig.NUM_PIPELINE_RANKING_RESULTS
    assert names(copy) == names(orig)


def _bangs(orig, copy, rng):
    from stract_tpu.query.query import Query as JQ
    from stract_tpu_torch.query.query import Query as PQ

    for q in ("!w rust language", "rust !gh fox", "no bang here", "!nosuchbang x"):
        a, b = orig.Bangs.builtin().get(JQ.parse(q)), copy.Bangs.builtin().get(PQ.parse(q))
        assert (a is None and b is None) or a.to_json() == b.to_json(), q


def _snippet(orig, copy, rng):
    for terms in (["rust", "fox"], ["running"], ["absent"], []):
        a, b = orig.generate(terms, TEXT, "a description"), copy.generate(terms, TEXT,
                                                                          "a description")
        assert (a.text(), a.html()) == (b.text(), b.html()), terms
    assert copy.sentence_passages(TEXT) == orig.sentence_passages(TEXT)


def _prettifier(orig, copy, rng):
    import json

    from test_prettifier import so_schema

    for page in ({"url": "https://stackoverflow.com/questions/1",
                  "schema_org_json": json.dumps(so_schema())},
                 {"url": "https://example.com/", "schema_org_json": json.dumps(so_schema())},
                 {"url": "https://stackoverflow.com/q/2", "schema_org_json": "not json"}):
        assert copy.rich_snippet(page) == orig.rich_snippet(page)


def _native(orig, copy, rng):
    assert copy.available() == orig.available()  # the same library (native/), or neither
    for text in (TEXT, "", "ßtraße"):
        a, b = orig.tokenize_hashes(text, ngrams=True), copy.tokenize_hashes(text, ngrams=True)
        assert (a is None) == (b is None)
        if a is not None:
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    h = rng.integers(0, 2 ** 63, 100, dtype=np.uint64)
    np.testing.assert_array_equal(copy.combine_field(h, 5), orig.combine_field(h, 5))
    postings = np.stack([np.arange(0, 400, 2), rng.integers(0, 2 ** 31, 200),
                         np.zeros(200)], axis=1).astype(np.int32)
    cand = rng.integers(0, 400, 50).astype(np.int32)
    outs = [np.zeros((2, 50), np.int32) for _ in range(2)]
    done = [mod.slot_factors(postings, np.array([0, 100]), np.array([100, 100]), cand, out)
            for mod, out in zip((orig, copy), outs)]
    assert done[0] == done[1]
    np.testing.assert_array_equal(outs[0], outs[1])


def _kv(orig, copy, rng):
    import tempfile

    items = {f"k{i}".encode(): {"v": float(x)} for i, x in enumerate(rng.random(300))}
    with tempfile.TemporaryDirectory() as d:
        for name, mod in (("o", orig), ("c", copy)):
            db = mod.Db.open(os.path.join(d, name))
            for k, v in items.items():
                db.insert(k, v)
            db.commit()
        for reader in (orig, copy):
            for name in ("o", "c"):
                assert dict(reader.Db.open(os.path.join(d, name)).items()) == items


def _edge_node(orig, copy, rng):
    for url in ("https://www.Example.com/a?b=1", "http://sub.host.org:8080/x", "h7.example"):
        assert copy.Node.from_url(url).id() == orig.Node.from_url(url).id()
        assert str(copy.Node.from_url(url).into_host()) == str(orig.Node.from_url(url).into_host())
        assert copy.normalize_host(url) == orig.normalize_host(url)


def _webgraph_edge(orig, copy, rng):
    e_o, e_c = orig.Edge("a.com", "b.com", label="x"), copy.Edge("a.com", "b.com", label="x")
    assert _fields(e_o) == _fields(e_c)
    assert int(copy.RelFlags.NOFOLLOW) == int(orig.RelFlags.NOFOLLOW)


def _hll_init(orig, copy, rng):
    for n, p in ((1000, 6), (77, 4), (5000, 10)):
        np.testing.assert_array_equal(copy.init_registers(n, p, seed=3),
                                      orig.init_registers(n, p, seed=3))


def _config(orig, copy, rng):
    for kind, name in (("centrality", "centrality.toml"), ("api", "api.toml"),
                       ("search-server", "search_server.toml"), ("web-spell", "web_spell.toml"),
                       ("indexer", "indexer.toml"), ("site-stats", "web_spell.toml")):
        path = os.path.join(REPO, "configs", name)
        a, b = orig.load_config(kind, path), copy.load_config(kind, path)
        assert _fields(a) == _fields(b), kind
    for kind, name in (("live-index", "live_index.toml"), ("crawler", "crawler/worker.toml"),
                       ("crawler", "crawler/coordinator.toml"), ("webgraph", "webgraph.toml"),
                       ("webgraph-server", "webgraph_server.toml")):
        path = os.path.join(REPO, "configs", name)
        assert _fields(orig.load_config(kind, path)) == _fields(copy.load_config(kind, path))
    ess = {"index_path": "e", "image_store_path": "i", "port": 9, "gossip": {"addr": "h:1"}}
    assert _fields(orig._from_dict(orig.EntitySearchServerConfig, ess)) == \
        _fields(copy._from_dict(copy.EntitySearchServerConfig, ess))
    ampc = {"webgraph_path": "g", "shard": 2, "num_shards": 4, "precision": 8, "source": "a.com",
            "peers": ["127.0.0.1:1", "127.0.0.1:2"], "wait_s": 5.0, "gossip": {"addr": "h:1"}}
    assert _fields(orig._from_dict(orig.AmpcConfig, ampc)) == \
        _fields(copy._from_dict(copy.AmpcConfig, ampc))
    for cls in ("AmpcConfig", "WebgraphServerConfig", "WebgraphConstructConfig"):
        assert _fields(getattr(orig, cls)()) == _fields(getattr(copy, cls)()), cls
    assert {k: v.__name__ for k, v in orig.CONFIG_TYPES.items()} == \
        {k: v.__name__ for k, v in copy.CONFIG_TYPES.items()}
    g = {"addr": "127.0.0.1:47001", "seeds": ["127.0.0.1:47000", "10.0.0.2:9"]}
    a, b = orig._from_dict(orig.GossipConfig, g), copy._from_dict(copy.GossipConfig, g)
    assert (a.addr_tuple(), a.seed_tuples()) == (b.addr_tuple(), b.seed_tuples())


class _Echo:
    def echo(self, body):
        return body

    def fail(self, body):
        raise ValueError("no")


def _sonic(orig, copy, rng):
    """A server of either package answers a client of the other, numpy
    arrays and errors included."""
    body = {"a": rng.random((3, 4)).astype(np.float32), "b": [1, "x", None],
            "c": rng.integers(0, 9, 5, dtype=np.int64), "d": b"raw"}
    assert orig.unpack(copy.pack(body))["d"] == body["d"]
    for srv_mod, cli_mod in ((orig, copy), (copy, orig)):
        srv = srv_mod.serve_in_thread(_Echo())
        try:
            cli = cli_mod.RemoteClient(srv.addr, timeout=30)
            got = cli.send("echo", body)
            np.testing.assert_array_equal(got["a"], body["a"])
            np.testing.assert_array_equal(got["c"], body["c"])
            assert got["b"] == body["b"] and got["d"] == body["d"]
            with pytest.raises(cli_mod.RpcError):
                cli.send("fail", {})
            cli.close()
        finally:
            srv.stop()


def _cluster(orig, copy, rng):
    """Members of the two packages' gossip find each other."""
    svc = dict(kind="search-server", host=("127.0.0.1", 4711), shard=3)
    assert orig.Service(**svc).to_json() == copy.Service(**svc).to_json()
    a = orig.Cluster.join(orig.Service("api"), interval=0.05)
    b = copy.Cluster.join(copy.Service(**svc), seeds=[a.gossip_addr], interval=0.05)
    try:
        found = a.await_member(lambda m: m.service.kind == "search-server", timeout=60)
        assert found is not None and found.service.shard == 3
        assert b.await_member(lambda m: m.service.kind == "api", timeout=60) is not None
    finally:
        a.shutdown()
        b.shutdown()


def _replication(orig, copy, rng):
    """The selectors choose alike; a sharded client of either package fans
    out to servers of the other."""
    ids = [0, 3, 5]
    assert copy.AllShardsSelector().select(ids) == orig.AllShardsSelector().select(ids)
    assert copy.SpecificShardSelector(3).select(ids) == orig.SpecificShardSelector(3).select(ids)
    assert copy.SpecificReplicaSelector(1).select(ids) == \
        orig.SpecificReplicaSelector(1).select(ids)
    sonic = importlib.import_module(orig.__name__.replace("replication", "sonic"))
    srvs = [sonic.serve_in_thread(_Echo()) for _ in range(2)]
    try:
        for mod in (orig, copy):
            cli = mod.ShardedClient({i: mod.ReplicatedClient([s.addr]) for i, s in enumerate(srvs)})
            assert cli.send("echo", {"x": 1}) == {0: [{"x": 1}], 1: [{"x": 1}]}
    finally:
        for s in srvs:
            s.stop()


def _remote_cp(orig, copy, rng):
    """A tree served by either package's RemoteCpService downloads alike
    through the other's download_tree."""
    import tempfile

    from stract_tpu.distributed.sonic import serve_in_thread

    from stract_tpu_torch.distributed.sonic import RemoteClient

    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "src")
        os.makedirs(os.path.join(src, "sub"))
        files = {"a.bin": rng.bytes(3 << 19), os.path.join("sub", "b.txt"): b"hello"}
        for rel, data in files.items():
            with open(os.path.join(src, rel), "wb") as fh:
                fh.write(data)
        for srv_mod, cli_mod in ((orig, copy), (copy, orig)):
            srv = serve_in_thread(srv_mod.RemoteCpService(src))
            try:
                dest = os.path.join(d, f"dst-{srv_mod.__name__}")
                assert cli_mod.download_tree(RemoteClient(srv.addr), dest) == len(files)
                for rel, data in files.items():
                    with open(os.path.join(dest, rel), "rb") as fh:
                        assert fh.read() == data
                assert cli_mod.download_tree(RemoteClient(srv.addr), dest) == 0  # digests match
            finally:
                srv.stop()


def _distributed_package(orig, copy, rng):
    names = lambda pkg: sorted(n for n in dir(pkg) if not n.startswith("_"))  # noqa: E731
    assert [n for n in names(orig) if n not in names(copy)] == []


def _executor(orig, copy, rng):
    xs = rng.integers(0, 100, 50).tolist()
    for n in (1, 4, None):
        assert copy.Executor.multi_thread(n).map(lambda x: x * x, xs) == \
            orig.Executor.multi_thread(n).map(lambda x: x * x, xs)
    assert copy.Executor.single_thread().map(str, xs) == orig.Executor.single_thread().map(str, xs)


def _optic(orig, copy, rng):
    src = ('DiscardNonMatching; Rule { Matches { Site("|a.com|") }, Matches { Domain("b*") } };'
           ' Rule { Matches { Url("*spam*") }, Action(Discard) }; Like(Site("c.org"));')
    a, b = orig.Optic.parse(src), copy.Optic.parse(src)
    assert a.to_string() == b.to_string()
    for m in ("a.com", "b.org", "https://x.io/spam/1", "c.org"):
        assert [r.matches({"site": m, "domain": m, "url": m}) for r in a.rules] == \
            [r.matches({"site": m, "domain": m, "url": m}) for r in b.rules]
    (ga, ra), (gb, rb) = a.compile_groups(), b.compile_groups()
    assert [(g.required, g.excluded, g.pairs) for g in ga] == \
        [(g.required, g.excluded, g.pairs) for g in gb]
    assert ra.to_string() == rb.to_string()


def _spell_parts(orig, copy, rng):
    for mod in (orig, copy):
        assert mod.__name__.endswith(("term_freqs", "stupid_backoff", "error_model"))
    if orig.__name__.endswith("error_model"):
        for a, b in (("teh", "the"), ("fox", "foxes"), ("", "ab")):
            assert copy.possible_errors(a, b) == orig.possible_errors(a, b)
        return
    cls = "TermFreqs" if orig.__name__.endswith("term_freqs") else "StupidBackoff"
    a, b = getattr(orig, cls)(), getattr(copy, cls)()
    a.observe_text(TEXT)
    b.observe_text(TEXT)
    if cls == "TermFreqs":
        assert [a.freq(w) for w in ("rust", "fox", "zz")] == [b.freq(w) for w in ("rust", "fox",
                                                                                   "zz")]
    else:
        for ctx in ((), ("rust",), ("the", "quick")):
            assert a.score("fox", ctx) == b.score("fox", ctx)


def _spell_checker(orig, copy, rng):
    import importlib

    out = []
    for mod in (orig, copy):
        pkg = importlib.import_module(mod.__name__.rsplit(".", 1)[0])
        f, lm = pkg.TermFreqs(), pkg.StupidBackoff()
        f.observe_text(TEXT * 4)
        lm.observe_text(TEXT * 4)
        c = mod.SpellChecker(f, lm).correct("rust programing lnguage fox")
        out.append(c.to_json() if c else None)
    assert out[0] == out[1]


def _widgets(orig, copy, rng):
    for q in ("2 + 3 * 4", "sqrt(2)^2", "define happy", "big meaning", "plain words", "1/0"):
        assert copy.WidgetManager().widget(q) == orig.WidgetManager().widget(q), q


def _autosuggest(orig, copy, rng):
    qs = ["rust lang", "rust lang", "rust book", "python", "Rust Async"]
    for p in ("ru", "rust l", "p", "x"):
        assert copy.Autosuggest.from_queries(qs).suggest(p) == \
            orig.Autosuggest.from_queries(qs).suggest(p)


def _linear(orig, copy, rng):
    import importlib

    sig = importlib.import_module(orig.__name__.replace("models.linear", "signals"))
    x = rng.random((50, sig.NUM_SIGNALS)).astype(np.float32)
    y = rng.random(50)
    a, b = orig.LinearRegression.train(x, y), copy.LinearRegression.train(x, y)
    assert a.to_json() == b.to_json()
    np.testing.assert_array_equal(copy.LinearRegression.from_json(a.to_json()).predict(x),
                                  a.predict(x))


def _inbound(orig, copy, rng):
    import tempfile

    from stract_tpu_torch.webgraph.store import write_graph

    names = [f"h{i}.com" for i in range(12)]
    src, dst = rng.integers(0, 12, 60), rng.integers(0, 12, 60)
    with tempfile.TemporaryDirectory() as d:
        write_graph(d, names, src, dst, host_graph=True)
        a = orig.InboundSimilarity(importlib.import_module("stract_tpu.webgraph.store").Webgraph(d))
        b = copy.InboundSimilarity(importlib.import_module(
            "stract_tpu_torch.webgraph.store").Webgraph(d))
        for hosts in (["h1.com"], ["h2.com", "h3.com"]):
            assert a.similar_hosts(hosts, 5) == b.similar_hosts(hosts, 5)
    assert copy.host_node_id("h1.com") == orig.host_node_id("h1.com")


def _zim(orig, copy, rng):
    import tempfile

    arts = [(f"a{i}", f"title {i}", "<p>" + "x" * int(n) + "</p>")
            for i, n in enumerate(rng.integers(0, 200, 20))]
    with tempfile.TemporaryDirectory() as d:
        data = []
        for name, mod in (("o", orig), ("c", copy)):
            w = mod.ZimWriter()
            for a in arts:
                w.add_article(*a)
            w.write(os.path.join(d, name))
            with open(os.path.join(d, name), "rb") as fh:
                data.append(fh.read())
        assert data[0] == data[1]
        z = copy.ZimFile(os.path.join(d, "o"))
        assert [(a.url, a.title, a.text()) for a in z.articles()] == \
            [(u, t, h) for u, t, h in arts]
        z.close()


def _image_store(orig, copy, rng):
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        blobs = [rng.bytes(int(n)) for n in rng.integers(1, 300, 10)]
        a, b = orig.ImageStore(os.path.join(d, "o")), copy.ImageStore(os.path.join(d, "c"))
        assert [a.insert(f"k{i}", x) for i, x in enumerate(blobs)] == \
            [b.insert(f"k{i}", x) for i, x in enumerate(blobs)]
        assert [copy.ImageStore(os.path.join(d, "o")).get(f"k{i}") for i in range(10)] == blobs
        many = copy.ImageStore(os.path.join(d, "m"))
        assert many.insert_many({f"k{i}": x for i, x in enumerate(blobs)}) == \
            [a.insert(f"k{i}", x) for i, x in enumerate(blobs)]
        assert [orig.ImageStore(os.path.join(d, "m")).get(f"k{i}") for i in range(10)] == blobs
        assert len(many.index.segments) == 1


def _entity_index(orig, copy, rng):
    import tempfile

    words = [f"w{i}" for i in range(12)]
    ents = [(" ".join(rng.choice(words, 2)), " ".join(rng.choice(words, 8))) for _ in range(40)]
    with tempfile.TemporaryDirectory() as d:
        out = []
        for name, mod in (("o", orig), ("c", copy)):
            ei = mod.EntityIndex(os.path.join(d, name))
            for t, a in ents:
                ei.insert(mod.Entity(t, a))
            out.append([[e.to_json() for e in ei.search(q, 3)] for q in words + [ents[0][0]]])
            sm = mod.SidebarManager(ei)
            out.append([sm.sidebar(q) for q in words])
        assert out[0] == out[2] and out[1] == out[3]


def _entity_parse(orig, copy, rng):
    html = ("<html><body><p>" + "an abstract long enough to be kept here. " * 2 + "</p>"
            "<table class='infobox'><tr><th>k</th><td>v</td></tr><tr><td><img src='i.png'>"
            "</td></tr></table></body></html>")
    assert copy.parse_wiki_article(html, "T").to_json() == \
        orig.parse_wiki_article(html, "T").to_json()


def _hyperloglog(orig, copy, rng):
    a, b = orig.HyperLogLog(8), copy.HyperLogLog(8)
    values = rng.integers(0, 2 ** 63, 500, dtype=np.uint64)
    a.add_many_u64(values)
    b.add_many_u64(values)
    assert a.to_bytes() == b.to_bytes() and a.size() == b.size()


def _user_count(orig, copy, rng):
    a, b = orig.UserCount(8), copy.UserCount(8)
    for i, u in enumerate(rng.integers(0, 300, 400)):
        a.observe(str(u), now=1e9 + 600 * i)
        b.observe(str(u), now=1e9 + 600 * i)
    assert (a.daily_active(), a.monthly_active()) == (b.daily_active(), b.monthly_active())


def _improvement(orig, copy, rng):
    qa, qb = orig.LeakyQueue(5), copy.LeakyQueue(5)
    for x in rng.integers(0, 100, 12).tolist():
        qa.push(x)
        qb.push(x)
    assert qa.drain() == qb.drain()


def _docs(orig, copy, rng):
    assert copy.openapi_spec() == orig.openapi_spec() and copy.docs_html() == orig.docs_html()


def _leechy(orig, copy, rng):
    serp = '<a class="result__a" href="https://a.b/">x</a><a href="https://c.d/">y</a>'
    engines = lambda m: [m.Engine("e", "https://e/?q={query}", "//a")]  # noqa: E731
    fetch = lambda url: (200, serp, 0)  # noqa: E731
    assert copy.Leechy(fetch, engines(copy)).annotate(["q"]) == \
        orig.Leechy(fetch, engines(orig)).annotate(["q"])


def _optics_lsp(orig, copy, rng):
    assert copy.DOCS == orig.DOCS and copy.COMPLETIONS == orig.COMPLETIONS
    for text in ('Rule { Matches { Site("|x|" } };', "Rule {};", 'Like(Site("a.com"));'):
        assert copy._diagnostics(text) == orig._diagnostics(text)
        assert copy._word_at(text, 0, 3) == orig._word_at(text, 0, 3)


# ---- the index build's copies (tests/test_torch_webpage.py, test_torch_indexer.py and
# test_torch_configure.py hold them at size) ---------------------------------------------
PAGE = ('<!DOCTYPE html><html lang="en"><head><title>Rust &amp; the borrow checker</title>'
        '<meta name="description" content="d"><link rel="canonical" href="https://c.org/x">'
        '<script type="application/ld+json">{"@type": "Article", "headline": "h"}</script>'
        '<script src="https://www.googletagmanager.com/gtm.js"></script></head><body>'
        '<nav><a href="/a" rel="nofollow">nav</a></nav><h1>Rust</h1><p>' + TEXT + '</p>'
        '<div itemscope itemtype="https://schema.org/Recipe"><span itemprop="name">n</span>'
        '</div><footer><a href="https://other.org/">f</a></footer></body></html>')


def _pinned_clock():
    from unittest import mock

    return mock.patch("time.time", return_value=1.7e9)


def _simhash(orig, copy, rng):
    assert copy.simhash_text(TEXT) == orig.simhash_text(TEXT)
    assert copy.is_near_duplicate(5, 7) == orig.is_near_duplicate(5, 7)


def _region(orig, copy, rng):
    for text, hint in ((TEXT, ""), ("der die und das", ""), ("", "fr-CA"), ("x", "zz")):
        assert copy.detect_lang(text, hint) == orig.detect_lang(text, hint)
    assert [int(copy.Region.from_lang(c)) for c in ("en", "nb", "pl", "")] == \
        [int(orig.Region.from_lang(c)) for c in ("en", "nb", "pl", "")]


def _adservers(orig, copy, rng):
    urls = ["https://ads.doubleclick.net/x", "//www.hotjar.com/h.js", "https://a.org/", "bad["]
    assert copy.count_trackers(urls) == orig.count_trackers(urls)


def _schema_org(orig, copy, rng):
    from stract_tpu_torch.webpage.tree import fromstring

    import lxml.html

    items = copy.parse_json_ld(fromstring(PAGE)) + copy.parse_microdata(fromstring(PAGE))
    ref = (orig.parse_json_ld(lxml.html.fromstring(PAGE))
           + orig.parse_microdata(lxml.html.fromstring(PAGE)))
    assert items == ref and copy.flatten(items) == orig.flatten(ref)


def _just_text(orig, copy, rng):
    from stract_tpu_torch.webpage.tree import fromstring

    import lxml.html

    assert copy.extract_paragraphs(fromstring(PAGE)) == \
        orig.extract_paragraphs(lxml.html.fromstring(PAGE))


def _html(orig, copy, rng):
    with _pinned_clock():
        assert copy.Html(PAGE, "https://www.x.org/p").prepare() == \
            orig.Html(PAGE, "https://www.x.org/p").prepare()


def _webpage(orig, copy, rng):
    with _pinned_clock():
        assert copy.Webpage.parse(PAGE, "https://x.org/", keywords=["k"]).as_document() == \
            orig.Webpage.parse(PAGE, "https://x.org/", keywords=["k"]).as_document()


def _naive_bayes(orig, copy, rng):
    texts, labels = ["a b c", "c d e", "a a b", "e e d"], ["x", "y", "x", "y"]
    a, b = orig.NaiveBayes(), copy.NaiveBayes()
    a.fit(texts, labels)
    b.fit(texts, labels)
    assert b.predict_proba("a c e") == a.predict_proba("a c e")


def _safety(orig, copy, rng):
    texts, labels = ["adult xxx", "cooking pasta", "xxx nsfw", "code tutorial"], \
        ["nsfw", "sfw", "nsfw", "sfw"]
    assert copy.SafetyClassifier.train(texts, labels).classify("xxx adult") == \
        orig.SafetyClassifier.train(texts, labels).classify("xxx adult")


def _keywords(orig, copy, rng):
    assert copy.rake_keywords(TEXT) == orig.rake_keywords(TEXT)


def _warc(orig, copy, rng):
    import tempfile
    import uuid
    from unittest import mock

    with tempfile.TemporaryDirectory() as d:
        data = []
        for name, mod in (("o", orig), ("c", copy)):
            path = os.path.join(d, name)
            with mock.patch("uuid.uuid4", return_value=uuid.UUID(int=7)), \
                    mod.WarcWriter.open(path) as w:
                w.write_record("https://a.org/", PAGE, date="2024-01-01T00:00:00Z")
            data.append(open(path, "rb").read())
            assert [r.url for r in copy.WarcReader.open(path)] == ["https://a.org/"]
        assert data[0] == data[1]


def _index_build(orig, copy, rng):
    """SegmentBuilder (index.segment's writer) and merge_segments: the same
    files from the same prepared docs."""
    import tempfile

    from stract_tpu.index import segment as orig_segment
    from stract_tpu_torch.index import segment as copy_segment

    docs = [{"url": f"https://s{i}.org/p", "title": f"t{i} rust", "clean_text": TEXT,
             "site": f"s{i}.org", "host_centrality": float(x)}
            for i, x in enumerate(rng.random(5))]
    with tempfile.TemporaryDirectory() as d:
        for name, seg_mod, merge_mod in (("o", orig_segment, orig), ("c", copy_segment, copy)):
            segs = []
            for k in range(2):
                builder = seg_mod.SegmentBuilder()
                for doc in docs[k::2]:
                    builder.add(dict(doc))
                segs.append(builder.build(os.path.join(d, name, str(k))))
            merge_mod.merge_segments(segs, os.path.join(d, name, "m"))
        trees = []
        for name in ("o", "c"):
            root = os.path.join(d, name)
            trees.append({os.path.relpath(os.path.join(r, f), root):
                          open(os.path.join(r, f), "rb").read()
                          for r, _, fs in os.walk(root) for f in fs})
        assert trees[0] == trees[1] and len(trees[0]) > 30


def _canon_index(orig, copy, rng):
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        a, b = orig.CanonicalIndex(os.path.join(d, "o")), copy.CanonicalIndex(os.path.join(d, "c"))
        for ci in (a, b):
            ci.insert("https://a.org/1", "https://a.org/")
            ci.insert("https://a.org/", "https://a.org/")
            ci.commit()
        assert [b.canonical_of(u) for u in ("https://a.org/1", "https://b.org/")] == \
            [a.canonical_of(u) for u in ("https://a.org/1", "https://b.org/")]


def _webgraph_build(orig, copy, rng):
    assert copy.SKIP_FLAGS == orig.SKIP_FLAGS


def _site_stats(orig, copy, rng):
    class _Seg:
        num_docs = 3

        def stored_doc(self, i):
            return {"site": ("a.org", "b.org", "")[i], "lang": "en"}

    class _Index:
        segments = [_Seg(), _Seg()]

    assert copy.compute_site_stats(_Index()) == orig.compute_site_stats(_Index())


def _indexer(orig, copy, rng):
    with _pinned_clock():
        a = orig.IndexingWorker().prepare(PAGE, "https://www.x.org/p")
        b = copy.IndexingWorker().prepare(PAGE, "https://www.x.org/p")
    assert a == b and copy.IndexingWorker().prepare(
        '<meta name="robots" content="noindex">', "https://x.org/") is None


def _configure(orig, copy, rng):
    assert copy._PAGES == orig._PAGES


def _wal(orig, copy, rng):
    import tempfile

    entries = [{"url": f"https://a.org/{i}", "n": int(i), "f": float(rng.random())}
               for i in rng.integers(0, 99, 20)]
    with tempfile.TemporaryDirectory() as d:
        blobs = []
        for mod, name in ((orig, "o"), (copy, "c")):
            w = mod.Wal(os.path.join(d, name, "live.wal"))
            for e in entries:
                w.write(e)
            assert list(w.iter()) == entries
            w.close()
            with open(os.path.join(d, name, "live.wal"), "rb") as fh:
                blobs.append(fh.read())
        assert blobs[0] == blobs[1]


def _live_index(orig, copy, rng):
    for name in ("TTL_SECONDS", "COMPACT_INTERVAL", "AUTOCOMMIT_INTERVAL", "DROP_GRACE_SECONDS"):
        assert getattr(copy, name) == getattr(orig, name), name


def _live_package(orig, copy, rng):
    for name in ("Wal", "LiveIndex", "LiveCrawler", "SiteChecker"):
        assert getattr(copy, name).__module__.startswith("stract_tpu_torch.live_index.")


def _live_crawler(orig, copy, rng):
    assert copy.CHECK_INTERVALS == orig.CHECK_INTERVALS
    a, b = orig.SiteChecker("x.org"), copy.SiteChecker("x.org")
    for now in rng.integers(0, 8000, 30).tolist():
        for kind in orig.CHECK_INTERVALS:
            assert b.due(kind, now) == a.due(kind, now)
    assert dataclasses.astuple(b) == dataclasses.astuple(a)


class _Replica:
    def __init__(self, up: bool, err):
        self.up, self.err = up, err

    def send(self, method, body):
        if not self.up:
            raise self.err("down")
        return {"indexed": len(body["pages"])}


def _live_entrypoint(orig, copy, rng):
    """The quorum max(1, ceil(fraction * n)) decides alike."""
    assert copy.DEFAULT_CONSISTENCY_FRACTION == orig.DEFAULT_CONSISTENCY_FRACTION
    for n in range(1, 6):
        for up in range(0, n + 1):
            for frac in (0.0, 0.34, 0.5, 0.51, 1.0):
                outcomes = []
                for mod in (orig, copy):
                    reps = type("R", (), {"clients": [_Replica(i < up, mod.RpcError)
                                                      for i in range(n)]})()
                    try:
                        outcomes.append(mod.LiveIndexClient(reps, frac).index_webpages([{}, {}]))
                    except mod.RpcError:
                        outcomes.append("quorum failed")
                assert outcomes[0] == outcomes[1], (n, up, frac)


def _robots(orig, copy, rng):
    text = "User-agent: *\nDisallow: /a*\nAllow: /a/ok$\nCrawl-delay: 3\nSitemap: https://s/x"
    a, b = orig.Robots.parse(text), copy.Robots.parse(text)
    for p in ("/", "/a", "/a/ok", "/a/ok/x", "/b"):
        assert b.is_allowed("Bot", p) == a.is_allowed("Bot", p)
    assert (b.crawl_delay("Bot"), b.sitemaps) == (a.crawl_delay("Bot"), a.sitemaps)


def _file_queue(orig, copy, rng):
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        for mod, name in ((orig, "o"), (copy, "c")):
            q = mod.FileQueue(os.path.join(d, name, "q"))
            q.push_many([{"i": i} for i in range(5)])
            assert q.pop() == {"i": 0} and len(q) == 4
        for suffix in (".q", ".pos"):
            with open(os.path.join(d, "o", "q" + suffix), "rb") as x, \
                    open(os.path.join(d, "c", "q" + suffix), "rb") as y:
                assert x.read() == y.read()


def _crawl_coordinator(orig, copy, rng):
    j = {"domain": "d.org", "urls": ["https://d.org/1"], "wandering_urls": 3}
    assert copy.Job.from_json(j).to_json() == orig.Job.from_json(j).to_json() == j
    assert copy.UrlToInsert("u", 2.0).to_json() == orig.UrlToInsert("u", 2.0).to_json()


def _router(orig, copy, rng):
    class _Coord:
        def __init__(self, jobs):
            self.jobs = list(jobs)

        def send(self, method, body):
            return self.jobs.pop(0) if self.jobs else None

    out = []
    for mod in (orig, copy):
        r = mod.Router([])
        r.clients = [_Coord([1, 2]), _Coord([]), _Coord([3])]
        r._rr = __import__("itertools").cycle(range(3))
        out.append([r.new_job() for _ in range(5)])
    assert out[0] == out[1] == [1, 2, 3, None, None]


def _wander(orig, copy, rng):
    a, b = orig.WanderPrioritiser(), copy.WanderPrioritiser()
    for u in ("https://x.org/1", "https://www.x.org/2", "https://x.org/1", "https://y.org/"):
        a.observe(u)
        b.observe(u)
    assert [b.pop_best("x.org") for _ in range(3)] == [a.pop_best("x.org") for _ in range(3)]


def _worker(orig, copy, rng):
    for name in ("USER_AGENT", "DEFAULT_POLITENESS_DELAY", "MAX_POLITENESS_DELAY",
                 "MAX_URL_SLOWDOWN_RETRIES"):
        assert getattr(copy, name) == getattr(orig, name)
    assert [f.name for f in dataclasses.fields(copy.CrawlDatum)] == \
        [f.name for f in dataclasses.fields(orig.CrawlDatum)]


def _planner(orig, copy, rng):
    assert copy.NUM_JOB_GROUPS == orig.NUM_JOB_GROUPS
    known = {f"h{i}.org": [f"https://h{i}.org/{k}" for k in range(i)] for i in range(8)}
    cent = {f"h{i}.org": float(rng.random()) for i in range(8)}
    assert [j.to_json() for j in copy.make_crawl_plan(cent, known, 30)] == \
        [j.to_json() for j in orig.make_crawl_plan(cent, known, 30)]


def _crawler_package(orig, copy, rng):
    for name in ("Robots", "CrawlCoordinator", "Job", "UrlToInsert", "Router", "WorkerThread",
                 "JobExecutor", "make_crawl_plan"):
        assert getattr(copy, name).__module__.startswith("stract_tpu_torch.crawler.")


def _sitemap(orig, copy, rng):
    doc = ('<sitemapindex xmlns="http://www.sitemaps.org/schemas/sitemap/0.9"><sitemap><loc>'
           'https://s.org/a.xml?x=1&y=2</loc><lastmod>2024</lastmod></sitemap></sitemapindex>')
    assert [dataclasses.asdict(e) for e in copy.parse_sitemap(doc)] == \
        [dataclasses.asdict(e) for e in orig.parse_sitemap(doc)]


def _feed(orig, copy, rng):
    doc = ('<feed xmlns="http://www.w3.org/2005/Atom"><title>A &amp; B</title><entry><link '
           'href="https://a.org/1"/><title><![CDATA[x <b>]]></title><updated>2024</updated>'
           '</entry></feed>')
    assert dataclasses.asdict(copy.parse_feed(doc)) == dataclasses.asdict(orig.parse_feed(doc))


def _distributed_searcher(orig, copy, rng):
    assert copy.LIVE_SHARD_OFFSET == orig.LIVE_SHARD_OFFSET == 1 << 20


def _tiny_graphs(d: str, rng, n: int = 30, e: int = 120) -> tuple:
    """The same seeded graph written into d by the JAX package's builder →
    (its JAX Webgraph, its port Webgraph)."""
    from stract_tpu.webgraph import Edge, WebgraphBuilder

    b = WebgraphBuilder()
    for f, t in rng.integers(0, n, (e, 2)):
        b.insert(Edge(f"n{f}.com/x", f"n{t}.com/y", label=f"l{f}"))
    return b.build(d), importlib.import_module("stract_tpu_torch.webgraph").Webgraph(d)


def _betweenness(orig, copy, rng):
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        jg, pg = _tiny_graphs(d, rng)
        for k in (None, 4):
            assert list(copy.betweenness_centrality(pg, k, seed=1).items()) == \
                list(orig.betweenness_centrality(jg, k, seed=1).items())


class _Fanout:
    """A sharded client's stand-in: each method's canned replies a shard."""

    def __init__(self, replies: dict):
        self.replies = replies

    def send(self, method, body, shard_selector=None, replica_selector=None):
        return {sid: [r] for sid, r in enumerate(self.replies[method])}


def _remote(orig, copy, rng):
    from stract_tpu_torch.utils.hyperloglog import HyperLogLog

    h = [HyperLogLog(8), HyperLogLog(8)]
    for x in rng.integers(0, 2 ** 40, 20).tolist():
        h[x % 2].add_u64(x)
    replies = {"backlinks": [[{"from": "a", "to": "b"}], [{"from": "c", "to": "b"}]],
               "forwardlinks": [[], [{"from": "b", "to": "d"}]],
               "backlink_labels": [["x"], ["y", "z"]], "knows": [False, True],
               "id2node": [None, "b"],
               "similar_hosts": [[{"host": "p", "score": 0.5}], [{"host": "q", "score": 0.9}]],
               "group_exact": [{"h": ["1", "2"]}, {"h": ["2", "3"], "g": ["4"]}],
               "group_sketch": [{"h": h[0].to_bytes()}, {"h": h[1].to_bytes(), "g": h[0].to_bytes()}]}
    a, b = orig.RemoteWebgraph(_Fanout(replies)), copy.RemoteWebgraph(_Fanout(replies))
    for name, args in (("backlinks", ("b",)), ("forwardlinks", ("b",)), ("backlink_labels", ("b",)),
                       ("knows", ("q",)), ("id2node", (7,)), ("similar_hosts", (["p"], 1)),
                       ("group_exact", ("b", "to", 2)), ("batch_search_backlinks", (["b", "c"],))):
        assert getattr(b, name)(*args) == getattr(a, name)(*args), name
    assert {k: v.to_bytes() for k, v in b.group_sketch("b").items()} == \
        {k: v.to_bytes() for k, v in a.group_sketch("b").items()}


def _webgraph_server(orig, copy, rng):
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        jg, pg = _tiny_graphs(d, rng)
        a, b = orig.WebGraphService(jg, 1), copy.WebGraphService(pg, 1)
        for i in range(0, jg.num_nodes, 5):
            node = jg.name_of(i)
            for method, body in (("backlinks", {"node": node}), ("forwardlinks", {"node": node}),
                                 ("backlink_labels", {"node": node}), ("knows", {"host": node}),
                                 ("id2node", {"id": i}), ("group_exact", {"node": node}),
                                 ("similar_hosts", {"hosts": [node]}),
                                 ("inbound_profiles", {"node_ids": [i]})):
                assert getattr(b, method)(body) == getattr(a, method)(body), method
            assert b.group_sketch({"node": node}) == a.group_sketch({"node": node})


def _ampc_package(orig, copy, rng):
    for name in ("DhtShard", "DhtClient", "upsert", "Coordinator", "Worker", "Job", "Mapper",
                 "Setup", "Finisher", "DhtConn", "DhtTable"):
        assert getattr(copy, name).__module__.startswith("stract_tpu_torch.ampc.")
        assert getattr(copy, name).__name__ == getattr(orig, name).__name__


def _ampc_job(orig, copy, rng):
    for mod in (orig, copy):
        assert mod.Job().is_schedulable({}) is True and mod.Mapper.name == "mapper"
        assert mod.Setup().init_tables(None) is None and mod.Setup().setup_round(None) is None
        for call in (mod.Job().to_json, lambda: mod.Job.from_json({}),
                     lambda: mod.Mapper().map(None, None, None),
                     lambda: mod.Finisher().is_finished(None)):
            with pytest.raises(NotImplementedError):
                call()


def _ampc_dht(orig, copy, rng):
    assert copy.UPSERT_FNS.keys() == orig.UPSERT_FNS.keys()
    assert {k: v for k, v in vars(copy.upsert).items() if k.isupper()} == \
        {k: v for k, v in vars(orig.upsert).items() if k.isupper()}
    regs = [rng.integers(0, 30, 16, dtype=np.uint8).tobytes() for _ in range(2)]
    for name, old, new in (("u64_add", None, 3), ("u64_add", 4, 3), ("u64_min", None, 5),
                           ("u64_min", 2, 5), ("f64_add", 0.1, 0.2), ("f32_add", None, 1.5),
                           ("kahan_add", None, [1.0, 0.5]), ("kahan_add", [1e16, 1.0], [1.0, 0.0]),
                           ("hll_max", None, regs[0]), ("hll_max", regs[0], regs[1])):
        assert copy.UPSERT_FNS[name](old, new) == orig.UPSERT_FNS[name](old, new), name


class _Tables:
    """A DhtClient's stand-in recording the table names it is handed."""

    def __init__(self):
        self.calls = []
        self.clients = [type("C", (), {"addr": ("127.0.0.1", 9)})()]

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name, args))


def _ampc_dht_conn(orig, copy, rng):
    out = []
    for mod in (orig, copy):
        client = _Tables()
        conn = mod.DhtConn(client, ["regs", "meta"])
        conn.prev("regs").batch_set([(b"k", 1)])
        conn.next("meta").batch_upsert("u64_add", [(b"c", 1)])
        conn.seed_next_from_prev()
        conn.next_round()
        conn.prev("regs").get(b"k")
        out.append((client.calls, conn.serializable()))
    assert out[0] == out[1]


def _ampc_worker(orig, copy, rng):
    for mod in (orig, copy):
        w = mod.Worker()
        assert w.get_meta() == {} and w.meta() == {} and w.mappers == {} and w.jobs == {}


def _ampc_coordinator(orig, copy, rng):
    """With no worker, a run takes its setup and finisher alone: the same
    rounds, and a stage with jobs raises for want of a worker."""
    class _Setup:
        def __init__(self):
            self.calls = 0

        def init_tables(self, dht):
            self.calls += 100

        def setup_round(self, dht):
            self.calls += 1

    class _Conn:
        round = 0

        def next_round(self):
            self.round += 1

    class _Finisher:
        def is_finished(self, dht):
            return dht.round >= 3

    class _Mapper:
        name = "m"

    out = []
    for mod in (orig, copy):
        setup = _Setup()
        rounds = mod.Coordinator(setup, [], []).run([], _Conn(), _Finisher(), max_rounds=10)
        out.append((rounds, setup.calls))
        rpc = importlib.import_module(mod.__name__.replace("ampc.coordinator",
                                                           "distributed.sonic"))
        job = type("J", (), {"is_schedulable": lambda self, m: True, "to_json": lambda self: {}})
        with pytest.raises(rpc.RpcError):
            mod.Coordinator(_Setup(), [_Mapper()], []).run([job()], _Conn(), _Finisher())
    assert out[0] == out[1] == (3, 103)


def _ampc_harmonic(orig, copy, rng):
    import tempfile

    assert (copy.REGS, copy.META, copy.CENTRALITY_TABLE) == (orig.REGS, orig.META,
                                                             orig.CENTRALITY_TABLE)
    for r in rng.integers(0, 2 ** 40, 5).tolist():
        assert copy._key(r) == orig._key(r)
    job = {"kind": "edge_shard", "shard": 2}
    assert copy.EdgeShardJob.from_json(job).to_json() == orig.EdgeShardJob.from_json(job).to_json()
    assert copy.EdgeShardJob(2).is_schedulable({"shard": 2}) and \
        not copy.EdgeShardJob(2).is_schedulable({"shard": 1})
    with tempfile.TemporaryDirectory() as d:
        jg, pg = _tiny_graphs(d, rng)
        for n in (1, 3):
            for (a, b), (c, e) in zip(orig.partition_edges(jg, n), copy.partition_edges(pg, n)):
                np.testing.assert_array_equal(a, c)
                np.testing.assert_array_equal(b, e)
        ef, et = copy.partition_edges(pg, 3)[1]
        w = copy.HarmonicWorker(1, 3, ef, et, pg.num_nodes, 6, device="cpu")
        assert w.meta() == orig.HarmonicWorker(1, 3, ef, et, jg.num_nodes, 6).meta()
        np.testing.assert_array_equal(w.owned, orig.HarmonicWorker(1, 3, ef, et, jg.num_nodes).owned)


def _ampc_shortest_path(orig, copy, rng):
    assert (copy.DIST, copy.SP_META) == (orig.DIST, orig.SP_META)

    class _Conn:
        def __init__(self, rnd, changed):
            self.round, self.changed = rnd, changed

        def prev(self, name):
            return type("T", (), {"get": lambda s, k: self.changed})()

    for rnd, changed in ((0, None), (1, 0), (1, 3), (2, None)):
        assert copy.ShortestPathFinisher().is_finished(_Conn(rnd, changed)) == \
            orig.ShortestPathFinisher().is_finished(_Conn(rnd, changed))


def _ampc_raft(orig, copy, rng):
    """A node's handlers (no thread started) answer a seeded sequence of
    append_entries and request_vote bodies alike, and apply the same
    tables."""
    assert (copy.HEARTBEAT_INTERVAL, copy.ELECTION_TIMEOUT) == (orig.HEARTBEAT_INTERVAL,
                                                                orig.ELECTION_TIMEOUT)
    nodes = (orig.RaftNode(1), copy.RaftNode(1))
    entries = [{"term": 1 + i // 3, "op": "batch_upsert",
                "body": {"table": "t", "fn": "u64_add", "pairs": [(b"k", int(v))]}}
               for i, v in enumerate(rng.integers(0, 9, 6))]
    bodies = [("append_entries", {"term": 1, "leader": 0, "prev_log_index": -1, "prev_log_term": 0,
                                  "entries": entries[:3], "leader_commit": 1}),
              ("append_entries", {"term": 2, "leader": 2, "prev_log_index": 5, "prev_log_term": 2,
                                  "entries": [], "leader_commit": 2}),
              ("append_entries", {"term": 2, "leader": 2, "prev_log_index": 2, "prev_log_term": 1,
                                  "entries": entries[3:], "leader_commit": 4}),
              ("request_vote", {"term": 1, "candidate": 3, "last_log_term": 1,
                                "last_log_index": 9}),
              ("request_vote", {"term": 3, "candidate": 3, "last_log_term": 2,
                                "last_log_index": 5}),
              ("propose", {"op": "batch_set", "body": {"table": "t", "pairs": []}})]
    for method, body in bodies:
        assert getattr(nodes[1], method)(body) == getattr(nodes[0], method)(body), method
    assert nodes[1].status() == nodes[0].status() and nodes[1].store.tables == \
        nodes[0].store.tables and nodes[1].log == nodes[0].log


def _ampc_entrypoint(orig, copy, rng):
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        _tiny_graphs(d, rng)
        for shard in range(3):
            a, b = orig._load_partition(d, shard, 3), copy._load_partition(d, shard, 3)
            assert a[0].num_nodes == b[0].num_nodes
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_array_equal(a[2], b[2])


COPIES = {
    "utils.hashing": _hashing, "utils.kahan": _kahan, "utils.metrics": _metrics,
    "utils.bloom": _bloom, "schema": _schema, "schema.text_field": _text_field,
    "schema.numerical_field": _numerical_field, "tokenizer.fields": _tokenizer,
    "tokenizer.stemmer": _stemmer, "ranking.signals": _signals,
    "ranking.bm25_math": _bm25_math, "ranking.proximity": _proximity,
    "ranking.term_distance": _term_distance, "ranking.pipeline": _pipeline_package,
    "ranking.pipeline.block": _pipeline_block, "collector": _candidate_and_collector,
    "ranking.pipeline.recall": _pipeline_stages, "bangs": _bangs, "snippet": _snippet,
    "prettifier": _prettifier, "native": _native, "kv.db": _kv, "webgraph.node": _edge_node,
    "webgraph.edge": _webgraph_edge, "ops.hll_ops": _hll_init, "config": _config,
    "distributed": _distributed_package, "distributed.sonic": _sonic,
    "distributed.cluster": _cluster, "distributed.replication": _replication,
    "distributed.remote_cp": _remote_cp, "utils.executor": _executor,
    "optics.optic": _optic, "spell.term_freqs": _spell_parts,
    "spell.stupid_backoff": _spell_parts, "spell.error_model": _spell_parts,
    "spell.checker": _spell_checker, "widgets": _widgets, "autosuggest": _autosuggest,
    "ranking.models.linear": _linear, "ranking.inbound_similarity": _inbound,
    "zim": _zim, "image_store": _image_store, "entity_index.index": _entity_index,
    "entrypoint.entity": _entity_parse, "utils.hyperloglog": _hyperloglog,
    "api.user_count": _user_count, "api.improvement": _improvement, "api.docs": _docs,
    "leechy": _leechy, "optics_lsp": _optics_lsp,
    "utils.simhash": _simhash, "webpage.region": _region, "webpage.adservers": _adservers,
    "webpage.schema_org": _schema_org, "webpage.just_text": _just_text, "webpage.html": _html,
    "webpage": _webpage, "utils.naive_bayes": _naive_bayes, "webpage.safety": _safety,
    "keywords": _keywords, "warc": _warc, "index.merge": _index_build,
    "canon_index": _canon_index, "entrypoint.webgraph_build": _webgraph_build,
    "site_stats": _site_stats, "entrypoint.indexer": _indexer,
    "entrypoint.configure": _configure, "live_index.wal": _wal, "live_index.index": _live_index,
    "live_index": _live_package, "live_index.crawler": _live_crawler,
    "entrypoint.live_index": _live_entrypoint, "crawler.robots": _robots,
    "crawler.file_queue": _file_queue, "crawler.coordinator": _crawl_coordinator,
    "crawler.router": _router, "crawler.wander_prioritiser": _wander, "crawler.worker": _worker,
    "crawler.planner": _planner, "crawler": _crawler_package, "sitemap": _sitemap,
    "feed": _feed, "searcher.distributed": _distributed_searcher,
    "webgraph.betweenness": _betweenness, "webgraph.remote": _remote,
    "entrypoint.webgraph_server": _webgraph_server, "ampc": _ampc_package, "ampc.job": _ampc_job,
    "ampc.dht": _ampc_dht, "ampc.dht_conn": _ampc_dht_conn, "ampc.worker": _ampc_worker,
    "ampc.coordinator": _ampc_coordinator, "ampc.harmonic": _ampc_harmonic,
    "ampc.shortest_path": _ampc_shortest_path, "ampc.raft": _ampc_raft,
    "entrypoint.ampc": _ampc_entrypoint,
}


@pytest.mark.parametrize("module", list(COPIES))
def test_copy_matches_its_original(module):
    orig = importlib.import_module(f"stract_tpu.{module}")
    copy = importlib.import_module(f"stract_tpu_torch.{module}")
    assert orig is not copy and copy.__name__.startswith("stract_tpu_torch.")
    COPIES[module](orig, copy, np.random.default_rng(zlib.crc32(module.encode())))
