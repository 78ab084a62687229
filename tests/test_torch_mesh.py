"""The port's mesh of shards against the JAX package's on the CPU: the mesh
and its factorisation, the segment padding and stacking, the global top-k of
the shards (K9's plain twin against lax.top_k), the sharded search programs,
and LocalSearcher and SearchService over a mesh. (The sharded HyperBall,
K8's twin, is held in tests/test_torch_centrality.py.)

The port's mesh is a list of devices with repeats (Mesh([cpu] * n)); the JAX
side runs on its 8 virtual CPU devices (tests/conftest.py), as
tests/test_sharded_search.py and tests/test_webgraph.py build their meshes.

Tolerances: merged scores rtol 1e-5, with docs and shards equal except
within a run of tied scores, where they are compared as sets (the shards'
stage A and stage B differ from the JAX package's by f32 sums in another
order, which may reorder equal-looking scores); the top-k twin, the padding
and the stacking are bit-equal.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from conftest import make_doc
from torch_parity import assert_topk_match

from stract_tpu.index import InvertedIndex
from stract_tpu.parallel import mesh as JM
from stract_tpu.parallel import search as JS
from stract_tpu.ranking.computer import QueryContext, build_slots
from stract_tpu_torch.index.inverted import InvertedIndex as PortIndex
from stract_tpu_torch.ops import scoring as PO
from stract_tpu_torch.parallel import mesh as PM
from stract_tpu_torch.parallel import search as PS

N_DEV = 8
WORDS = ["alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta"]


def _jax_mesh(n: int = N_DEV) -> JaxMesh:
    if len(jax.devices()) < n:
        pytest.skip("needs 8 virtual devices")
    return JaxMesh(np.array(jax.devices()[:n]), axis_names=("x",))


def _port_mesh(n: int = N_DEV) -> PM.Mesh:
    return PM.Mesh([torch.device("cpu")] * n, axis_names=("x",))


# ---- the mesh ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_shapes_match_jax(n):
    """_factor and make_mesh give the JAX package's shapes for 1..8 devices,
    over the default axes and over one; a mesh's entries may repeat."""
    if len(jax.devices()) < n:
        pytest.skip("needs 8 virtual devices")
    for ways in (1, 2, 3):
        assert PM._factor(n, ways) == JM._factor(n, ways)
    for axes in (("dp", "tp", "sp"), ("x",)):
        jm, pm = JM.make_mesh(n, axes), PM.make_mesh(n, axes, device="cpu")
        assert dict(pm.shape) == dict(jm.shape) and pm.axis_names == jm.axis_names
        assert pm.devices.shape == jm.devices.shape
        assert all(d == torch.device("cpu") for d in pm.devices.flat)


def test_mesh_checks_its_axes():
    with pytest.raises(ValueError):
        PM.Mesh([torch.device("cpu")] * 4, axis_names=("x", "y"))
    with pytest.raises(ValueError):
        PM.Mesh([], axis_names=("x",))
    m = PM.Mesh([["cpu", "cpu"], ["cpu", "cpu"]], axis_names=("a", "b"))
    assert m.shape == {"a": 2, "b": 2} and m.devices.size == 4


# ---- fixtures ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def shard_dirs(tmp_path_factory):
    """tests/test_sharded_search.py's 8 single-segment indexes over one
    logical corpus (seed 3, 12 docs each) → their directories."""
    rng = np.random.default_rng(3)
    dirs = []
    for s in range(N_DEV):
        path = str(tmp_path_factory.mktemp(f"mshard{s}"))
        idx = InvertedIndex(path)
        for i in range(12):
            toks = rng.choice(WORDS, size=6)
            idx.insert(make_doc(f"https://s{s}-{i}.com/p", " ".join(toks[:2]), " ".join(toks),
                                host_centrality=float(rng.random())))
        idx.commit()
        dirs.append(path)
    return dirs


@pytest.fixture(scope="module")
def mesh_index_dir(tmp_path_factory):
    """tests/test_sharded_search.py's 3-segment index (seed 11, 14 docs a
    segment): on an 8-entry mesh, five shards are padding."""
    rng = np.random.default_rng(11)
    path = str(tmp_path_factory.mktemp("meshidx"))
    idx = InvertedIndex(path)
    for s in range(3):
        for i in range(14):
            toks = rng.choice(WORDS, size=8)
            idx.insert(make_doc(f"https://s{s}-{i}.com/p", " ".join(toks[:2]), " ".join(toks),
                                host_centrality=float(rng.random())))
        idx.commit()
    assert len(idx.segments) == 3
    return path


@pytest.fixture(scope="module")
def sized_index_dir(tmp_path_factory):
    """Three segments of 300, 2,500 and 9,000 synthetic pages (seeds 1-3):
    their bucketed device shapes differ."""
    from stract_tpu_torch import bench_corpus

    return bench_corpus.ensure_segmented_corpus(str(tmp_path_factory.mktemp("sized")),
                                                [300, 2500, 9000], [1, 2, 3],
                                                log=lambda *a: None)


def _leaf_np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---- padding and stacking ------------------------------------------------------------------
def test_pad_and_stack_bit_equal_to_jax(sized_index_dir):
    """Three differently sized segments padded to common shapes and stacked:
    every field bit-equal to the JAX package's, from its DeviceSegments and
    from their SegmentArrays."""
    jidx, pidx = InvertedIndex(sized_index_dir), PortIndex(sized_index_dir, "cpu")
    jdev = [jidx.device_segment_for(s) for s in jidx.segments]
    pdev = [pidx.device_segment_for(s) for s in pidx.segments]
    assert len({tuple(d.arrays.postings.shape) for d in pdev}) > 1  # the sizes differ
    jpad = JS.pad_segments_to_common_shapes(jdev)
    for given in (pdev, [d.arrays for d in pdev]):
        ppad = PS.pad_segments_to_common_shapes(given)
        for ja, pa in zip(jpad, ppad):
            for name, jx, px in zip(ja._fields, ja, pa):
                np.testing.assert_array_equal(_leaf_np(px), np.asarray(jx), err_msg=name)
        jstk, pstk = JS.stack_segment_arrays(jpad), PS.stack_segment_arrays(ppad)
        for name, jx, px in zip(jstk._fields, jstk, pstk):
            assert _leaf_np(px).dtype == np.asarray(jx).dtype, name
            np.testing.assert_array_equal(_leaf_np(px), np.asarray(jx), err_msg=name)


# ---- the global top-k (K9's twin) ------------------------------------------------------------
@pytest.mark.parametrize("n,K,k", [(1, 64, 64), (3, 128, 128), (8, 512, 512), (8, 1024, 10)])
def test_mesh_topk_twin_equals_lax_top_k(n, K, k):
    """The plain twin of the mesh merge against lax.top_k over the flattened
    n*K gathered scores: values, docs and shards equal, with planted ties
    across and within shards, -inf tails and a shard of -inf only."""
    rng = np.random.default_rng(n * 1000 + K)
    B = 3
    scores = np.sort(rng.integers(0, 30, (B, n, K)).astype(np.float32) / 8, axis=2)[..., ::-1]
    scores = np.ascontiguousarray(scores)
    for b in range(B):
        for d in range(n):
            scores[b, d, rng.integers(K // 3, K + 1):] = -np.inf
    scores[1, -1, :] = -np.inf
    docs = rng.integers(0, 10_000, (B, n, K)).astype(np.int32)
    got_d, got_h, got_s = PO.mesh_topk(torch.from_numpy(scores), torch.from_numpy(docs), k)
    for b in range(B):
        top_s, idx = jax.lax.top_k(jnp.asarray(scores[b].reshape(-1)), k)
        idx = np.asarray(idx)
        np.testing.assert_array_equal(got_s[b].numpy(), np.asarray(top_s))
        np.testing.assert_array_equal(got_d[b].numpy(), docs[b].reshape(-1)[idx])
        np.testing.assert_array_equal(got_h[b].numpy(), idx // K)


# ---- the sharded programs ----------------------------------------------------------------
def _assert_merged_match(jres, pres):
    """Merged (docs, shards, scores) of the two packages: finite scores equal
    within rtol 1e-5 position by position, and each (shard, doc) above the
    last tied run in both; ties compared as sets."""
    jd, jh, js = (np.asarray(x) for x in jres)
    pd, ph, ps = (_leaf_np(x) for x in pres)
    fj, fp = np.isfinite(js), np.isfinite(ps)
    np.testing.assert_array_equal(fj, fp)
    np.testing.assert_allclose(ps[fp], js[fj], rtol=1e-5)
    assert_topk_match(jh[fj].astype(np.int64) << 32 | jd[fj], js[fj],
                      ph[fp].astype(np.int64) << 32 | pd[fp], ps[fp], -1, 1e-5, 0)
    assert fj.sum() > 0


def test_sharded_search_matches_jax(shard_dirs):
    """make_sharded_search over 8 shards, one query replicated (slots built
    against shard 0's segment, as the JAX program takes them), against the
    JAX package's shard_map program on the same padded segments (stacked for
    the JAX program, one per shard for the port's)."""
    jidxs = [InvertedIndex(d) for d in shard_dirs]
    pidxs = [PortIndex(d, "cpu") for d in shard_dirs]
    ctx = QueryContext(raw="alpha beta", simple_terms=["alpha", "beta"], current_ts=1e9)
    total = sum(i.num_docs for i in jidxs)
    q, _ = build_slots(ctx, jidxs[0].segments[0], total)
    L, K = 128, 64
    jstk = JS.stack_segment_arrays(JS.pad_segments_to_common_shapes(
        [i.device_segment(0) for i in jidxs]))
    psegs = PS.pad_segments_to_common_shapes(
        [i.device_segment_for(i.segments[0]) for i in pidxs])
    jres = JS.make_sharded_search(_jax_mesh(), "x", L, K, True)(jstk, q)
    pres = PS.make_sharded_search(_port_mesh(), L, K, True)(psegs, q)
    _assert_merged_match(jres, pres)


def _two_stage_slots(jidxs, ctx, L: int):
    """Per-shard stage-A (impact-augmented) and stage-B (compacted) slots,
    built as the mesh searcher builds them, padded to one Pa and one Pc."""
    total = sum(i.num_docs for i in jidxs)
    qas, qcs = [], []
    for i in jidxs:
        seg = i.segments[0]
        q, _ = build_slots(ctx, seg, total)
        qas.append(InvertedIndex._augment_with_impact(seg, i.device_segment_for(seg), q, L)[0])
        qcs.append(InvertedIndex._compact_slots(q, min_p=16)[0])
    Pa = max(q.starts.shape[0] for q in qas)
    Pc = max(q.starts.shape[0] for q in qcs)
    return [JS._pad_slots(q, Pa) for q in qas], [JS._pad_slots(q, Pc) for q in qcs]


@pytest.mark.parametrize("raw,fast", [("alpha beta", True), ("gamma -alpha", True),
                                      ("delta epsilon zeta", False)])
def test_sharded_two_stage_matches_jax(shard_dirs, raw, fast):
    """make_sharded_two_stage (per shard: stage A soft-required, stage B
    with the device join; then the merge) against the JAX package's program,
    on per-shard slots: MUST groups, a MUST_NOT group, three groups, with the
    fast static mode and without."""
    jidxs = [InvertedIndex(d) for d in shard_dirs]
    pidxs = [PortIndex(d, "cpu") for d in shard_dirs]
    terms = [t.lstrip("-") for t in raw.split()]
    ctx = QueryContext(raw=raw, simple_terms=terms, current_ts=1e9)
    L, C, K = 128, 1024, 128
    qas, qcs = _two_stage_slots(jidxs, ctx, L)
    stack = lambda qs: jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *qs)  # noqa: E731
    jstk = JS.stack_segment_arrays(JS.pad_segments_to_common_shapes(
        [i.device_segment(0) for i in jidxs]))
    psegs = PS.pad_segments_to_common_shapes(
        [i.device_segment_for(i.segments[0]) for i in pidxs])
    jres = JS.make_sharded_two_stage(_jax_mesh(), "x", L, C, K, True, fast)(
        jstk, stack(qas), stack(qcs))
    pres = PS.make_sharded_two_stage(_port_mesh(), L, C, K, True, fast)(psegs, qas, qcs)
    _assert_merged_match(jres, pres)


# ---- LocalSearcher and SearchService over a mesh -----------------------------------------------
MESH_QUERIES = [
    "alpha beta",            # MUST groups crossing shards
    "alpha -gamma",          # MUST_NOT exclusion
    '"alpha beta"',          # phrase filter over the sharded pass-1 results
    "delta epsilon zeta",    # 3 required groups
    "theta",                 # one term: the driver path
]


def _assert_candidates_match(q, c0, n0, c1, n1):
    assert len(c0) == len(c1), (q, len(c0), len(c1))
    assert n0.value == n1.value and n0.exact == n1.exact, q
    s0 = np.array([c.score for c in c0])
    s1 = np.array([c.score for c in c1])
    np.testing.assert_allclose(s1, s0, rtol=1e-5, err_msg=q)
    ids = lambda cs: np.array([c.pointer.segment << 32 | c.pointer.doc for c in cs],  # noqa: E731
                              dtype=np.int64)
    if len(c0):
        assert_topk_match(ids(c0), s0, ids(c1), s1, -1, 1e-5, 0)


def test_local_searcher_mesh_matches_jax(mesh_index_dir):
    """LocalSearcher(index, mesh=) of the port (8 CPU entries, 5 of them
    padding shards) against the JAX package's on its 8-device mesh and
    against the port's own per-segment path: counts, exactness and scores."""
    from stract_tpu.searcher.local import LocalSearcher as JaxLocal
    from stract_tpu.searcher.query import SearchQuery as JaxSQ
    from stract_tpu_torch.searcher.local import LocalSearcher
    from stract_tpu_torch.searcher.query import SearchQuery

    jax_mesh = JaxLocal(InvertedIndex(mesh_index_dir), mesh=_jax_mesh())
    pidx = PortIndex(mesh_index_dir, "cpu")
    port_mesh = LocalSearcher(pidx, mesh=_port_mesh())
    assert port_mesh._sharded is not None and port_mesh._sharded.n == N_DEV
    assert LocalSearcher(pidx, mesh=_port_mesh(1))._sharded is None
    rj = jax_mesh.search_initial_many([JaxSQ(query=q) for q in MESH_QUERIES], max_candidates=64)
    rp = port_mesh.search_initial_many([SearchQuery(query=q) for q in MESH_QUERIES],
                                       max_candidates=64)
    rb = LocalSearcher(pidx).search_initial_many([SearchQuery(query=q) for q in MESH_QUERIES],
                                                 max_candidates=64)
    for q, (cj, nj), (cp, np_), (cb, nb) in zip(MESH_QUERIES, rj, rp, rb):
        _assert_candidates_match(q, cj, nj, cp, np_)
        _assert_candidates_match(q, cb, nb, cp, np_)
    assert sum(len(c) for c, _ in rp) > 20


def test_local_searcher_search_and_lazy_signals_match_jax(mesh_index_dir):
    """LocalSearcher.search (one shard end to end) gives the JAX package's
    page, and materialize_signals fills lazy candidates with the rows the
    eager shard flow computes."""
    from stract_tpu.searcher.local import LocalSearcher as JaxLocal
    from stract_tpu.searcher.query import SearchQuery as JaxSQ
    from stract_tpu_torch.searcher.local import LocalSearcher
    from stract_tpu_torch.searcher.query import SearchQuery

    jax_ls = JaxLocal(InvertedIndex(mesh_index_dir))
    pidx = PortIndex(mesh_index_dir, "cpu")
    port_ls = LocalSearcher(pidx)
    for q in MESH_QUERIES[:4]:
        a, b = jax_ls.search(JaxSQ(query=q)), port_ls.search(SearchQuery(query=q))
        assert a["num_hits"] == b["num_hits"], q
        assert [w["url"] for w in a["webpages"]] == [w["url"] for w in b["webpages"]], q
        np.testing.assert_allclose([w["score"] for w in b["webpages"]],
                                   [w["score"] for w in a["webpages"]], rtol=1e-5)
    sq = SearchQuery(query="alpha beta")
    lazy, _ = port_ls.search_initial(sq, 20)
    eager, _ = LocalSearcher(pidx, lazy_signals=False).search_initial(sq, 20)
    assert lazy and all(c.signals is None for c in lazy)
    port_ls.materialize_signals(sq, lazy)
    for a, b in zip(lazy, eager):
        assert (a.pointer.segment, a.pointer.doc) == (b.pointer.segment, b.pointer.doc)
        np.testing.assert_allclose(a.signals, b.signals, rtol=1e-4, atol=1e-6)


def test_search_service_mesh_matches_jax(tmp_path):
    """The shard service over a mesh, as tests/test_sharded_search.py drives
    the JAX package's: its wire results (candidates with their eager signal
    rows) equal the JAX package's mesh service; "off", and "auto" without
    two cards, resolve to no mesh."""
    from stract_tpu.entrypoint.search_server import SearchService as JaxService
    from stract_tpu_torch.entrypoint.search_server import SearchService, resolve_search_mesh

    rng = np.random.default_rng(7)
    words = ["alpha", "beta", "gamma", "delta"]
    idx = InvertedIndex(str(tmp_path / "svc"))
    for s in range(2):
        for i in range(10):
            toks = rng.choice(words, size=5)
            idx.insert(make_doc(f"https://v{s}-{i}.com/p", " ".join(toks[:2]),
                                " ".join(toks), host_centrality=float(rng.random())))
        idx.commit()
    pidx = PortIndex(str(tmp_path / "svc"), "cpu")
    assert resolve_search_mesh("off", pidx) is None
    assert resolve_search_mesh(None, pidx) is None
    if not torch.cuda.is_available():
        assert resolve_search_mesh("auto", pidx) is None
    mesh = _port_mesh()
    assert resolve_search_mesh(mesh, pidx) is mesh

    _jax_mesh()
    jsvc = JaxService(idx, batching=False, mesh="auto")
    psvc = SearchService(pidx, batching=False, mesh=mesh)
    assert psvc.searcher._sharded is not None and jsvc.searcher._sharded is not None
    body = {"queries": [{"query": "alpha beta"}, {"query": "gamma -alpha"}]}
    for a, b in zip(jsvc.search_batch(body), psvc.search_batch(body)):
        assert a["count"] == b["count"]
        assert len(a["candidates"]) == len(b["candidates"]) > 0
        for ca, cb in zip(a["candidates"], b["candidates"]):
            assert abs(ca["score"] - cb["score"]) < 1e-5
            np.testing.assert_allclose(cb["signals"], ca["signals"], rtol=1e-4, atol=1e-6)
    blocks = psvc.search_block_batch(body)
    assert len(blocks) == 2 and len(blocks[0]["block"]["doc"]) > 0
