"""The webgraph centrality job of the port against the JAX package's on the
CPU: HyperBall register merges (K6a's plain version) bit-equal round by
round, size estimates (K6b's) within rel 1e-6 (XLA and torch sum a row's 64
powers of two in other orders), harmonic centrality with the same round
count within rtol 1e-5 and ranks equal up to ties, BFS distances (K7's)
exactly equal, approximated harmonic centrality within rtol 1e-9 (the same
sources from the same seed, the same f64 sums), kv stores and graphs
written by either package read by the other, and the `centrality` command
line of both packages on the same config.

Graphs: the fixtures of tests/test_webgraph.py, a 2,000-node Pareto graph
(the benchmark's recipe at small size), and one with self-loops, sources
only, sinks only and a node whose only edge is its own loop.
"""

from __future__ import annotations

import filecmp
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from stract_tpu.kv import Db as JaxDb
from stract_tpu.main import main as jax_main
from stract_tpu.ops import hll_ops as jax_hll
from stract_tpu.webgraph import Edge, Webgraph as JaxWebgraph, WebgraphBuilder
from stract_tpu.webgraph import centrality as JC
from stract_tpu.webgraph import shortest_path as JS
from stract_tpu_torch.entrypoint.bench_centrality import make_edges
from stract_tpu_torch.kv import Db
from stract_tpu_torch.main import main as port_main
from stract_tpu_torch.ops import hll_ops
from stract_tpu_torch.parallel import mesh as PM
from stract_tpu_torch.webgraph import Webgraph
from stract_tpu_torch.webgraph import centrality as PC
from stract_tpu_torch.webgraph import shortest_path as PS
from stract_tpu_torch.webgraph.csr import LONG_ROW, graph_in_csr, in_csr
from stract_tpu_torch.webgraph.store import write_graph

import torch

GRAPHS = {
    "chain": [("a", "b"), ("b", "c"), ("c", "d"), ("a", "c"), ("d", "a")],
    "star": [(f"n{i}.com", "hub.com") for i in range(8)] + [("n0.com", "n1.com")],
    "ring": [("a", "b"), ("b", "c"), ("c", "d"), ("d", "e"), ("e", "a"), ("a", "c"),
             ("b", "d")],
    "random30": None,  # test_webgraph.py's 30-node, 150-edge graph (seed 3)
    "loops": [("a", "a"), ("a", "b"), ("b", "b"), ("c", "b"), ("d", "d"), ("e", "c"),
              ("b", "f"), ("f", "f")],
    "pareto2000": None,
}


def _edges(name: str) -> list:
    if name == "random30":
        rng = np.random.default_rng(3)
        nodes = [f"h{i}" for i in range(30)]
        edges = [(nodes[rng.integers(30)], nodes[rng.integers(30)]) for _ in range(150)]
        return [(a, b) for a, b in edges if a != b]
    return GRAPHS[name]


@pytest.fixture(scope="module", params=list(GRAPHS))
def graph(request, tmp_path_factory):
    """(name, JAX Webgraph, port Webgraph) over one directory: the JAX
    builder's, or for the Pareto graph the port's vectorised writer's."""
    path = str(tmp_path_factory.mktemp(request.param) / "g")
    if request.param == "pareto2000":
        src, dst = make_edges(2000, 40_000, seed=0)
        write_graph(path, [f"h{i}.example" for i in range(2000)], src, dst)
    else:
        b = WebgraphBuilder()
        for f, t in _edges(request.param):
            b.insert(Edge(f, t, label=f"link {f}->{t}"))
        b.build(path)
    return request.param, JaxWebgraph(path), Webgraph(path)


def _jax_mesh(n: int):
    import jax
    from jax.sharding import Mesh as JaxMesh

    if len(jax.devices()) < n:
        pytest.skip("needs 8 virtual devices")
    return JaxMesh(np.array(jax.devices()[:n]), axis_names=("x",))


def _port_mesh(n: int):
    return PM.Mesh([torch.device("cpu")] * n, axis_names=("x",))


def _edge_arrays(g):
    return PS.forward_edges(g)


def test_merge_rounds_bit_equal_and_estimates_close(graph):
    _, jg, pg = graph
    ef, et = _edge_arrays(jg)
    for precision in (6, 8):
        regs0 = jax_hll.init_registers(jg.num_nodes, precision)
        np.testing.assert_array_equal(hll_ops.init_registers(jg.num_nodes, precision), regs0)
        rj, rp = jnp.asarray(regs0), torch.from_numpy(regs0)
        for _ in range(6):
            rj = jax_hll.merge_iteration(rj, jnp.asarray(ef), jnp.asarray(et))
            rp = hll_ops.merge_iteration(rp, torch.from_numpy(ef), torch.from_numpy(et))
            np.testing.assert_array_equal(rp.numpy(), np.asarray(rj))
            np.testing.assert_allclose(hll_ops.estimate_sizes(rp).numpy(),
                                       np.asarray(jax_hll.estimate_sizes(rj)), rtol=1e-6)


@pytest.mark.parametrize("precision", [1, 11, 12])
def test_estimates_match_jax_at_other_widths(precision):
    """The size estimate (K6b's plain version, whose 2^-r the kernels build
    from the exponent bits) within rel 1e-6 of the JAX package's at 2, 2,048
    and 4,096 registers a row, on the initial registers, after 4 merges over
    the 2,000-node Pareto graph, and on rows holding the bytes 126, 127, 149,
    150 and 255 (2^-r is 0 from r = 126 on in both: XLA's exp2 flushes
    2^-126 on the CPU), one of them all 126 (inf in both)."""
    src, dst = make_edges(2000, 40_000, seed=0)
    regs = jax_hll.init_registers(2000, precision)
    rj = jnp.asarray(regs)
    for _ in range(4):
        rj = jax_hll.merge_iteration(rj, jnp.asarray(src), jnp.asarray(dst))
    m = 1 << precision
    edge = np.resize(np.array([126, 127, 149, 150, 255, 3, 0], np.uint8), (4, m))
    edge[1] = np.resize(np.array([126, 127, 149, 150, 255, 5], np.uint8), m)
    edge[2] = 126
    edge[3, 0] = 7
    for r in (regs, np.asarray(rj), edge):
        want = np.asarray(jax_hll.estimate_sizes(jnp.asarray(r)))
        got = hll_ops.estimate_sizes(torch.from_numpy(np.array(r))).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert np.isinf(want[2])


def test_harmonic_centrality_matches_jax_at_precision_11(tmp_path):
    """harmonic_centrality at precision 11 (2,048 registers a row, as
    `main.py centrality` runs it with precision = 11 in its config) on the
    2,000-node Pareto graph: the JAX package's round count, centrality
    within rtol 1e-5, ranks equal up to ties."""
    path = str(tmp_path / "g")
    src, dst = make_edges(2000, 40_000, seed=0)
    write_graph(path, [f"h{i}.example" for i in range(2000)], src, dst)
    jg, pg = JaxWebgraph(path), Webgraph(path)
    cj = JC.harmonic_centrality(jg, precision=11)
    timings = {}
    cp = PC.harmonic_centrality(pg, precision=11, device="cpu", timings=timings)
    assert timings["n_rounds"] == _jax_rounds(jg, 11)
    assert list(cp) == list(cj)
    np.testing.assert_allclose([cp[k] for k in cj], [cj[k] for k in cj], rtol=1e-5, atol=1e-12)
    _assert_ranks_equal_up_to_ties(cj, cp, 2e-5)


def test_systolic_rounds_bit_equal_to_jax(graph):
    """The systolic twin (only the in-edges whose source changed in the round
    before, every byte set before round 1) gives JAX's merge_iteration
    round by round to the fixpoint, at precision 6 and 8: the same
    registers, change bytes (new != old).any(1), and the same round count
    (no byte set exactly where JAX's round changes nothing)."""
    _, jg, _ = graph
    ef, et = _edge_arrays(jg)
    for precision in (6, 8):
        regs0 = jax_hll.init_registers(jg.num_nodes, precision)
        rj, rp = jnp.asarray(regs0), torch.from_numpy(regs0)
        flags = torch.ones(jg.num_nodes, dtype=torch.uint8)
        for _ in range(64):
            new_j = jax_hll.merge_iteration(rj, jnp.asarray(ef), jnp.asarray(et))
            new_p, flags = hll_ops.merge_systolic_plain(rp, flags, torch.from_numpy(ef),
                                                        torch.from_numpy(et))
            np.testing.assert_array_equal(new_p.numpy(), np.asarray(new_j))
            np.testing.assert_array_equal(flags.numpy(),
                                          np.any(np.asarray(new_j) != np.asarray(rj), axis=1))
            if not flags.any():
                assert bool(jnp.all(new_j == rj))
                break
            rj, rp = new_j, new_p
        else:
            pytest.fail("no fixpoint in 64 rounds")


def test_systolic_twin_skips_rows_whose_byte_is_clear():
    """The change bytes are read, not implied: on the path 0 -> 1 -> 2,
    after round 1 (which changes rows 1 and 2) clearing row 1's byte keeps
    row 0's register out of row 2 in round 2, where the full merge brings
    it in; the flagged ring step skips the same row. With every byte set
    both twins are the full merge."""
    regs0 = torch.from_numpy(hll_ops.init_registers(3, 6))
    assert len({int(torch.argmax(r)) for r in regs0}) == 3  # one register each, apart
    ef, et = torch.tensor([0, 1]), torch.tensor([1, 2])
    regs1, flags = hll_ops.merge_systolic_plain(regs0, None, ef, et)
    assert flags.tolist() == [0, 1, 1]
    full = hll_ops.merge_iteration_plain(regs1, ef, et)
    assert torch.equal(hll_ops.merge_systolic_plain(regs1, flags, ef, et)[0], full)
    assert torch.equal(hll_ops.merge_systolic_plain(regs1, torch.ones(3, dtype=torch.uint8),
                                                    ef, et)[0], full)
    cleared = flags.clone()
    cleared[1] = 0
    skipped, skipped_flags = hll_ops.merge_systolic_plain(regs1, cleared, ef, et)
    assert not torch.equal(skipped, full)
    assert torch.equal(skipped[2], regs1[2]) and skipped_flags.tolist() == [0, 0, 0]
    assert (full[2] == torch.maximum(regs0[0], regs1[2])).all()
    csr = in_csr(3, ef.numpy(), et.numpy(), "cpu")
    for fl, want in ((flags, full), (cleared, skipped), (None, full)):
        out = regs1.clone()
        hll_ops.ring_step_plain(out, regs1.clone(), csr, fl)
        assert torch.equal(out, want)


def test_store_reverse_csr_is_the_edges_sorted_by_target(graph):
    """The store's reverse CSR, which the card's jobs walk, equals the
    forward edges sorted by target (in_csr), long rows included."""
    name, _, pg = graph
    got = graph_in_csr(pg, "cpu")
    want = in_csr(pg.num_nodes, *PS.forward_edges(pg), "cpu")
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert name != "pareto2000" or got.long_rows.numel() > 0
    counts = np.diff(got.offsets.numpy())
    np.testing.assert_array_equal(got.long_rows.numpy(), np.flatnonzero(counts > LONG_ROW))


def _jax_rounds(g, precision: int) -> int:
    """The round count of the JAX package's HyperBall loop (the rounds that
    changed a register)."""
    ef, et = (jnp.asarray(a) for a in _edge_arrays(g))
    regs = jnp.asarray(jax_hll.init_registers(g.num_nodes, precision))
    for r in range(1, 65):
        new = jax_hll.merge_iteration(regs, ef, et)
        if bool(jnp.all(new == regs)):
            return r - 1
        regs = new
    return 64


def _assert_ranks_equal_up_to_ties(cj: dict, cp: dict, rtol: float) -> None:
    """Every node's port rank lies inside the rank range of its tie group:
    the nodes whose JAX values are within rtol of each other (chained)."""
    names = sorted(cj, key=lambda k: -cj[k])
    rp = PC.centrality_ranks(cp)
    lo = 0
    for i in range(1, len(names) + 1):
        if i == len(names) or abs(cj[names[i]] - cj[names[i - 1]]) > rtol * max(
                abs(cj[names[i - 1]]), 1e-12):
            for k in names[lo:i]:
                assert lo <= rp[k] <= i - 1, (k, rp[k], lo, i - 1)
            lo = i


def test_harmonic_centrality_matches_jax(graph):
    _, jg, pg = graph
    for precision in (6, 8):
        cj = JC.harmonic_centrality(jg, precision=precision)
        timings = {}
        cp = PC.harmonic_centrality(pg, precision=precision, device="cpu", timings=timings)
        assert timings["n_rounds"] == _jax_rounds(jg, precision)
        assert list(cp) == list(cj)
        np.testing.assert_allclose([cp[k] for k in cj], [cj[k] for k in cj], rtol=1e-5,
                                   atol=1e-12)
        _assert_ranks_equal_up_to_ties(cj, cp, 2e-5)


def test_distances_exactly_equal(graph):
    name, jg, pg = graph
    n = jg.num_nodes
    sources = list(range(min(n, 40)))
    dj = JS.distances_many(jg, sources)
    dp = PS.distances_many(pg, sources, device="cpu")
    assert dp.dtype == np.int32 and dp.shape == (len(sources), n)
    np.testing.assert_array_equal(dp, dj)
    assert name != "loops" or (dj == JS.UNREACHABLE).any()  # compared like any distance
    for s in (0, n - 1, jg.name_of(n // 2)):
        assert PS.distances(pg, s, device="cpu") == JS.distances(jg, s)


@pytest.mark.parametrize("S", [1, 3, 32, 40, 256])
def test_frontier_step_follows_the_relaxation_round_by_round(graph, S):
    """K7's plain twin, the bitset frontier step, started from the BFS start
    state from S sources (capped at the node count), gives relax_plain's and
    the JAX package's vmapped `_relax`'s distances round by round, the same
    changed flag, seen bits exactly where a distance is finite (the padding
    bits past S set); bfs with max_rounds under the depth equals
    distances_many with the same max_rounds."""
    _, jg, pg = graph
    n = jg.num_nodes
    S = min(S, n)
    ef, et = _edge_arrays(pg)
    sources = np.random.default_rng(S).choice(n, size=S, replace=False)
    relax = jax.jit(jax.vmap(JS._relax, in_axes=(0, None, None)))
    jef, jet = jnp.asarray(ef), jnp.asarray(et)
    state = PS.bfs_start(n, sources, "cpu")
    dist = state.dist[:, :S].t().contiguous()
    depth = 0
    while True:
        new, changed = PS.frontier_step_plain(state, ef, et, depth)
        ref = PS.relax_plain(dist, ef, et)
        jref = np.asarray(relax(jnp.asarray(dist.numpy()), jef, jet))
        np.testing.assert_array_equal(ref.numpy(), jref)
        np.testing.assert_array_equal(new.dist[:, :S].t().numpy(), jref)
        assert bool(changed.item()) == (not torch.equal(ref, dist))
        bits = PS.unpack_bits(new.seen)
        assert torch.equal(bits[:, :S].t().bool(), ref < int(PS.UNREACHABLE))
        assert bits[:, S:].all()
        if not changed.item():
            break
        state, dist, depth = new, ref, depth + 1
    src = [int(x) for x in sources]
    for cap in sorted({0, depth // 2, max(depth - 1, 0)}):
        np.testing.assert_array_equal(PS.bfs(n, ef, et, src, max_rounds=cap, device="cpu"),
                                      JS.distances_many(jg, src, max_rounds=cap))


def test_bfs_start_and_bit_packing():
    """Each source in its own column, a repeated source too: seen and the
    frontier hold its bit alone, its distance 0; the padding bits past S set
    in seen and clear in the frontier; pack_bits inverts unpack_bits on any
    words, bit 31 included."""
    sources = [3, 3, 5] + list(range(30))  # 33 columns: two words, 31 padding bits
    st = PS.bfs_start(40, sources, "cpu")
    assert st.seen.shape == (40, 2) and st.dist.shape == (40, 64)
    want = torch.zeros((40, 64), dtype=torch.int32)
    want[torch.tensor(sources), torch.arange(33)] = 1
    assert torch.equal(PS.unpack_bits(st.frontier), want)
    seen = want.clone()
    seen[:, 33:] = 1
    assert torch.equal(PS.unpack_bits(st.seen), seen)
    assert torch.equal(st.dist == 0, want.bool())
    assert bool((st.dist[want == 0] == int(PS.UNREACHABLE)).all())
    words = torch.from_numpy(np.random.default_rng(0).integers(-2**31, 2**31, (7, 3))
                             .astype(np.int32))
    assert torch.equal(PS.pack_bits(PS.unpack_bits(words)), words)


def test_approx_harmonic_matches_jax(graph):
    _, jg, pg = graph
    for k in (3, 256):
        aj = JS.approx_harmonic_centrality(jg, num_samples=k, seed=4)
        ap = PS.approx_harmonic_centrality(pg, num_samples=k, seed=4, device="cpu")
        assert list(ap) == list(aj)
        np.testing.assert_allclose([ap[x] for x in aj], [aj[x] for x in aj], rtol=1e-9,
                                   atol=0)


def test_exact_harmonic_ordering(tmp_path):
    b = WebgraphBuilder()
    for f, t in GRAPHS["star"]:
        b.insert(Edge(f, t))
    b.build(str(tmp_path / "g"))
    exact = PC.exact_harmonic_centrality(Webgraph(str(tmp_path / "g")))
    assert max(exact, key=exact.get) == "hub.com"
    assert exact == JC.exact_harmonic_centrality(JaxWebgraph(str(tmp_path / "g")))
    hb = PC.harmonic_centrality(Webgraph(str(tmp_path / "g")), precision=8, device="cpu")
    assert max(hb, key=hb.get) == "hub.com"


def test_kv_stores_cross_readable(tmp_path):
    rng = np.random.default_rng(7)
    c = {f"h{i}.example": float(v) for i, v in enumerate(rng.random(500))}
    c["tie.example"] = c["h3.example"]
    PC.store_harmonic(c, str(tmp_path / "port"))
    JC.store_harmonic(c, str(tmp_path / "jax"))
    ranks = JC.centrality_ranks(c)
    for path in ("port", "jax"):
        for cls in (JaxDb, Db):
            db = cls.open(str(tmp_path / path))
            assert len(db) == len(c)
            for name in ("h0.example", "h499.example", "tie.example"):
                assert db.get(name.encode()) == {"centrality": c[name], "rank": ranks[name]}
            assert dict(db.items()) == {k.encode(): {"centrality": v, "rank": ranks[k]}
                                        for k, v in c.items()}
    (sp,), (sj,) = ([s for s in os.listdir(tmp_path / p) if s.startswith("seg-")]
                    for p in ("port", "jax"))
    for f in os.listdir(tmp_path / "jax" / sj):
        assert filecmp.cmp(tmp_path / "port" / sp / f, tmp_path / "jax" / sj / f, shallow=False), f


def test_graph_writer_matches_the_builder_byte_for_byte(tmp_path):
    rng = np.random.default_rng(1)
    names = [f"h{i}.example" for i in range(60)]
    src, dst = rng.integers(0, 60, 400), rng.integers(0, 60, 400)
    b = WebgraphBuilder()
    for f, t in zip(src, dst):
        b.insert(Edge(names[f], names[t]))
    b.build(str(tmp_path / "jax"))
    g = write_graph(str(tmp_path / "port"), names, src, dst)
    for f in sorted(os.listdir(tmp_path / "jax")):
        assert filecmp.cmp(tmp_path / "jax" / f, tmp_path / "port" / f, shallow=False), f
    # the JAX package reads the port's graph, and the port the JAX builder's
    jg = JaxWebgraph(str(tmp_path / "port"))
    assert jg.num_edges == g.num_edges and jg.num_nodes == g.num_nodes
    for r in (0, 7, g.num_nodes - 1):
        assert jg.name_of(r) == g.name_of(r) == g.names()[r]
        assert jg.backlinks(r) == Webgraph(str(tmp_path / "jax")).backlinks(r)


def _configs(tmp_path, graph_path: str) -> dict:
    out = {}
    for pkg in ("jax", "port"):
        for mode in ("harmonic", "approx-harmonic", "harmonic-nearest-seed"):
            extra = (f'original_centrality_path = "{tmp_path}/{pkg}-harmonic"\n'
                     'discount_factor = 0.5\n' if mode == "harmonic-nearest-seed" else
                     "num_samples = 5\n")
            p = tmp_path / f"{pkg}-{mode}.toml"
            p.write_text(f'webgraph_path = "{graph_path}"\noutput_path = "{tmp_path}/{pkg}-{mode}"\n'
                         f"precision = 6\n{extra}")
            out[(pkg, mode)] = str(p)
    return out


def test_centrality_command_line_matches_jax(tmp_path, capsys):
    b = WebgraphBuilder()
    for f, t in _edges("random30") + [("x0", "x1")]:  # x1 has no centrality seed of its own
        b.insert(Edge(f, t))
    b.build(str(tmp_path / "g"))
    cfgs = _configs(tmp_path, str(tmp_path / "g"))
    for mode in ("harmonic", "approx-harmonic", "harmonic-nearest-seed"):
        jax_main(["centrality", mode, cfgs[("jax", mode)]])
        line_j = capsys.readouterr().out.strip().replace("jax-", "")
        port_main(["centrality", mode, cfgs[("port", mode)], "--device", "cpu"])
        line_p = capsys.readouterr().out.strip().replace("port-", "")
        assert line_p == line_j and line_j.startswith("centrality for ")
        dj = dict(JaxDb.open(str(tmp_path / f"jax-{mode}")).items())
        dp = dict(Db.open(str(tmp_path / f"port-{mode}")).items())
        assert dj.keys() == dp.keys() and dj
        for k in dj:
            np.testing.assert_allclose(dp[k]["centrality"], dj[k]["centrality"], rtol=1e-5)


def test_cuda_without_a_card_raises(tmp_path):
    """device="cuda" without a card raises; nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    b = WebgraphBuilder()
    for f, t in GRAPHS["chain"]:
        b.insert(Edge(f, t))
    g = b.build(str(tmp_path / "g")) and Webgraph(str(tmp_path / "g"))
    for call in (lambda: PC.harmonic_centrality(g), lambda: PS.distances(g, 0),
                 lambda: PS.approx_harmonic_centrality(g, 2),
                 lambda: port_main(["centrality", "harmonic", str(_configs(
                     tmp_path, str(tmp_path / "g"))[("port", "harmonic")])])):
        with pytest.raises(RuntimeError):
            call()
    with pytest.raises(RuntimeError):  # a mesh of two shards on the card
        PC.harmonic_centrality_sharded(g, _cuda_mesh(2))
    with pytest.raises(RuntimeError):
        PM.make_mesh(2, ("x",), device="cuda")


def _cuda_mesh(n: int):
    return PM.Mesh([torch.device("cuda", 0)] * n, axis_names=("x",))


# ---- the sharded HyperBall (K8's twin), on a mesh of CPU entries ---------------------------
def _graph_edges(name: str):
    """(n, sources i32, targets i32): the ring of tests/test_webgraph.py and
    the 40-host random graph of tests/test_sharded_search.py."""
    if name == "ring":
        edges = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 0), (0, 2), (1, 3)]
        n = 5
    else:
        rng = np.random.default_rng(5)
        n = 40
        edges = []
        for _ in range(200):
            i, j = rng.integers(0, n, 2)
            if i != j:
                edges.append((int(i), int(j)))
    src, dst = (np.array(x, dtype=np.int32) for x in zip(*edges))
    return n, src, dst


@pytest.mark.parametrize("graph", ["ring", "random40"])
@pytest.mark.parametrize("n_shards", [1, 3, 4, 8])
def test_sharded_hyperball_rounds_bit_equal_to_jax(monkeypatch, graph, n_shards):
    """The port's ring rounds (hll_ring_step's plain twin) against the JAX
    package's round_fn: the full ring and the flagged (systolic) ring, whose
    change bytes travel with their shards, both give the padded registers
    bit-equal after every round, the flagged ring's change bytes are
    (new != old).any(1), the same round count, centrality within rtol 1e-5
    of JAX's and 1e-9 of the port's single-device form. Uneven shards (5
    nodes over 3, 4, 8) pad."""
    from stract_tpu.ops import hll_ops as jax_hll
    from stract_tpu.webgraph import centrality as JC
    from stract_tpu_torch.ops import hll_ops
    from stract_tpu_torch.webgraph import centrality as PC

    n, src, dst = _graph_edges(graph)
    seen = []  # the JAX registers each size estimate reads: the start, then every round
    real_jit = jax.jit

    def spy_jit(f, *a, **k):
        g = real_jit(f, *a, **k)
        if f is jax_hll.estimate_sizes:
            def rec(x):
                seen.append(np.asarray(x))
                return g(x)
            return rec
        return g

    monkeypatch.setattr(jax, "jit", spy_jit)
    acc_j = JC._hyperball_sharded(n, src, dst, _jax_mesh(n_shards), 6)
    monkeypatch.undo()
    assert len(seen) >= 2

    mesh = _port_mesh(n_shards)
    devices = list(mesh.devices.flat)
    S = -(-n // n_shards)
    buckets = PC.ring_buckets(n, src, dst, devices)
    regs0 = np.zeros((S * n_shards, 64), np.uint8)
    regs0[:n] = hll_ops.init_registers(n, 6)
    np.testing.assert_array_equal(regs0, seen[0])
    shards = [torch.from_numpy(regs0[d * S:(d + 1) * S]) for d in range(n_shards)]
    flagged = list(shards)
    flags = [torch.ones(S, dtype=torch.uint8) for _ in range(n_shards)]
    for want in seen[1:]:
        shards, _, changed, _ = PC.ring_round(shards, buckets)
        assert any(int(c.item()) for c in changed)
        np.testing.assert_array_equal(torch.cat(shards).numpy(), want)
        old = torch.cat(flagged)
        flagged, _, changed_f, flags = PC.ring_round(flagged, buckets, flags=flags)
        np.testing.assert_array_equal(torch.cat(flagged).numpy(), want)
        np.testing.assert_array_equal(torch.cat(flags).numpy(), np.any(want != old.numpy(), 1))
        assert [int(c.item()) for c in changed_f] == [int(f.any()) for f in flags]
    _, _, changed, _ = PC.ring_round(shards, buckets)
    assert not any(int(c.item()) for c in changed)  # JAX stopped here too
    _, _, changed, flags = PC.ring_round(flagged, buckets, flags=flags)
    assert not any(int(c.item()) for c in changed) and not any(f.any() for f in flags)

    timings: dict = {}
    acc_p = PC._hyperball_sharded(n, src, dst, mesh, 6, timings=timings)
    assert timings["n_rounds"] == len(seen) - 1
    np.testing.assert_allclose(acc_p, acc_j, rtol=1e-5)
    acc_1 = PC._hyperball(n, src, dst, 6, 64, "cpu")
    np.testing.assert_allclose(acc_p, acc_1, rtol=0, atol=1e-9)


def test_harmonic_centrality_sharded_on_the_40_host_graph(tmp_path):
    """harmonic_centrality_sharded on a 4-entry mesh against the JAX
    package's on 4 devices (rtol 1e-5) and the port's single-device form
    (1e-9), on the 40-host graph of tests/test_sharded_search.py;
    run_harmonic(mesh=) takes it."""
    from stract_tpu.webgraph.centrality import harmonic_centrality_sharded as jax_sharded
    from stract_tpu.webgraph.edge import Edge
    from stract_tpu.webgraph.store import Webgraph as JaxWebgraph, WebgraphBuilder
    from stract_tpu_torch.entrypoint.centrality import run_harmonic
    from stract_tpu_torch.webgraph import Webgraph
    from stract_tpu_torch.webgraph.centrality import (harmonic_centrality,
                                                      harmonic_centrality_sharded)

    rng = np.random.default_rng(5)
    b = WebgraphBuilder(host_graph=True)
    names = [f"h{i}.com" for i in range(40)]
    for _ in range(200):
        i, j = rng.integers(0, 40, 2)
        if i != j:
            b.insert(Edge(names[i], names[j]))
    path = b.build(str(tmp_path / "g")).path
    pg = Webgraph(path)
    want = jax_sharded(JaxWebgraph(path), _jax_mesh(4))
    got = harmonic_centrality_sharded(pg, _port_mesh(4))
    single = harmonic_centrality(pg, device="cpu")
    assert set(got) == set(want) == set(single)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5 * abs(want[k]) and abs(got[k] - single[k]) < 1e-9, k
    timings: dict = {}
    c = run_harmonic(path, str(tmp_path / "kv"), device="cpu", timings=timings,
                     mesh=_port_mesh(4))
    assert c == got and {"bucket", "setup", "estimate", "rounds", "n_rounds"} <= set(timings)


def test_sharded_harmonic_matches_jax(graph):
    """harmonic_centrality_sharded on a mesh of 4 CPU entries against the
    JAX package's on 4 devices (rtol 1e-5) and the port's single-device
    form (1e-9), with the same round count, on every graph of this file."""
    _, jg, pg = graph
    want = JC.harmonic_centrality_sharded(jg, _jax_mesh(4))
    timings: dict = {}
    got = PC.harmonic_centrality_sharded(pg, _port_mesh(4), timings=timings)
    single = PC.harmonic_centrality(pg, device="cpu")
    assert list(got) == list(single) and set(got) == set(want)
    assert timings["n_rounds"] == _jax_rounds(jg, 6)
    np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], rtol=1e-5,
                               atol=1e-12)
    np.testing.assert_allclose([got[k] for k in single], [single[k] for k in single], rtol=0,
                               atol=1e-9)


def test_bench_sharded_arm_matches_the_single_device_hyperball(tmp_path):
    """bench_centrality's --sharded arm (on CPU entries here; the command
    line times it on the card): parity with the single-device HyperBall of
    as many rounds, and the tool's fields."""
    from stract_tpu_torch.entrypoint.bench_centrality import sharded_arm

    src, dst = make_edges(3000, 30_000, seed=0)
    g = write_graph(str(tmp_path / "g"), [f"h{i}.example" for i in range(3000)], src, dst)
    rec = sharded_arm(g, 3, 8, torch.device("cpu"))
    assert rec["parity_vs_single_device"] and rec["devices"] == 3 and rec["rounds_run"] == 8
    assert rec["per_device_reg_mb"] == 3 * 1000 * 64 / 1e6
    assert {"round_s_median", "total_s", "bucket_s", "allgather_design_reg_mb"} <= set(rec)
