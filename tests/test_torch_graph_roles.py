"""The rest of the graph in the port (webgraph/remote.py, webgraph/
betweenness.py, entrypoint/webgraph_server.py, `main.py webgraph | webgraph-
server | ampc`) against the JAX package, on the CPU.

Tolerance: none. Every RemoteWebgraph answer over two shards equals the JAX
package's, with the servers and the fan-out of either package (the merged
group sketches by their register bytes); betweenness equals the JAX
function's dict exactly (the same float operations in the same order); the
graph files `webgraph create | merge` write are byte-equal; the AMPC roles
over gossip give the JAX roles' centralities and distances exactly, and
the port's single-device HyperBall within 1e-4 (tests/test_ampc.py's
tolerance). Every wait on gossip or a process is bounded.
"""

from __future__ import annotations

import importlib
import os
import socket
import subprocess
import sys
import time
from contextlib import contextmanager

import numpy as np
import pytest
import torch

from test_torch_indexer import tree_diff

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = {"jax": "stract_tpu", "port": "stract_tpu_torch"}


def mod(pkg: str, name: str):
    return importlib.import_module(f"{PKG[pkg]}.{name}")


def _free_port(kind=socket.SOCK_STREAM) -> int:
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def seeded_edges(rng, hosts: int, pages: int, n: int) -> list:
    """n (from, to, label) links between pages of `hosts` hosts."""
    names = [f"h{int(h)}.com/p{int(p)}" for h, p in zip(rng.integers(0, hosts, pages),
                                                       rng.integers(0, 9, pages))]
    out = []
    for f, t in rng.integers(0, len(names), (n, 2)):
        out.append((names[f], names[t], f"{names[f]} to {names[t]}"))
    return out


@pytest.fixture(scope="module")
def shard_dirs(tmp_path_factory):
    """Two shards of a host graph and two of a page graph (the JAX
    package's builder; both packages read the directories)."""
    from stract_tpu.webgraph import Edge, WebgraphBuilder

    rng = np.random.default_rng(11)
    out = {}
    for level in ("host", "page"):
        edges = seeded_edges(rng, 12, 60, 160)
        for sid, part in enumerate((edges[:90], edges[90:])):
            b = WebgraphBuilder(host_graph=level == "host")
            for f, t, label in part:
                b.insert(Edge(f, t, label=label))
            path = str(tmp_path_factory.mktemp(f"{level}{sid}"))
            b.build(path)
            out.setdefault(level, []).append(path)
    return out


@contextmanager
def remote(shard_dirs: list, server_pkg: str, client_pkg: str):
    """WebGraphService of `server_pkg` over each shard directory, and the
    RemoteWebgraph of `client_pkg` over them → (remote, services)."""
    ws = mod(server_pkg, "entrypoint.webgraph_server")
    sonic = mod(server_pkg, "distributed.sonic")
    graph_cls = mod(server_pkg, "webgraph").Webgraph
    rep = mod(client_pkg, "distributed.replication")
    services = [ws.WebGraphService(graph_cls(p), sid) for sid, p in enumerate(shard_dirs)]
    servers = [sonic.serve_in_thread(s) for s in services]
    shards = {sid: rep.ReplicatedClient([s.addr]) for sid, s in enumerate(servers)}
    try:
        yield mod(client_pkg, "webgraph.remote").RemoteWebgraph(rep.ShardedClient(shards)), services
    finally:
        for c in shards.values():
            for r in c.clients:
                r.close()
        for s in servers:
            s.stop()


def answers(r, hosts: list, pages: list) -> dict:
    """Every RemoteWebgraph method on the given nodes (the group sketches
    as {host: register bytes})."""
    from stract_tpu_torch.utils.hashing import prehash

    out = {}
    for n in hosts:
        out[("backlinks", n)] = r.backlinks(n, limit=5)
        out[("forwardlinks", n)] = r.forwardlinks(n)
        out[("labels", n)] = r.backlink_labels(n, limit=3)
        out[("knows", n)] = r.knows(n)
        out[("id2node", n)] = r.id2node(prehash(n))
    if hosts:
        out["knows-nothing"] = r.knows("nothing.example")
        out["id2node-nothing"] = r.id2node(12345)
        out["batch"] = r.batch_search_backlinks(hosts[:4], limit=3)
        out["similar"] = r.similar_hosts(hosts[:3], top_k=5)
    for n in pages:
        for d in ("to", "from"):
            out[("sketch", n, d)] = {h: s.to_bytes()
                                     for h, s in r.group_sketch(n, d, precision=8).items()}
            out[("exact", n, d)] = r.group_exact(n, d, limit=3)
    return out


def test_remote_webgraph_answers_every_method_as_the_jax_package(shard_dirs):
    """Two host-graph shards and two page-graph shards: the RemoteWebgraph of
    each package over the WebGraphServices of each package (four pairings,
    over sonic) answers every method as the JAX pair does, and the JAX
    answers are not empty."""
    from stract_tpu.webgraph import Webgraph

    hosts = [Webgraph(shard_dirs["host"][0]).name_of(i) for i in range(8)]
    pg = Webgraph(shard_dirs["page"][1])
    pages = [pg.name_of(i) for i in range(0, pg.num_nodes, max(1, pg.num_nodes // 6))]
    got = {}
    for server_pkg in ("jax", "port"):
        for client_pkg in ("jax", "port"):
            with remote(shard_dirs["host"], server_pkg, client_pkg) as (rh, services):
                a = answers(rh, hosts, [])
                ids = [0, 3, 7]
                a["profiles"] = [s.inbound_profiles({"node_ids": ids}) for s in services]
            with remote(shard_dirs["page"], server_pkg, client_pkg) as (rp, _):
                a.update(answers(rp, [], pages))
            got[(server_pkg, client_pkg)] = a
    want = got[("jax", "jax")]
    for pair, a in got.items():
        assert a.keys() == want.keys(), pair
        for k in want:
            assert a[k] == want[k], (pair, k)
    assert any(want[("backlinks", h)] for h in hosts) and want["similar"]
    assert any(want[("sketch", p, "to")] for p in pages)
    assert any(want[("exact", p, "from")] for p in pages)


@pytest.mark.parametrize("samples", [None, 5])
def test_betweenness_matches_jax(samples, tmp_path):
    """Brandes' algorithm, exact and over 5 sources sampled from
    default_rng(3), on a seeded 60-node graph: the JAX function's dict."""
    from stract_tpu.webgraph import Edge, WebgraphBuilder
    from stract_tpu.webgraph.betweenness import betweenness_centrality as jax_bc
    from stract_tpu_torch.webgraph import Webgraph
    from stract_tpu_torch.webgraph.betweenness import betweenness_centrality

    rng = np.random.default_rng(4)
    b = WebgraphBuilder()
    for f, t in rng.integers(0, 60, (240, 2)):
        b.insert(Edge(f"n{f}", f"n{t}"))
    jg = b.build(str(tmp_path / "g"))
    got = betweenness_centrality(Webgraph(str(tmp_path / "g")), samples, seed=3)
    want = jax_bc(jg, samples, seed=3)
    assert list(got.items()) == list(want.items()) and max(want.values()) > 0


def _write_cfg(path, text: str) -> str:
    path.write_text(text)
    return str(path)


def test_main_webgraph_create_and_merge(tmp_path, capsys):
    """`main.py webgraph create` of each package over the same seeded WARC
    files, host and page level, then `webgraph merge` of the two page
    graphs: byte-equal directories and the same printed lines."""
    from stract_tpu.main import main as jax_main
    from stract_tpu_torch.main import main as port_main
    from stract_tpu_torch.warc_corpus import write_warcs

    info = write_warcs(str(tmp_path / "warc"), files=2, pages=25, seed=6, hosts=20,
                       words=(40, 80))
    lines = {}
    for pkg, main in (("jax", jax_main), ("port", port_main)):
        for level in ("host", "page"):
            for i, w in enumerate(info.paths):
                cfg = _write_cfg(tmp_path / f"{pkg}-{level}{i}.toml",
                                 f'warc_paths = ["{w}"]\noutput_path = "{tmp_path}/{pkg}-'
                                 f'{level}{i}"\nlevel = "{level}"\n')
                main(["webgraph", "create", cfg])
        cfg = _write_cfg(tmp_path / f"{pkg}-merge.toml",
                         f'warc_paths = ["{tmp_path}/{pkg}-page0", "{tmp_path}/{pkg}-page1"]\n'
                         f'output_path = "{tmp_path}/{pkg}-merged"\n')
        main(["webgraph", "merge", cfg])
        lines[pkg] = [x.replace(f"{tmp_path}/{pkg}-", "")
                      for x in capsys.readouterr().out.splitlines()]
    assert lines["port"] == lines["jax"] and len(lines["jax"]) == 5
    for name in ("host0", "host1", "page0", "page1", "merged"):
        assert tree_diff(str(tmp_path / f"jax-{name}"), str(tmp_path / f"port-{name}")) == [], name
    from stract_tpu_torch.webgraph import Webgraph

    merged = Webgraph(str(tmp_path / "port-merged"))
    assert merged.num_edges > Webgraph(str(tmp_path / "port-page0")).num_edges > 0


def test_main_webgraph_server_as_a_process(shard_dirs, tmp_path):
    """`python -m stract_tpu_torch.main webgraph-server CONFIG` for shard 1
    and a JAX WebGraphService for shard 0, found by gossip: the JAX
    package's RemoteWebgraph.from_cluster answers as over two local JAX
    services."""
    from stract_tpu.distributed.cluster import Cluster, Service
    from stract_tpu.entrypoint import webgraph_server as jws
    from stract_tpu.webgraph import Webgraph

    seed = Cluster.join(Service("api"), interval=0.1, failure_timeout=5.0)
    cfg = _write_cfg(tmp_path / "wg.toml",
                     f'graph_path = "{shard_dirs["host"][1]}"\nshard = 1\nport = {_free_port()}\n'
                     f'[gossip]\naddr = "127.0.0.1:{_free_port(socket.SOCK_DGRAM)}"\n'
                     f'seeds = ["{seed.gossip_addr[0]}:{seed.gossip_addr[1]}"]\n')
    proc = subprocess.Popen([sys.executable, "-m", "stract_tpu_torch.main", "webgraph-server",
                             cfg], cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    local, local_cluster = jws.run(shard_dirs["host"][0], 0, gossip_seeds=[seed.gossip_addr])
    r = None
    try:
        assert proc.stdout.readline().startswith("webgraph-server shard=1 rpc=")
        assert _await_shards(seed, "webgraph", 2) == [0, 1]
        r = importlib.import_module("stract_tpu.webgraph.remote").RemoteWebgraph.from_cluster(seed)
        hosts = [Webgraph(shard_dirs["host"][1]).name_of(i) for i in range(6)]
        with remote(shard_dirs["host"], "jax", "jax") as (want, _):
            assert answers(r, hosts, []) == answers(want, hosts, [])
    finally:
        proc.kill()
        proc.wait(timeout=60)
        for replicated in r.client.get().shards.values() if r is not None else ():
            for c in replicated.clients:
                c.close()
        local_cluster.shutdown()
        local.stop()
        seed.shutdown()


def _await_shards(seed, kind: str, n: int, timeout: float = 120.0) -> list:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        shards = sorted(s.shard for s in seed.services(kind))
        if len(shards) >= n:
            return shards
        time.sleep(0.1)
    return sorted(s.shard for s in seed.services(kind))


@pytest.fixture(scope="module")
def ampc_graph(tmp_path_factory):
    from stract_tpu_torch.entrypoint.bench_centrality import write_bench_graph

    return write_bench_graph(str(tmp_path_factory.mktemp("ampc-roles") / "g"), 200, 1_500,
                             seed=8).path


def test_main_ampc_roles_over_gossip(ampc_graph, tmp_path, capsys):
    """As tests/test_process_roles.py runs the JAX roles: `main.py ampc dht`
    of the port as its own process, two harmonic workers (CPU) and two
    shortest-path workers of entrypoint/ampc.py, and `main.py ampc
    harmonic-coordinator | approx-harmonic-coordinator |
    shortest-path-coordinator`; the centralities and distances equal the
    JAX AMPC's, the harmonic ones within 1e-4 of the port's HyperBall."""
    from stract_tpu.ampc import dht as JD
    from stract_tpu.ampc import harmonic as JH
    from stract_tpu.ampc import shortest_path as JS
    from stract_tpu.ampc import worker as JW
    from stract_tpu.webgraph import Webgraph as JaxWebgraph
    from stract_tpu_torch.distributed.cluster import Cluster, Service
    from stract_tpu_torch.entrypoint import ampc as ep
    from stract_tpu_torch.kv import Db
    from stract_tpu_torch.main import main as port_main
    from stract_tpu_torch.webgraph import Webgraph
    from stract_tpu_torch.webgraph.centrality import harmonic_centrality

    def gossip(seed) -> str:
        return (f'[gossip]\naddr = "127.0.0.1:0"\nseeds = ["{seed.gossip_addr[0]}:'
                f'{seed.gossip_addr[1]}"]\n')

    def coordinate(role: str, seed, extra: str = "") -> None:
        cfg = _write_cfg(tmp_path / f"{role}.toml",
                         f'webgraph_path = "{ampc_graph}"\nnum_shards = 2\noutput_path = '
                         f'"{tmp_path}/{role}"\nwait_s = 60\n{extra}{gossip(seed)}')
        port_main(["ampc", role, cfg])

    name = Webgraph(ampc_graph).name_of(5)
    # the harmonic deployment: the DHT a process of its own
    seed = Cluster.join(Service("admin"), interval=0.1, failure_timeout=5.0)
    dht_cfg = _write_cfg(tmp_path / "dht.toml", f"node_id = 0\nport = {_free_port()}\n"
                         f"{gossip(seed)}")
    dht = subprocess.Popen([sys.executable, "-m", "stract_tpu_torch.main", "ampc", "dht", dht_cfg],
                           cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    roles = []
    try:
        assert dht.stdout.readline().startswith("ampc dht shard=0 rpc=")
        roles = [ep.run_harmonic_worker(ampc_graph, s, 2, gossip_seeds=[seed.gossip_addr],
                                        device="cpu") for s in range(2)]
        coordinate("harmonic-coordinator", seed)
    finally:
        dht.kill()
        dht.wait(timeout=60)
        for server, cluster in roles:
            cluster.shutdown()
            server.stop()
        seed.shutdown()
    # the shortest-path deployment, in another gossip cluster
    seed = Cluster.join(Service("admin"), interval=0.1, failure_timeout=5.0)
    dht_srv, dht_cluster, _ = ep.run_dht(gossip_seeds=[seed.gossip_addr])
    roles = [ep.run_shortest_path_worker(ampc_graph, s, 2, gossip_seeds=[seed.gossip_addr])
             for s in range(2)]
    try:
        coordinate("approx-harmonic-coordinator", seed, "num_samples = 4\nseed = 1\n")
        coordinate("shortest-path-coordinator", seed, f'source = "{name}"\n')
    finally:
        for server, cluster in roles + [(dht_srv, dht_cluster)]:
            cluster.shutdown()
            server.stop()
        seed.shutdown()
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"harmonic centrality for 200 nodes → {tmp_path}/harmonic-coordinator"
    got = {role: dict(Db.open(str(tmp_path / role)).items()) for role in
           ("harmonic-coordinator", "approx-harmonic-coordinator", "shortest-path-coordinator")}

    # the JAX AMPC in process over the same graph
    jg = JaxWebgraph(ampc_graph)
    servers, client = JD.start_dht(1)
    workers = [JW.start_worker(JH.HarmonicWorker(s, 2, ef, et, jg.num_nodes))
               for s, (ef, et) in enumerate(JH.partition_edges(jg, 2))]
    sp = [JW.start_worker(JS.ShortestPathWorker(s, 2, ef, et, jg.num_nodes))
          for s, (ef, et) in enumerate(JH.partition_edges(jg, 2))]
    try:
        cent = JH.run_distributed_harmonic(jg, [w.addr for w in workers], client, 2)
        dist = JS.run_distributed_shortest_path(jg, name, [w.addr for w in sp], client, 2)
    finally:
        for c in client.clients:
            c.close()
        for s in servers + workers + sp:
            s.stop()
    assert {k.decode(): v["centrality"] for k, v in got["harmonic-coordinator"].items()} == cent
    assert {k.decode(): v for k, v in got["shortest-path-coordinator"].items()} == dist
    single = harmonic_centrality(Webgraph(ampc_graph), precision=6, device="cpu")
    assert max(abs(cent[k] - v) for k, v in single.items()) < 1e-4
    assert sum(v["centrality"] > 0 for v in got["approx-harmonic-coordinator"].values()) > 4


def test_main_ampc_harmonic_worker_on_cuda_without_a_card_raises(ampc_graph, tmp_path):
    """`main.py ampc harmonic-worker CONFIG` defaults to --device cuda; with
    no card it raises before serving, and nothing falls back to the CPU;
    --device on another role is refused."""
    from stract_tpu_torch.main import main as port_main

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = _write_cfg(tmp_path / "w.toml", f'webgraph_path = "{ampc_graph}"\nnum_shards = 1\n')
    for argv in (["ampc", "harmonic-worker", cfg], ["ampc", "harmonic-worker", cfg,
                                                    "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            port_main(argv)
    with pytest.raises(SystemExit):
        port_main(["ampc", "dht", cfg, "--device", "cpu"])
