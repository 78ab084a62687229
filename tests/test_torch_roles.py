"""The port's serving roles against the JAX package's on the CPU: the search
shard server (entrypoint/search_server.py SearchService over sonic RPC) and
the coordinator (searcher/distributed.py DistributedSearcher under the
ApiSearcher, entrypoint/api.py), in process and as two processes of
`python -m stract_tpu_torch.main`.

- Wire forms: a port coordinator reads a JAX shard server and a JAX
  coordinator reads a port shard server; every page equals the JAX
  package's single-process page for the same index.
- The two-level topology of tests/test_two_level_topology.py in the port:
  two shard servers, each serving its index from a mesh of 4 CPU shards,
  found by gossip; the coordinator's ranked urls equal the JAX package's
  single-process LocalSearcher over the union corpus.
- `main.py search-server` and `main.py api` as two processes (--device cpu):
  one POST to /beta/api/search answers the JAX package's page.

Pages are compared as tests/test_torch_slice.py compares them (scores rtol
1e-3 / atol 1e-3: the port's pass 2 runs on q16 rows; urls as sets above the
last score, titles and snippets equal). Every server, gossip join and
process has its own timeout.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from conftest import make_doc
from test_torch_slice import REQUESTS, _assert_pages_match, jax_searcher

from stract_tpu_torch import bench_corpus as bc_port

DOCS = 2000
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RPC_TIMEOUT = 180.0


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch-roles"))
    return bc_port.ensure_corpus(root, DOCS, seed=11, log=lambda *a: None)


@pytest.fixture(scope="module")
def reference_pages(index_dir):
    from stract_tpu.searcher.query import SearchQuery as JaxSQ

    api = jax_searcher(index_dir)
    return [api.search(JaxSQ.from_json(r)).to_json() for r in REQUESTS]


def _client(pkg: str, addr):
    """A coordinator's sharded client of one shard at `addr` (package
    `pkg`'s sonic)."""
    import importlib

    rep = importlib.import_module(f"{pkg}.distributed.replication")
    return rep.ShardedClient({0: rep.ReplicatedClient([addr], timeout=RPC_TIMEOUT)})


def test_coordinators_read_shard_servers_of_either_package(index_dir, reference_pages):
    """Port coordinator over a JAX shard server, JAX coordinator over a port
    shard server, and each over its own package's: the same pages."""
    from stract_tpu.distributed.sonic import serve_in_thread as jax_serve
    from stract_tpu.entrypoint.search_server import SearchService as JaxService
    from stract_tpu.index import InvertedIndex as JaxIndex
    from stract_tpu.searcher.api import ApiSearcher as JaxApi
    from stract_tpu.searcher.distributed import DistributedSearcher as JaxDist
    from stract_tpu.searcher.query import SearchQuery as JaxSQ
    from stract_tpu_torch.distributed.sonic import serve_in_thread
    from stract_tpu_torch.entrypoint.search_server import SearchService
    from stract_tpu_torch.index.inverted import InvertedIndex
    from stract_tpu_torch.searcher.api import ApiSearcher
    from stract_tpu_torch.searcher.distributed import DistributedSearcher
    from stract_tpu_torch.searcher.query import SearchQuery

    jsrv = jax_serve(JaxService(JaxIndex(index_dir), batching=False))
    psrv = serve_in_thread(SearchService(InvertedIndex(index_dir, "cpu"), batching=False))
    try:
        coordinators = {
            "port over jax": (ApiSearcher(DistributedSearcher(_client("stract_tpu_torch",
                                                                      jsrv.addr))), SearchQuery),
            "jax over port": (JaxApi(JaxDist(_client("stract_tpu", psrv.addr))), JaxSQ),
            "port over port": (ApiSearcher(DistributedSearcher(_client("stract_tpu_torch",
                                                                       psrv.addr))), SearchQuery),
        }
        for name, (api, sq_cls) in coordinators.items():
            pages = [api.search(sq_cls.from_json(r)).to_json() for r in REQUESTS]
            for ref, page in zip(reference_pages, pages):
                _assert_pages_match(ref, page)
            assert sum(len(p["webpages"]) for p in pages) > 20, name
        port = coordinators["port over port"][0].searcher
        assert port.size() == coordinators["jax over port"][0].searcher.size() == DOCS
    finally:
        jsrv.stop()
        psrv.stop()


def _shard_docs():
    """tests/test_two_level_topology.py's two shards of four docs."""
    mk = lambda s, i, topic, cent: make_doc(  # noqa: E731
        f"https://{topic.replace(' ', '')}{s}x{i}.com/p",
        f"{topic} page {s}-{i}", f"all about {topic} number {s} {i}",
        host_centrality=cent)
    shard0 = [mk(0, i, t, 0.3 + 0.1 * i) for i, t in enumerate(
        ["rust programming", "rust programming", "cooking pasta", "quantum physics"])]
    shard1 = [mk(1, i, t, 0.25 + 0.1 * i) for i, t in enumerate(
        ["rust programming", "python programming", "rust tooling", "gardening tips"])]
    return shard0, shard1


def test_two_level_topology_on_meshes(tmp_path_factory):
    """Two port shard servers, each serving its index (two segments) from a
    mesh of 4 CPU shards, found by gossip; the port coordinator's ranked urls
    and hit counts equal the JAX package's single-process searcher over the
    union corpus on the four queries of tests/test_two_level_topology.py,
    and a cross-shard retrieve fills every candidate."""
    from stract_tpu.index import InvertedIndex as JaxIndex
    from stract_tpu.searcher.api import ApiSearcher as JaxApi
    from stract_tpu.searcher.distributed import LocalShardedSearcher as JaxLocalSharded
    from stract_tpu.searcher.local import LocalSearcher as JaxLocal
    from stract_tpu.searcher.query import SearchQuery as JaxSQ
    from stract_tpu_torch.distributed.cluster import Cluster, Service
    from stract_tpu_torch.distributed.replication import ReusableShardedClient
    from stract_tpu_torch.distributed.sonic import serve_in_thread
    from stract_tpu_torch.entrypoint.search_server import SearchService
    from stract_tpu_torch.index.inverted import InvertedIndex
    from stract_tpu_torch.parallel.mesh import Mesh
    from stract_tpu_torch.searcher.api import ApiSearcher
    from stract_tpu_torch.searcher.distributed import DistributedSearcher
    from stract_tpu_torch.searcher.query import SearchQuery

    shards = _shard_docs()
    seed = Cluster.join(Service("api"), interval=0.1, failure_timeout=5.0)
    servers, clusters, services, api = [], [], [], None
    try:
        for sid, docs in enumerate(shards):
            path = str(tmp_path_factory.mktemp(f"tl_shard{sid}"))
            idx = JaxIndex(path)
            for i, d in enumerate(docs):
                idx.insert(d)
                if i == 1:
                    idx.commit()
            idx.commit()
            svc = SearchService(InvertedIndex(path, "cpu"), shard_id=sid,
                                mesh=Mesh([torch.device("cpu")] * 4))
            assert svc.searcher._sharded is not None and len(svc.searcher.index.segments) == 2
            services.append(svc)
            srv = serve_in_thread(svc)
            servers.append(srv)
            clusters.append(Cluster.join(
                Service("search-server", host=srv.addr, shard=sid),
                seeds=[seed.gossip_addr], interval=0.1, failure_timeout=5.0))
        for sid in (0, 1):
            assert seed.await_member(
                lambda m, sid=sid: m.service.kind == "search-server" and m.service.shard == sid,
                timeout=60)
        api = ApiSearcher(DistributedSearcher(ReusableShardedClient(seed, "search-server",
                                                                    refresh=0.5)))
        union = JaxIndex(str(tmp_path_factory.mktemp("tl_union")))
        for docs in shards:
            for d in docs:
                union.insert(d)
        union.commit()
        api_union = JaxApi(JaxLocalSharded([JaxLocal(union, 0)]))
        for q in ("rust programming", "programming", "pasta",
                  "site:gardeningtips1x3.com gardening"):
            dist = api.search(SearchQuery(query=q, return_ranking_signals=True))
            solo = api_union.search(JaxSQ(query=q, return_ranking_signals=True))
            assert [w["url"] for w in dist.webpages] == [w["url"] for w in solo.webpages], q
            assert dist.num_hits["value"] == solo.num_hits["value"], q
        cands, _ = api.searcher.search_initial(SearchQuery(query="rust"))
        api.searcher.retrieve(SearchQuery(query="rust"), cands)
        assert cands and all(c.retrieved for c in cands)
        assert {c.shard for c in cands} == {0, 1}
        url = "https://gardeningtips1x3.com/p"
        assert api.searcher.get_webpage(url)["url"] == url
        api.searcher.client.close()  # a later send reconnects
        assert api.searcher.size() == sum(len(docs) for docs in shards)
    finally:
        if api is not None:
            api.searcher.client.close()
        for c in clusters:
            c.shutdown()
        seed.shutdown()
        for s in servers:
            s.stop()
        for svc in services:
            svc.searcher.batcher.stop()


class _Echo:
    def echo(self, body):
        return body


def test_closed_coordinator_client_lets_a_shard_stop():
    """Closing the coordinator's pooled connections ends the shard server's
    handlers: the server then stops without waiting out its shutdown timeout
    and leaves no task pending on its loop; a later send reconnects."""
    import asyncio

    from stract_tpu_torch.distributed.cluster import Cluster, Service
    from stract_tpu_torch.distributed.replication import ReusableShardedClient
    from stract_tpu_torch.distributed.sonic import serve_in_thread

    srv = serve_in_thread(_Echo())
    shard = Cluster.join(Service("search-server", host=srv.addr, shard=0), interval=0.1,
                         failure_timeout=5.0)
    api = Cluster.join(Service("api"), seeds=[shard.gossip_addr], interval=0.1,
                       failure_timeout=5.0)
    stopped = False
    try:
        assert api.await_member(lambda m: m.service.kind == "search-server", timeout=60)
        client = ReusableShardedClient(api, "search-server")
        assert client.send("echo", {"x": 1}) == {0: [{"x": 1}]}
        client.close()
        assert client.send("echo", {"x": 2}) == {0: [{"x": 2}]}
        client.close()
        t0 = time.perf_counter()
        srv.stop()
        stopped = True
        assert time.perf_counter() - t0 < 2.0
        assert not asyncio.all_tasks(srv.loop)
    finally:
        api.shutdown()
        shard.shutdown()
        if not stopped:
            srv.stop()


def test_coordinator_options_build_on_the_cpu(index_dir, tmp_path, monkeypatch):
    """Each of the coordinator's page options alone, and configs/api.toml,
    build a coordinator on the CPU, wired as the JAX package's: a local
    SidebarManager when entity_index_path is set, else a RemoteSidebarManager
    and (without entity_image_store_path) a RemoteEntityImageStore over the
    gossip-found entity-search servers; the page graph and the image store
    when they are set; improvement_log_path read nowhere (the JAX app keeps
    its log in memory). configs/api.toml is built from a directory holding
    the files its relative paths name, on a free gossip port. A config with
    the spell_path, autosuggest_path and host_graph_path builds, as does a
    shard with a linear_model_path (its parity is tests/test_torch_optics.py's).
    The roles default to the card, which raises without one."""
    import dataclasses
    import inspect

    from stract_tpu_torch.autosuggest import Autosuggest
    from stract_tpu_torch.config import ApiConfig, load_config
    from stract_tpu_torch.distributed.sonic import RemoteClient
    from stract_tpu_torch.entity_index.index import EntityIndex, SidebarManager
    from stract_tpu_torch.entrypoint import api as api_role
    from stract_tpu_torch.entrypoint import search_server
    from stract_tpu_torch.entrypoint.entity_search_server import (RemoteEntityImageStore,
                                                                  RemoteSidebarManager)
    from stract_tpu_torch.image_store import ImageStore
    from stract_tpu_torch.index.inverted import InvertedIndex
    from stract_tpu_torch.ranking.models.linear import LinearRegression
    from stract_tpu_torch.spell.trainer import train_from_index
    from stract_tpu_torch.webgraph.store import Webgraph, write_graph

    data = tmp_path / "data"
    train_from_index(InvertedIndex(index_dir, "cpu"), str(data / "web_spell"))
    Autosuggest.from_queries(["w1 w2", "w1 w3"]).save(str(data / "autosuggest.bin"))
    write_graph(str(data / "webgraph_host"), ["a.com", "b.com", "c.com"], np.array([0, 0, 1]),
                np.array([1, 2, 2]), host_graph=True)
    write_graph(str(data / "pages"), ["https://a.com/", "https://b.com/x"], np.array([0]),
                np.array([1]))
    ei = EntityIndex(str(data / "entity_index"))
    ei.commit()
    ImageStore(str(data / "images")).insert("w1.webp", b"RIFF")
    fields = {"entity_index_path": str(data / "entity_index"),
              "page_graph_path": str(data / "pages"),
              "entity_image_store_path": str(data / "images"),
              "improvement_log_path": str(tmp_path / "improvements.jsonl")}
    for name, path in fields.items():
        cfg = ApiConfig(**{name: path}, max_concurrency=2)
        api, cluster, pages = api_role.build_coordinator(cfg, device="cpu")
        try:
            local = name == "entity_index_path"
            page_graph, image_store = pages
            assert isinstance(api.sidebar, SidebarManager if local else RemoteSidebarManager)
            assert isinstance(page_graph, Webgraph) == (name == "page_graph_path")
            assert isinstance(image_store, ImageStore) == (name == "entity_image_store_path")
            assert isinstance(image_store, RemoteEntityImageStore) == (
                name in ("page_graph_path", "improvement_log_path"))
            assert not hasattr(api, "page_graph") and not hasattr(api, "image_store")
            assert api_role.coordinator_app(cfg, api, pages) is not None
            api.searcher.client.close()
        finally:
            cluster.shutdown()
    assert not os.path.exists(fields["improvement_log_path"])
    monkeypatch.chdir(tmp_path)
    cfg = load_config("api", os.path.join(REPO, "configs/api.toml"))
    cfg = dataclasses.replace(cfg, gossip={"addr": "127.0.0.1:0"})
    api, cluster, pages = api_role.build_coordinator(cfg, device="cpu")
    try:
        assert isinstance(api.sidebar, SidebarManager) and pages[1] is None
        assert api.spell_checker is not None and api.pipeline.recall.inbound is not None
        assert api_role.coordinator_app(cfg, api, pages) is not None
    finally:
        cluster.shutdown()
    monkeypatch.undo()

    cfg = ApiConfig(spell_path=str(data / "web_spell"), autosuggest_path=str(
        data / "autosuggest.bin"), host_graph_path=str(data / "webgraph_host"), max_concurrency=2)
    api, cluster, _pages = api_role.build_coordinator(cfg, device="cpu")
    try:
        assert api.spell_checker is not None and api.widget("2+3")["result"] == "5"
        assert [h for h, _ in api.pipeline.recall.inbound.similar_hosts(["c.com"], 5)] == \
            ["b.com"]
        assert api_role.coordinator_app(cfg, api) is not None
    finally:
        cluster.shutdown()

    model = tmp_path / "linear.json"
    model.write_text(LinearRegression({"host_centrality": 2.0}, 0.5).to_json())
    server, cluster = search_server.run(index_dir, 0, linear_model_path=str(model),
                                        device="cpu", mesh=None)
    try:
        client = RemoteClient(server.addr, timeout=RPC_TIMEOUT)
        res = client.send("search", {"query": "w1 w2"})
        client.close()
        assert res["candidates"] and all(c["signals"] is not None for c in res["candidates"])
    finally:
        server.stop()
        cluster.shutdown()
    for fn in (api_role.run, api_role.build_coordinator, search_server.run):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            api_role.build_coordinator(ApiConfig(), device="cuda")


def _free_port(kind=socket.SOCK_STREAM) -> int:
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url: str, body: dict, timeout: float = 180.0) -> dict:  # six workers share the cores
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"content-type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        assert resp.status == 200
        return json.loads(resp.read())


def test_main_roles_as_two_processes(index_dir, reference_pages, tmp_path):
    """`python -m stract_tpu_torch.main search-server CONFIG --device cpu` and
    `... api CONFIG --device cpu`, configs written here: the coordinator finds
    the shard by gossip, and one POST to /beta/api/search gives the JAX
    package's page for the same index."""
    from stract_tpu_torch.distributed.cluster import Cluster, Service

    g_api, g_shard = _free_port(socket.SOCK_DGRAM), _free_port(socket.SOCK_DGRAM)
    http, rpc = _free_port(), _free_port()
    (tmp_path / "shard.toml").write_text(
        f'index_path = "{index_dir}"\nshard = 0\nhost = "127.0.0.1"\nport = {rpc}\n'
        f'[gossip]\naddr = "127.0.0.1:{g_shard}"\nseeds = ["127.0.0.1:{g_api}"]\n')
    (tmp_path / "api.toml").write_text(
        f'host = "127.0.0.1"\nport = {http}\nmax_concurrency = 4\n'
        f'[gossip]\naddr = "127.0.0.1:{g_api}"\nseeds = []\n')
    env = {**os.environ, "PYTHONPATH": REPO}
    procs = []
    watcher = None
    try:
        for role, cfg in (("search-server", "shard.toml"), ("api", "api.toml")):
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "stract_tpu_torch.main", role, str(tmp_path / cfg),
                 "--device", "cpu"], cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        # a third gossip member seeded with the coordinator only: once it sees
        # the shard, the coordinator has seen it
        watcher = Cluster.join(Service("watcher"), seeds=[("127.0.0.1", g_api)], interval=0.1)
        assert watcher.await_member(lambda m: m.service.kind == "search-server", timeout=180), \
            "the shard server did not join"
        deadline = time.monotonic() + 180
        while True:
            try:
                urllib.request.urlopen(f"http://127.0.0.1:{http}/metrics", timeout=5).read()
                break
            except OSError:
                assert time.monotonic() < deadline, "the api did not start"
                assert all(p.poll() is None for p in procs), "a role exited"
                time.sleep(0.2)
        page = _post(f"http://127.0.0.1:{http}/beta/api/search", REQUESTS[0])
        _assert_pages_match(reference_pages[0], page)
        assert page["webpages"] and page["webpages"][0]["rankingSignals"]
    finally:
        if watcher is not None:
            watcher.shutdown()
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                out, _ = p.communicate(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate(timeout=15)
            if p.returncode not in (0, -15):
                print(out)
