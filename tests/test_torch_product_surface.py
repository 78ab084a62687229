"""The port's side answers and their routes against the JAX package's on the
CPU, on tests/test_product_surface.py's inputs:

- spell correction (term frequencies, the stupid-backoff model, the trained
  error model, `train_from_index` and `main.py web-spell`), autosuggest and
  the widgets give the same answers, and the files either package saves load
  in the other;
- the inbound similarity over a host graph the JAX package wrote;
- the StackOverflow sidebar (tests/test_prettifier.py's case) through
  ApiSearcher.sidebar_for;
- the routes, through aiohttp's TestClient on an app of each package over
  the same index and the same inputs: widget (and its alias), sidebar (the
  StackOverflow fall-through: these apps have no entity index), spellcheck,
  autosuggest (GET and POST), hosts/export, explore/export and
  webgraph/host/similar answer the same JSON or text.
"""

from __future__ import annotations

import asyncio
import json
import os

import pytest
from aiohttp.test_utils import TestClient, TestServer

from stract_tpu import autosuggest as auto_jax
from stract_tpu import spell as spell_jax
from stract_tpu import widgets as widgets_jax
from stract_tpu.spell import error_model as em_jax
from stract_tpu.spell import trainer as trainer_jax
from stract_tpu_torch import autosuggest as auto_port
from stract_tpu_torch import spell as spell_port
from stract_tpu_torch import widgets as widgets_port
from stract_tpu_torch.spell import error_model as em_port
from stract_tpu_torch.spell import trainer as trainer_port

from conftest import make_doc
from test_prettifier import so_schema

CORPUS = ("the quick brown fox jumps over the lazy dog . "
          "rust programming language is fast . python programming language is easy . "
          "the programming language ecosystem keeps growing . ") * 5
SPELL_QUERIES = ["rust programing language", "rust programming", "pythn programming",
                 "teh quick brwn fox", "lazzy dog", "zzzz", "", "programming langauge"]
WIDGET_QUERIES = ["2+2", "3 * (4 + 5)", "2^10", "sqrt(144)", "10 % 3", "2*pi", "rust tutorial",
                  "1/0", "5*5", "define fast", "happy definition", "search meaning",
                  "define qzxqzx", "regular query", "50%", "-(2 ** 3) + ln(e)"]
QUERIES = ["rust tutorial", "rust tutorial", "rust lang", "python", " Rust Book ", ""]


def _checker(spell):
    freqs, lm = spell.TermFreqs(), spell.StupidBackoff()
    freqs.observe_text(CORPUS)
    lm.observe_text(CORPUS)
    return spell.SpellChecker(freqs, lm)


def _corrections(checker) -> list:
    return [(c.to_json() if c else None) for c in map(checker.correct, SPELL_QUERIES)]


def test_spell_checker_matches_jax():
    got = _corrections(_checker(spell_port))
    assert got == _corrections(_checker(spell_jax))
    assert got[0]["corrected"] == "rust programming language"


@pytest.mark.parametrize("writer,reader", [(spell_jax, spell_port), (spell_port, spell_jax)])
def test_spell_files_load_in_the_other_package(tmp_path, writer, reader):
    c = _checker(writer)
    c.freqs.save(str(tmp_path / "f.bin"))
    c.lm.save(str(tmp_path / "lm.bin"))
    loaded = reader.SpellChecker(reader.TermFreqs.load(str(tmp_path / "f.bin")),
                                 reader.StupidBackoff.load(str(tmp_path / "lm.bin")))
    assert _corrections(loaded) == _corrections(c)
    assert loaded.correct("pythn programming").corrected == "python programming"


@pytest.fixture(scope="module")
def spell_index(tmp_path_factory):
    """Stored docs with frequent words and rare misspellings of them (the
    error model's harvest)."""
    from stract_tpu.index import InvertedIndex

    idx = InvertedIndex(str(tmp_path_factory.mktemp("torch-spell")))
    body = "the programming language keeps growing and the language is fast"
    for i in range(30):
        idx.insert(make_doc(f"https://s{i}.com/", f"programming language {i}", body))
    for i, typo in enumerate(["programing", "langauge", "languge", "growng"]):
        idx.insert(make_doc(f"https://t{i}.com/", "notes", f"the {typo} keeps growing"))
    idx.commit()
    return idx.path


def test_train_from_index_matches_jax(spell_index, tmp_path):
    """Each package trains from the same index directory; the files hold the
    same models, each loads in the other, and the checkers correct alike."""
    from stract_tpu.index import InvertedIndex as JaxIndex
    from stract_tpu_torch.index.inverted import InvertedIndex

    trainer_jax.train_from_index(JaxIndex(spell_index), str(tmp_path / "j"))
    trainer_port.train_from_index(InvertedIndex(spell_index, "cpu"), str(tmp_path / "p"))
    for name in ("term_freqs.bin", "lm.bin"):
        assert (tmp_path / "j" / name).read_bytes() == (tmp_path / "p" / name).read_bytes()
    ej = em_jax.ErrorModel.load(str(tmp_path / "j" / "error_model.json"))
    ep = em_port.ErrorModel.load(str(tmp_path / "p" / "error_model.json"))
    assert (ep.errors, ep.total) == (ej.errors, ej.total) and ep.total > 0
    queries = ["programing langauge", "the languge", "growng fast", "programming"]
    for reader, d in ((trainer_port, "j"), (trainer_jax, "p"), (trainer_port, "p")):
        checker = reader.load_checker(str(tmp_path / d))
        assert checker.error_model is not None
        assert [(c.to_json() if c else None) for c in map(checker.correct, queries)] == \
            [(c.to_json() if c else None)
             for c in map(trainer_jax.load_checker(str(tmp_path / "j")).correct, queries)]


def test_main_web_spell_writes_the_jax_packages_files(spell_index, tmp_path):
    from stract_tpu_torch.main import main

    cfg = tmp_path / "web_spell.toml"
    cfg.write_text(f'index_path = "{spell_index}"\noutput_path = "{tmp_path / "out"}"\n')
    main(["web-spell", str(cfg)])
    from stract_tpu.index import InvertedIndex as JaxIndex

    trainer_jax.train_from_index(JaxIndex(spell_index), str(tmp_path / "ref"))
    for name in ("term_freqs.bin", "lm.bin", "error_model.json"):
        assert (tmp_path / "out" / name).read_bytes() == (tmp_path / "ref" / name).read_bytes()


@pytest.mark.parametrize("a,b", [("teh", "the"), ("programing", "programming"),
                                 ("abc", "acb"), ("", "x"), ("same", "same"), ("kitten",
                                                                               "sitting")])
def test_error_sequences_match_jax(a, b):
    assert em_port.possible_errors(a, b) == em_jax.possible_errors(a, b)


@pytest.mark.parametrize("writer,reader", [(auto_jax, auto_port), (auto_port, auto_jax)])
def test_autosuggest_matches_jax(tmp_path, writer, reader):
    a = writer.Autosuggest.from_queries(QUERIES)
    b = reader.Autosuggest.from_queries(QUERIES)
    for prefix in ("rust", "py", "zz", "", "RUST T", "r"):
        assert a.suggest(prefix) == b.suggest(prefix)
    a.save(str(tmp_path / "a.bin"))
    loaded = reader.Autosuggest.load(str(tmp_path / "a.bin"))
    assert loaded.suggest("rust") == a.suggest("rust") == ["rust tutorial", "rust book",
                                                           "rust lang"]


def test_widgets_match_jax(tmp_path):
    tsv = tmp_path / "thesaurus.tsv"
    tsv.write_text("Swift\tadj\tmoving very fast\trapid,quick\nbad line\n")
    for q in WIDGET_QUERIES:
        assert widgets_port.WidgetManager().widget(q) == widgets_jax.WidgetManager().widget(q), q
        assert widgets_port.Calculator().try_calculate(q) == \
            widgets_jax.Calculator().try_calculate(q), q
    tp, tj = (mod.Thesaurus.from_tsv(str(tsv)) for mod in (widgets_port, widgets_jax))
    for q in ("define swift", "swift meaning", "define fast"):
        assert tp.try_define(q) == tj.try_define(q)
    assert widgets_port.WidgetManager().widget("5*5")["type"] == "calculator"


# ---- the host graph --------------------------------------------------------------------
@pytest.fixture(scope="module")
def host_graph(tmp_path_factory):
    """A host graph written by the JAX package: two hubs and co-cited hosts."""
    from stract_tpu.webgraph.edge import Edge, RelFlags
    from stract_tpu.webgraph.store import WebgraphBuilder

    b = WebgraphBuilder(host_graph=True)
    for i in range(12):
        b.insert(Edge(f"linker{i}.com", "rust-lang.org", RelFlags.NONE))
        if i % 2:
            b.insert(Edge(f"linker{i}.com", "crates.io", RelFlags.NONE))
        if i % 3 == 0:
            b.insert(Edge(f"linker{i}.com", "python.org", RelFlags.NOFOLLOW))
    b.insert(Edge("rust-lang.org", "python.org", RelFlags.NONE))
    return b.build(str(tmp_path_factory.mktemp("torch-hostgraph"))).path


def _similarity(pkg: str, path: str):
    import importlib

    store = importlib.import_module(f"{pkg}.webgraph.store")
    sim = importlib.import_module(f"{pkg}.ranking.inbound_similarity")
    return sim.InboundSimilarity(store.Webgraph(path))


def test_inbound_similarity_matches_jax(host_graph):
    from stract_tpu_torch.optics import HostRankings

    sj, sp = _similarity("stract_tpu", host_graph), _similarity("stract_tpu_torch", host_graph)
    for hosts in (["rust-lang.org"], ["crates.io", "python.org"], ["nowhere.net"], []):
        assert sp.similar_hosts(hosts, 5) == sj.similar_hosts(hosts, 5)
    from stract_tpu_torch.ranking.inbound_similarity import host_node_id

    node_ids = [host_node_id(h) for h in ("crates.io", "python.org", "rust-lang.org", "x.io")]
    hr = HostRankings(liked=["rust-lang.org"], disliked=["python.org"])
    assert sp.score(hr, node_ids).tolist() == sj.score(hr, node_ids).tolist()
    assert sp.score(None, node_ids).tolist() == [0.0] * 4
    assert any(sp.score(hr, node_ids))


# ---- the StackOverflow sidebar and the routes ------------------------------------------
@pytest.fixture(scope="module")
def surface_dir(tmp_path_factory):
    """tests/test_prettifier.py's StackOverflow case: a QAPage doc and a blog
    post that also matches the query, plus tests/test_api_e2e.py's docs."""
    from stract_tpu.index import InvertedIndex

    idx = InvertedIndex(str(tmp_path_factory.mktemp("torch-surface")))
    so = make_doc(url="https://stackoverflow.com/questions/1/frobnicate",
                  title="How do I frobnicate", body="How do I frobnicate a thing in python",
                  host_centrality=0.9)
    schema = so_schema()
    schema[0]["mainEntity"]["name"] = "How do I frobnicate"
    so["schema_org_json"] = json.dumps(schema)
    idx.insert(so)
    idx.insert(make_doc(url="https://blog.example.com/frobnicate", title="frobnicate thoughts",
                        body="frobnicate musings python", host_centrality=0.95))
    idx.insert(make_doc("https://rust-lang.org/", "The Rust Programming Language",
                        "rust is a systems programming language fast and safe",
                        host_centrality=0.9))
    idx.insert(make_doc("https://python.org/", "Python", "python is a programming language",
                        host_centrality=0.8))
    idx.commit()
    return idx.path


def _api(pkg: str, path: str):
    """ApiSearcher of package `pkg` over `path`, with the spell checker and the
    widgets; no entity sidebar."""
    import importlib

    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    if pkg == "stract_tpu":
        index = mod("index").InvertedIndex(path)
    else:
        index = mod("index.inverted").InvertedIndex(path, "cpu")
    return mod("searcher.api").ApiSearcher(
        mod("searcher.distributed").LocalShardedSearcher([mod("searcher.local").LocalSearcher(
            index, shard_id=0)]),
        spell_checker=_checker(mod("spell")), widget_manager=mod("widgets").WidgetManager())


@pytest.mark.parametrize("query", ["frobnicate python", "musings", "python thing", "rust"])
def test_stackoverflow_sidebar_matches_jax(surface_dir, query):
    got = _api("stract_tpu_torch", surface_dir).sidebar_for(query)
    assert got == _api("stract_tpu", surface_dir).sidebar_for(query)
    if query == "frobnicate python":
        assert got["type"] == "stackOverflow" and got["title"] == "How do I frobnicate"
        assert got["answer"]["accepted"] and got["answer"]["upvotes"] == 42
    else:
        assert got is None


ROUTES = [
    ("post", "/beta/api/search/widget", {"query": "2+2*3"}),
    ("post", "/beta/api/widget", {"query": "define happy"}),
    ("post", "/beta/api/search/widget", {"query": "rust"}),
    ("post", "/beta/api/search/sidebar", {"query": "frobnicate python"}),
    ("post", "/beta/api/search/sidebar", {"query": "musings"}),
    ("post", "/beta/api/search/spellcheck", {"query": "rust programing language"}),
    ("post", "/beta/api/search/spellcheck", {"query": "rust programming"}),
    ("get", "/beta/api/autosuggest?q=rust", None),
    ("post", "/beta/api/autosuggest", {"q": "py"}),
    ("post", "/beta/api/hosts/export",
     {"hostRankings": {"liked": ["a.com"], "disliked": ["c.org"], "blocked": ["www.b.com"]}}),
    ("post", "/beta/api/explore/export",
     {"chosenHosts": ["rust-lang.org"], "similarHosts": ["crates.io", "docs.rs"]}),
    ("post", "/beta/api/webgraph/host/similar", {"hosts": ["rust-lang.org"], "topN": 3}),
    ("post", "/beta/api/webgraph/host/similar", {"hosts": ["crates.io"]}),
]


def _answers(app) -> list:
    async def run():
        out = []
        async with TestClient(TestServer(app)) as client:
            for method, path, body in ROUTES:
                resp = await getattr(client, method)(path, json=body)
                assert resp.status == 200, (path, resp.status)
                text = await resp.text()
                out.append(json.loads(text) if resp.content_type == "application/json"
                           else text)
        return out
    return asyncio.run(run())


def test_routes_answer_as_the_jax_packages(surface_dir, host_graph):
    from stract_tpu.api.server import build_app as jax_app
    from stract_tpu_torch.api.server import build_app
    from stract_tpu_torch.optics import Optic

    apps = []
    for pkg, build in (("stract_tpu", jax_app), ("stract_tpu_torch", build_app)):
        suggest = (auto_jax if pkg == "stract_tpu" else auto_port).Autosuggest.from_queries(
            QUERIES)
        apps.append(build(_api(pkg, surface_dir), autosuggest=suggest,
                          similar_hosts=_similarity(pkg, host_graph), max_concurrency=4))
    want, got = (_answers(app) for app in apps)
    assert got == want
    by_path = dict(zip([f"{p} {json.dumps(b)}" for _, p, b in ROUTES], got))
    assert by_path['/beta/api/search/widget {"query": "2+2*3"}'] == {
        "widget": {"type": "calculator", "input": "2+2*3", "result": "8"}}
    assert by_path['/beta/api/search/sidebar {"query": "frobnicate python"}']["sidebar"][
        "type"] == "stackOverflow"
    assert by_path['/beta/api/search/spellcheck {"query": "rust programing language"}'][
        "correction"]["corrected"] == "rust programming language"
    assert {"raw": "rust lang"} in by_path["/beta/api/autosuggest?q=rust null"]
    assert [h["host"] for h in got[-2]] == ["crates.io", "python.org"]
    o = Optic.parse(got[9])
    assert o.host_rankings.liked == ["a.com"] and len(o.rules) == 1
    o = Optic.parse(got[10])
    assert o.discard_non_matching and o.host_rankings.liked == ["rust-lang.org"]


def test_routes_without_their_services(surface_dir):
    """No autosuggest and no host graph: empty lists, as the JAX package
    answers; a body that is not JSON answers 400, and so does a similar-hosts
    request whose hosts are not a list of at most 32 strings or whose topN is
    not a positive integer."""
    from stract_tpu_torch.api.server import build_app

    app = build_app(_api("stract_tpu_torch", surface_dir), max_concurrency=2)

    async def run():
        async with TestClient(TestServer(app)) as client:
            assert await (await client.get("/beta/api/autosuggest?q=r")).json() == []
            assert await (await client.post("/beta/api/webgraph/host/similar",
                                             json={"hosts": ["a"]})).json() == []
            for path in ("/beta/api/search/widget", "/beta/api/search/spellcheck"):
                assert (await client.post(path, data=b"{")).status == 400
            for body in ({"hosts": "a.com"}, {"hosts": [1]}, {"hosts": ["a"] * 33},
                         {"hosts": ["a"], "topN": "3"}, {"hosts": ["a"], "topN": 0},
                         {"hosts": ["a"], "topN": True}):
                resp = await client.post("/beta/api/webgraph/host/similar", json=body)
                assert resp.status == 400, body
    asyncio.run(run())
    assert os.path.isdir(surface_dir)
