"""The port's dev bootstrap (stract_tpu_torch/entrypoint/configure.py on the
CPU) against the JAX package's: the same WARC, host graph, centrality store,
index, spell models, autosuggest file and entity index, file by file (clocks
and uuids pinned in both, as tests/test_torch_indexer.py pins them), and the
deployment answers as tests/test_configure_flow.py has the JAX package's
answer. `main.py configure` and `main.py indexer search | merge | canonical`
run through the command line.
"""

from __future__ import annotations

import os

import pytest

from test_torch_indexer import pinned, tree_diff


@pytest.fixture(scope="module")
def deployments(tmp_path_factory):
    from stract_tpu.entrypoint.configure import run as jax_configure
    from stract_tpu_torch.entrypoint.configure import run as configure

    root = tmp_path_factory.mktemp("torch-configure")
    with pinned():
        a = jax_configure(str(root / "jax"))
    with pinned():
        b = configure(str(root / "port"), device="cpu")
    return a, b


# the centrality values (and the index columns made of them) carry the
# harmonic centrality's tolerance of tests/test_torch_centrality.py: the HLL
# size estimates sum a row's powers of two in other orders, so a value may
# move by an f32 step or two (rtol 1e-5); the ranks, and so the doc order,
# stay equal
CENTRALITY_RTOL = 1e-5
CENTRALITY_COLUMNS = ("columns/host_centrality.bin", "columns/pre_computed_score.bin")


def test_configure_writes_the_jax_packages_files(deployments):
    import numpy as np

    from stract_tpu.kv import Db as JaxDb
    from stract_tpu_torch.index.segment import Segment
    from stract_tpu_torch.kv import Db

    a, b = deployments
    assert sorted(a) == sorted(b)
    for key in a:
        if key == "centrality":
            continue
        if os.path.isdir(a[key]):
            skip = CENTRALITY_COLUMNS if key == "index" else ()
            assert tree_diff(a[key], b[key], skip=skip) == [], key
        else:
            with open(a[key], "rb") as x, open(b[key], "rb") as y:
                assert x.read() == y.read(), key
    ca, cb = JaxDb.open(a["centrality"]), Db.open(b["centrality"])
    hosts = ["rust-lang.org", "crates.io", "docs.rs", "python.org", "docs.python.org",
             "news.example.com"]
    for h in hosts:
        va, vb = ca.get(h.encode()), cb.get(h.encode())
        assert va["rank"] == vb["rank"], h
        np.testing.assert_allclose(vb["centrality"], va["centrality"], rtol=CENTRALITY_RTOL)
    sa, sb = (Segment(os.path.join(d["index"], "segments",
                                   os.listdir(os.path.join(d["index"], "segments"))[0]))
              for d in (a, b))
    for col in ("host_centrality", "pre_computed_score"):
        np.testing.assert_allclose(np.asarray(sb.column(col)), np.asarray(sa.column(col)),
                                   rtol=CENTRALITY_RTOL)


def test_configure_deployment_answers_as_the_jax_package(deployments):
    from stract_tpu_torch.autosuggest import Autosuggest
    from stract_tpu_torch.entity_index import EntityIndex
    from stract_tpu_torch.entity_index.index import SidebarManager
    from stract_tpu_torch.index.inverted import InvertedIndex
    from stract_tpu_torch.kv import Db
    from stract_tpu_torch.searcher.api import ApiSearcher
    from stract_tpu_torch.searcher.distributed import LocalShardedSearcher
    from stract_tpu_torch.searcher.local import LocalSearcher
    from stract_tpu_torch.searcher.query import SearchQuery
    from stract_tpu_torch.spell.trainer import load_checker
    from stract_tpu_torch.widgets import WidgetManager
    from test_torch_slice import _assert_pages_match, jax_searcher

    _, paths = deployments
    rust = Db.open(paths["centrality"]).get(b"rust-lang.org")
    assert rust and rust["centrality"] > 0
    idx = InvertedIndex(paths["index"], "cpu")
    assert idx.num_docs == 7
    api = ApiSearcher(LocalShardedSearcher([LocalSearcher(idx, 0)]),
                      spell_checker=load_checker(paths["spell"]),
                      widget_manager=WidgetManager(),
                      sidebar_manager=SidebarManager(EntityIndex(paths["entity_index"])))
    assert "https://rust-lang.org/" in [w["url"] for w in
                                        api.search(SearchQuery(query="rust programming")).webpages]
    assert api.search(SearchQuery(query="rust")).webpages[0]["url"] == "https://rust-lang.org/"
    assert api.sidebar_for("rust programming")["type"] == "entity"
    corr = api.spell_correction("pyhon documentation")
    assert corr is None or "python" in corr.corrected
    assert any("rust" in s for s in Autosuggest.load(paths["autosuggest"]).suggest("rust"))

    from stract_tpu.searcher.query import SearchQuery as JaxSQ

    sj = jax_searcher(paths["index"])
    for q in ("rust", "rust programming", "python documentation", "pasta"):
        r = {"query": q, "return_ranking_signals": True}
        _assert_pages_match(sj.search(JaxSQ.from_json(r)).to_json(),
                            api.search(SearchQuery.from_json(r)).to_json())


def test_main_indexer_and_configure_commands(deployments, tmp_path):
    """`main.py indexer search | merge | canonical CONFIG` over the
    deployment's WARC and `main.py configure --device cpu` (no longer
    NotImplementedError), and `admin index-stats` / `site-stats` over what
    they wrote."""
    from stract_tpu_torch.canon_index import CanonicalIndex
    from stract_tpu_torch.index.inverted import InvertedIndex
    from stract_tpu_torch.kv import Db
    from stract_tpu_torch.main import main

    _, paths = deployments
    for action in ("search", "merge", "canonical"):
        cfg = tmp_path / f"{action}.toml"
        cfg.write_text(f'warc_paths = ["{paths["warc"]}"]\noutput_path = "{tmp_path / action}"\n'
                       f'host_centrality_path = "{paths["centrality"]}"\nmerge = false\n')
        main(["indexer", action, str(cfg)])
    assert InvertedIndex(str(tmp_path / "search"), "cpu").num_docs == 7
    assert len(InvertedIndex(str(tmp_path / "merge"), "cpu").segments) == 1
    assert CanonicalIndex(str(tmp_path / "canonical")).is_canonical("https://rust-lang.org/")

    stats_cfg = tmp_path / "stats.toml"
    stats_cfg.write_text(f'index_path = "{paths["index"]}"\noutput_path = "{tmp_path / "stats"}"\n'
                         f'host_centrality_path = "{paths["centrality"]}"\n')
    main(["site-stats", str(stats_cfg)])
    site = Db.open(str(tmp_path / "stats")).get(b"rust-lang.org")
    assert site["pages"] == 1 and site["centrality"] > 0
    main(["admin", "index-stats", paths["index"]])
    main(["configure", "--data-dir", str(tmp_path / "dev"), "--device", "cpu"])
    assert InvertedIndex(str(tmp_path / "dev" / "index"), "cpu").num_docs == 7
