"""Dev bootstrap — the port of stract_tpu/entrypoint/configure.py (role of
reference entrypoint/configure.rs:42-50, which downloads sample.warc.gz /
bangs.json / wordnet / lambdamart.txt / test.zim; a small synthetic corpus is
generated instead: WARC → webgraph → harmonic centrality → index → spell →
autosuggest → entity index). The centrality runs on `device` (K6a / K6b on
a card); the rest is host work, and every file is the JAX package's."""

from __future__ import annotations

import os

_PAGES = [
    ("https://rust-lang.org/", "The Rust Programming Language",
     "Rust is a systems programming language that runs blazingly fast, prevents segfaults and "
     "guarantees thread safety. The borrow checker enforces memory safety for all programs.",
     ["https://crates.io/", "https://docs.rs/"]),
    ("https://crates.io/", "crates.io: the Rust package registry",
     "The Rust community crate registry where you can discover and download packages for your "
     "rust projects and publish your own crates for the community.",
     ["https://rust-lang.org/", "https://docs.rs/"]),
    ("https://docs.rs/", "Docs.rs documentation host",
     "Documentation hosting for every crate published to the registry, built automatically "
     "for the rust community with all features enabled.",
     ["https://rust-lang.org/"]),
    ("https://python.org/", "Welcome to Python.org",
     "Python is a programming language that lets you work quickly and integrate systems more "
     "effectively with batteries included and a huge ecosystem of libraries.",
     ["https://docs.python.org/"]),
    ("https://docs.python.org/", "Python documentation",
     "The official documentation for the python programming language with tutorials library "
     "reference and language reference for all versions.",
     ["https://python.org/"]),
    ("https://news.example.com/ai", "AI news roundup",
     "The latest news about artificial intelligence machine learning and neural networks from "
     "research labs around the world including new model releases.",
     ["https://rust-lang.org/", "https://python.org/"]),
    ("https://cooking.example.org/pasta", "Perfect pasta carbonara",
     "How to cook the perfect pasta carbonara with eggs cheese and guanciale in fifteen minutes "
     "the traditional roman way without cream ever.",
     []),
]


def run(data_dir: str = "data", device="cuda") -> dict:
    os.makedirs(data_dir, exist_ok=True)
    paths = {}

    # 1. sample WARC
    from ..warc import WarcWriter

    warc_path = os.path.join(data_dir, "sample.warc.gz")
    with WarcWriter.open(warc_path) as w:
        for url, title, body, links in _PAGES:
            anchors = "".join(f'<a href="{l}">{l.split("//")[1].rstrip("/")}</a> ' for l in links)
            html = (f"<html lang=\"en\"><head><title>{title}</title></head>"
                    f"<body><h1>{title}</h1><p>{body}</p><p>{anchors}</p></body></html>")
            w.write_record(url, html)
    paths["warc"] = warc_path

    # 2. host webgraph + harmonic centrality
    from .webgraph_build import build_from_warcs

    graph_path = os.path.join(data_dir, "webgraph_host")
    build_from_warcs([warc_path], graph_path, level="host")
    paths["webgraph"] = graph_path

    from .centrality import run_harmonic

    centrality_path = os.path.join(data_dir, "centrality_host")
    run_harmonic(graph_path, centrality_path, device=device)
    paths["centrality"] = centrality_path

    # 3. search index (with centralities attached)
    from .indexer import IndexingWorker, run as indexer_run
    from ..kv import Db

    index_path = os.path.join(data_dir, "index")
    worker = IndexingWorker(host_centrality=Db.open(centrality_path))
    indexer_run([warc_path], index_path, worker, device=device)
    paths["index"] = index_path

    # 4. spell models + autosuggest
    from ..index.inverted import InvertedIndex
    from ..spell.trainer import train_from_index

    spell_path = os.path.join(data_dir, "web_spell")
    train_from_index(InvertedIndex(index_path, device), spell_path)
    paths["spell"] = spell_path

    from ..autosuggest import Autosuggest

    suggest_path = os.path.join(data_dir, "autosuggest.bin")
    Autosuggest.from_queries(
        ["rust programming", "rust tutorial", "python tutorial", "pasta carbonara", "ai news"]
    ).save(suggest_path)
    paths["autosuggest"] = suggest_path

    # 5. entity index
    from ..entity_index import Entity, EntityIndex

    entity_path = os.path.join(data_dir, "entity_index")
    ei = EntityIndex(entity_path)
    ei.insert(Entity("Rust (programming language)",
                     "Rust is a multi-paradigm systems programming language focused on safety.",
                     info={"Designed by": "Graydon Hoare", "First appeared": "2010"}))
    ei.insert(Entity("Python (programming language)",
                     "Python is a high-level general-purpose programming language.",
                     info={"Designed by": "Guido van Rossum", "First appeared": "1991"}))
    ei.commit()
    paths["entity_index"] = entity_path

    print("configure: dev deployment ready")
    for k, v in paths.items():
        print(f"  {k}: {v}")
    return paths
