"""The port's entity sidebar against the JAX package's on the CPU: the ZIM
reader and writer, the article parser, the entity index and its file, the
sidebar, the image store, `main.py indexer entity`, the entity-search
server and its remote clients (wire forms across packages both ways, and
`main.py entity-search-server` as a process), and the small host modules of
the same slice (generic queries, Leechy, the optics LSP, the host
HyperLogLog). Inputs are tests/test_aux_components.py's and
tests/test_process_roles.py's cases, plus seeded ones made with numpy.
BM25 scores are summed in one process's set order, so both packages are
compared in one process.
"""

from __future__ import annotations

import importlib
import json
import lzma
import os
import socket
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

from conftest import make_doc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("stract_tpu", "stract_tpu_torch")
PAIRS = [("stract_tpu", "stract_tpu_torch"), ("stract_tpu_torch", "stract_tpu")]
BLURB = "Rust is a multi paradigm systems programming language focused on safety. "
ARTICLES = [
    # tests/test_aux_components.py test_zim_roundtrip
    ("Rust", "Rust (programming language)",
     "<html><body><p>" + "Rust is a systems programming language. " * 3 +
     "</p><table class='infobox'><tr><th>Designed by</th><td>Graydon Hoare</td></tr>"
     "<tr><td><img src='rust-logo.png'></td></tr></table></body></html>"),
    ("Python", "Python (programming language)",
     "<html><body><p>" + "Python is a high level programming language. " * 3 +
     "</p></body></html>"),
    # tests/test_aux_components.py test_entity_from_zim, test_process_roles.py
    ("Rust_2", "Rust (language)",
     "<html><body><p>" + BLURB * 2 + "</p><table class='infobox'><tr><th>Designed by</th>"
     "<td>Graydon Hoare</td></tr></table></body></html>"),
    # an infobox alone, a short paragraph, an infobox paragraph, no article text
    ("Graydon", "Graydon Hoare",
     "<html><body><p>short</p><table class='infobox vcard'><tr><th>Born</th><td>1970s"
     "</td></tr><tr><td><p>" + "inside the infobox paragraph text. " * 3 + "</p></td></tr>"
     "<tr><th>Known for</th><td>Rust</td></tr></table></body></html>"),
    ("Empty", "Empty page", "<html><body><p>too short</p></body></html>"),
    ("Blank", "", ""),
    ("Unicode", "Café naïve", "<html><body><p>" + "Ünïcödé café naïve text for the "
     "abstract here. " * 2 + "</p></body></html>"),
]
QUERIES = ["rust (programming language)", "Python (programming language)", "rust programming",
           "programming language", "graydon", "hoare", "systems safety", "zzzz unknown",
           "", "   ", "the", "café", "RUST (LANGUAGE)", "language focused"]


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def write_zim(pkg: str, path: str, articles=ARTICLES) -> str:
    w = mod(pkg, "zim").ZimWriter()
    for url, title, html in articles:
        w.add_article(url, title, html)
    w.write(path)
    return path


def read_zim(pkg: str, path: str) -> tuple:
    z = mod(pkg, "zim").ZimFile(path)
    try:
        dirents = [vars(z.dirent(i)) for i in range(z.entry_count)]
        arts = [(a.url, a.title, a.content, a.mimetype, a.text()) for a in z.articles()]
        return dirents, arts, z.mimetypes, (z.major, z.minor, z.main_page, z.layout_page)
    finally:
        z.close()


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_zim_written_by_either_package_reads_in_the_other(tmp_path, writer, reader):
    p = write_zim(writer, str(tmp_path / "t.zim"))
    want = read_zim(writer, p)
    assert read_zim(reader, p) == want
    assert [a[1] for a in want[1][:2]] == ["Rust (programming language)",
                                          "Python (programming language)"]
    other = write_zim(reader, str(tmp_path / "o.zim"))
    with open(p, "rb") as a, open(other, "rb") as b:
        assert a.read() == b.read()


def _cluster(blobs: list, comp: int, extended: bool) -> bytes:
    osize, fmt = (8, "Q") if extended else (4, "I")
    offsets, pos = [], (len(blobs) + 1) * osize
    for b in blobs:
        offsets.append(pos)
        pos += len(b)
    offsets.append(pos)
    body = struct.pack(f"<{len(offsets)}{fmt}", *offsets) + b"".join(blobs)
    if comp == 4:
        body = lzma.compress(body, format=lzma.FORMAT_XZ)
    elif comp == 5:
        import zstandard

        body = zstandard.ZstdCompressor().compress(body)
    return bytes([comp | (0x10 if extended else 0)]) + body


def _zim_with_clusters(path: str) -> None:
    """A v6 ZIM ('C' namespace) of three clusters (none + extended offsets,
    lzma, zstd), a redirect entry and a non-HTML entry."""
    html = [a[2].encode() for a in ARTICLES[:4]]
    clusters = [_cluster(html[:2], 1, True), _cluster(html[2:3] + [b"\x89PNG"], 4, False),
                _cluster(html[3:], 5, True)]
    mimes = b"text/html\x00image/png\x00\x00"
    dirents = []
    for ns, url, title, mime, cl, blob in (("C", "Rust", "Rust (programming language)", 0, 0, 0),
                                           ("C", "Python", "Python", 0, 0, 1),
                                           ("C", "Rust_2", "Rust (language)", 0, 1, 0),
                                           ("C", "logo.png", "", 1, 1, 1),
                                           ("C", "Graydon", "Graydon Hoare", 0, 2, 0)):
        dirents.append(struct.pack("<HBc", mime, 0, ns.encode()) + struct.pack("<I", 0)
                       + struct.pack("<II", cl, blob) + url.encode() + b"\x00"
                       + title.encode() + b"\x00")
    dirents.insert(2, struct.pack("<HBc", 0xFFFF, 0, b"C") + struct.pack("<I", 0)
                   + struct.pack("<I", 0) + b"RustLang\x00Rust lang\x00")
    mime_pos = 80
    url_ptr_pos = mime_pos + len(mimes)
    pos = url_ptr_pos + 8 * len(dirents)
    url_ptrs = []
    for d in dirents:
        url_ptrs.append(pos)
        pos += len(d)
    title_ptr_pos = pos
    cluster_ptr_pos = title_ptr_pos + 4 * len(dirents)
    pos = cluster_ptr_pos + 8 * len(clusters)
    cluster_ptrs = []
    for c in clusters:
        cluster_ptrs.append(pos)
        pos += len(c)
    header = struct.pack("<IHH16sIIQQQQIIQ", 0x44D495A, 6, 1, b"\x00" * 16, len(dirents),
                         len(clusters), url_ptr_pos, title_ptr_pos, cluster_ptr_pos, mime_pos,
                         0, 0xFFFFFFFF, pos)
    with open(path, "wb") as fh:
        fh.write(header + mimes + struct.pack(f"<{len(url_ptrs)}Q", *url_ptrs)
                 + b"".join(dirents) + struct.pack(f"<{len(dirents)}I", *range(len(dirents)))
                 + struct.pack(f"<{len(cluster_ptrs)}Q", *cluster_ptrs) + b"".join(clusters)
                 + b"\x00" * 16)


def test_zim_reader_takes_compressed_clusters_and_redirects_as_jax(tmp_path):
    """lzma and zstd clusters, extended blob offsets, a redirect and a
    non-HTML entry: the same directory entries, articles and texts."""
    p = str(tmp_path / "c.zim")
    _zim_with_clusters(p)
    want = read_zim("stract_tpu", p)
    assert read_zim("stract_tpu_torch", p) == want
    dirents, arts = want[0], want[1]
    assert dirents[2]["redirect_index"] == 0 and dirents[2]["title"] == "Rust lang"
    assert [a[0] for a in arts] == ["Rust", "Python", "Rust_2", "Graydon"]
    assert arts[3][4] == ARTICLES[3][2]


LONG = "long enough paragraph text for the abstract to be kept by the parser"
# malformed and unusual markup the port's html.parser tree must read as lxml does
HOSTILE = [
    f"<P CLASS=x>{LONG}</P><TABLE CLASS=infobox><TR><TH>K<TD>V</TABLE>",
    f"<p>{LONG}&nbsp;&#x27;&lt;b&gt;<br/>end",
    f"<table class=infobox><p>{LONG}</p><tr><td>a</td><td>b</td></tr></table>",
    f"<table class=infobox><tr><td><img src=x.png/></td><td>y</td></tr></table><p>{LONG}",
    f"<div><p>{LONG}<table><tr><td>in</td></tr></table>after</p></div>",
    f"<p>{LONG}<ul><li>a<li>b</ul></p>", f"<p><span>{LONG}</span><p>second {LONG}",
    "<table class='infobox'><tr><th>k</th><td>v</td></tr></table><table class='infobox'>"
    "<tr><th>k2</th><td>v2</td></tr></table>",
    f"<html><head><title>T</title></head><body><p>{LONG}</p></body></html>",
    f"<p>{LONG}</div></span></p><p>x</p>",
    "<table class=infobox><tr><th>a</th><th>b</th><td>c</td></tr><tr><td>x<td>y<td>z</tr>"
    "</table>",
    "<table class=infobox><caption>cap</caption><tr><th colspan=2>head</th></tr><tr><th>k"
    "</th><td>v <a href='#'>link</a></td></tr></table>",
    f"<p>{LONG}<img src='a.png'><p>{LONG}", f"<p>{LONG}<h2>head</h2>tail text here</p>",
    f"<dl><dt>{LONG}<dd>def</dl><p>{LONG}</p>", f"<p>{LONG}<form><input name=a></form></p>",
    f"<p>{LONG}<!-- a comment <p>inside</p> --></p>", "   ",
    f"<table class=infobox><tbody><tr><th>k<td>v<tr><th>k2<td>v2</tbody></table><p>{LONG}",
]


def seeded_article(seed: int) -> str:
    """A seeded document of paragraphs, divs, lists, headings and tables
    (infoboxes among them, nested, with images and paragraphs in cells),
    odd seeds with some </p>, </td>, </th>, </tr> and </li> left out."""
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta", "&amp;", "café", "x" * 30, "Rust", "1970"]
    text = lambda n=None: " ".join(rng.choice(words, n or int(rng.integers(1, 14))))  # noqa
    omit = seed % 2 == 1

    def end(t):
        return "" if omit and t in ("p", "td", "th", "tr", "li") and rng.random() < 0.4 else \
            f"</{t}>"

    def block(depth):
        k = int(rng.integers(0, 9 if depth < 3 else 3))
        if k == 0:
            return f"<p>{text()} <b>{text(2)}</b> {text()}{end('p')}"
        if k == 1:
            return f"<p>{text(12)}<br>{text()}<!-- c {text(2)} -->{end('p')}"
        if k == 2:
            return f"<span>{text()}</span>"
        if k == 3:
            return "<div>" + "".join(block(depth + 1) for _ in range(int(rng.integers(1, 3)))) \
                + "</div>"
        if k in (4, 5):
            rows = ""
            for _ in range(int(rng.integers(1, 4))):
                cells = ""
                for _ in range(int(rng.integers(1, 4))):
                    t = rng.choice(["th", "td"])
                    inner = (text(3) if rng.random() < 0.7 else f"<img src='{text(1)}.png'>"
                             if rng.random() < 0.5 else block(depth + 1))
                    cells += f"<{t}>{inner}{end(t)}"
                rows += f"<tr>{cells}{end('tr')}"
            cls = rng.choice(["infobox", "infobox vcard", "wikitable", ""])
            return f"<table class='{cls}'>" + (f"<tbody>{rows}</tbody>" if rng.random() < 0.3
                                                else rows) + "</table>"
        if k == 6:
            return "<ul>" + "".join(f"<li>{text()}{end('li')}" for _ in range(3)) + "</ul>"
        if k == 7:
            return f"<h2>{text(3)}</h2>"
        return f"<p>{text()}<div>{text(12)}</div>{text(12)}{end('p')}"
    return "<html><body>" + "".join(block(0) for _ in range(int(rng.integers(1, 5)))) + \
        "</body></html>"


def test_parse_wiki_article_matches_jax_on_seeded_documents():
    """The port's html.parser tree against the JAX package's lxml tree on 600
    seeded documents (half with end tags left out) and the hostile cases."""
    jax_parse = mod("stract_tpu", "entrypoint.entity").parse_wiki_article
    port_parse = mod("stract_tpu_torch", "entrypoint.entity").parse_wiki_article
    found = 0
    for html in [seeded_article(seed) for seed in range(600)] + HOSTILE:
        a, b = jax_parse(html, "t"), port_parse(html, "t")
        assert (a and a.to_json()) == (b and b.to_json()), html
        found += a is not None and bool(a.info)
    assert found > 100


@pytest.mark.parametrize("url,title,html", ARTICLES + [
    ("Bad", "Bad", "<<<>>>"), ("Nested", "Nested", "<div><div><p>" + BLURB + "</p></div>"
                               "<table class='other'><tr><th>a</th><td>b</td></tr></table>"
                               "<table class='infobox'><tr><th>" + "k" * 70 + "</th><td>v"
                               "</td></tr><tr><th>Key</th><td>" + "v" * 300 + "</td></tr>"
                               "</table></div>")])
def test_parse_wiki_article_matches_jax(url, title, html):
    a = mod("stract_tpu", "entrypoint.entity").parse_wiki_article(html, title)
    b = mod("stract_tpu_torch", "entrypoint.entity").parse_wiki_article(html, title)
    assert (a is None and b is None) or (a.to_json() == b.to_json())


def seeded_entities(pkg: str, n: int = 300, seed: int = 5) -> list:
    """n entities with titles and abstracts from a small seeded vocabulary
    (repeated titles and tied scores included)."""
    rng = np.random.default_rng(seed)
    vocab = [f"w{i}" for i in range(60)] + ["rust", "python", "language", "programming"]
    E = mod(pkg, "entity_index").Entity
    out = []
    for i in range(n):
        title = " ".join(rng.choice(vocab, int(rng.integers(1, 4))))
        abstract = " ".join(rng.choice(vocab, int(rng.integers(0, 30))))
        info = {"k": str(i)} if i % 3 == 0 else {}
        out.append(E(title, abstract, f"img{i}.webp" if i % 10 == 0 else "", info,
                     ["https://a.example/"] if i % 7 == 0 else []))
    return out


def build_index(pkg: str, path: str, entities=None):
    ei = mod(pkg, "entity_index").EntityIndex(path)
    for e in entities if entities is not None else seeded_entities(pkg):
        ei.insert(e)
    ei.commit()
    return ei


ENTITY_QUERIES = QUERIES + ["w1", "w1 w2", "w3 rust", "python language w7", "w59 w58 w57",
                            "programming", "w12 w12 w12", "language programming rust"]


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_entities_bin_byte_equal_and_searches_alike(tmp_path, writer, reader):
    a = build_index(writer, str(tmp_path / "a"))
    b = build_index(reader, str(tmp_path / "b"))
    with open(tmp_path / "a" / "entities.bin", "rb") as fa, \
            open(tmp_path / "b" / "entities.bin", "rb") as fb:
        assert fa.read() == fb.read()
    loaded = mod(reader, "entity_index").EntityIndex(str(tmp_path / "a"))
    assert len(loaded) == len(a) == 300
    for q in ENTITY_QUERIES + [e.title for e in seeded_entities(writer)[:20]]:
        for k in range(1, 6):
            want = [e.to_json() for e in a.search(q, top_k=k)]
            assert [e.to_json() for e in loaded.search(q, top_k=k)] == want, (q, k)
            assert [e.to_json() for e in b.search(q, top_k=k)] == want, (q, k)


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_sidebar_and_image_store_across_packages(tmp_path, writer, reader):
    build_index(writer, str(tmp_path / "ei"))
    want = mod(writer, "entity_index.index").SidebarManager(
        mod(writer, "entity_index").EntityIndex(str(tmp_path / "ei")))
    got = mod(reader, "entity_index.index").SidebarManager(
        mod(reader, "entity_index").EntityIndex(str(tmp_path / "ei")))
    answers = [got.sidebar(q) for q in ENTITY_QUERIES]
    assert answers == [want.sidebar(q) for q in ENTITY_QUERIES]
    assert any(a is not None for a in answers) and any(a is None for a in answers)
    assert json.loads(json.dumps(answers)) == answers

    rng = np.random.default_rng(9)
    blobs = {f"img{i}.webp": rng.bytes(int(rng.integers(1, 5000))) for i in range(20)}
    blobs["dup.webp"] = blobs["img3.webp"]
    digests = {}
    for pkg, sub in ((writer, "w"), (reader, "r")):
        store = mod(pkg, "image_store").ImageStore(str(tmp_path / sub))
        digests[pkg] = [store.insert(k, v) for k, v in blobs.items()]
    assert digests[reader] == digests[writer]
    reread = mod(reader, "image_store").ImageStore(str(tmp_path / "w"))
    for k, v in blobs.items():
        assert reread.get(k) == v and k in reread
    assert reread.get("nope") is None and "nope" not in reread
    walk = lambda d: sorted(os.path.relpath(os.path.join(r, f), d)  # noqa: E731
                            for r, _, fs in os.walk(os.path.join(d, "blobs")) for f in fs)
    assert walk(str(tmp_path / "w")) == walk(str(tmp_path / "r"))


def _indexer_config(tmp_path, zim: str, out: str, limit: int = 0) -> str:
    p = tmp_path / f"indexer-{os.path.basename(out)}.toml"
    p.write_text(f'zim_path = "{zim}"\noutput_path = "{out}"\nentity_limit = {limit}\n')
    return str(p)


def _entity_zim(tmp_path, n: int = 120) -> str:
    """ARTICLES and n seeded articles with abstracts and infoboxes."""
    rng = np.random.default_rng(3)
    vocab = [f"w{i}" for i in range(40)] + ["rust", "python", "language"]
    arts = list(ARTICLES)
    for i in range(n):
        title = " ".join(rng.choice(vocab, int(rng.integers(1, 4))))
        body = " ".join(rng.choice(vocab, 40))
        box = (f"<table class='infobox'><tr><td><img src='e{i}.webp'></td></tr><tr><th>id</th>"
               f"<td>{i}</td></tr></table>") if i % 4 == 0 else ""
        arts.append((f"E{i}", title, f"<html><body><p>{body}</p>{box}</body></html>"))
    return write_zim("stract_tpu", str(tmp_path / "entities.zim"), arts)


def test_main_indexer_entity_of_each_package_writes_the_same_index(tmp_path):
    """`python -m stract_tpu_torch.main indexer entity CONFIG` as a process and
    the JAX package's `main indexer entity` on the same ZIM: the same
    entities.bin, also under entity_limit; the other actions (search,
    merge, canonical) run too, over a WARC file, and write what they name."""
    from stract_tpu.main import main as jax_main

    zim = _entity_zim(tmp_path)
    for limit in (0, 50):
        outs = [str(tmp_path / f"jax-{limit}"), str(tmp_path / f"port-{limit}")]
        jax_main(["indexer", "entity", _indexer_config(tmp_path, zim, outs[0], limit)])
        proc = subprocess.run([sys.executable, "-m", "stract_tpu_torch.main", "indexer", "entity",
                               _indexer_config(tmp_path, zim, outs[1], limit)], cwd=REPO,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        n = len(mod("stract_tpu", "entity_index").EntityIndex(outs[0]))
        assert proc.stdout.strip() == f"indexed {n} entities → {outs[1]}"
        assert n == (limit or 125)
        with open(os.path.join(outs[0], "entities.bin"), "rb") as a, \
                open(os.path.join(outs[1], "entities.bin"), "rb") as b:
            assert a.read() == b.read()
    from stract_tpu_torch.index.inverted import InvertedIndex
    from stract_tpu_torch.kv import Db
    from stract_tpu_torch.main import main
    from stract_tpu_torch.warc import WarcWriter

    warc = str(tmp_path / "pages.warc.gz")
    with WarcWriter.open(warc) as w:
        w.write_record("https://a.org/x", '<html><head><title>Alpha</title><link rel="canonical" '
                       'href="https://a.org/"></head><body><p>alpha beta</p></body></html>')
    for action in ("search", "merge", "canonical"):
        cfg = tmp_path / f"{action}.toml"
        cfg.write_text(f'warc_paths = ["{warc}"]\noutput_path = "{tmp_path / action}"\n')
        main(["indexer", action, str(cfg)])
    for action in ("search", "merge"):
        assert InvertedIndex(str(tmp_path / action), "cpu").num_docs == 1
    assert Db.open(str(tmp_path / "canonical")).get(b"https://a.org/x") == "https://a.org/"


def _service(pkg: str, tmp_path):
    ess = mod(pkg, "entrypoint.entity_search_server")
    build_index(pkg, str(tmp_path / f"ei-{pkg}"))
    store = mod(pkg, "image_store").ImageStore(str(tmp_path / f"img-{pkg}"))
    store.insert("img0.webp", b"RIFF\x00webp-bytes")
    return ess.EntitySearchService(mod(pkg, "entity_index").EntityIndex(
        str(tmp_path / f"ei-{pkg}")), store)


def test_entity_search_service_answers_as_jax(tmp_path):
    a, b = _service("stract_tpu", tmp_path), _service("stract_tpu_torch", tmp_path)
    for q in ENTITY_QUERIES:
        assert b.search({"query": q}) == a.search({"query": q}), q
    for image_id in ("img0.webp", "nope"):
        assert b.get_entity_image({"image_id": image_id}) == \
            a.get_entity_image({"image_id": image_id})
    assert b.size() == a.size() == {"num_entities": 300}
    bare = mod("stract_tpu_torch", "entrypoint.entity_search_server").EntitySearchService(
        b.index)
    assert bare.get_entity_image({"image_id": "img0.webp"}) is None


@pytest.mark.parametrize("server_pkg,client_pkg", PAIRS + [("stract_tpu_torch",) * 2])
def test_remote_sidebar_across_packages(tmp_path, server_pkg, client_pkg):
    """An entity-search server of one package (run(): sonic and gossip, in
    threads) and the other's RemoteSidebarManager and RemoteEntityImageStore
    over a gossip-discovered ReusableShardedClient, as the coordinator wires
    them: the local SidebarManager's answers; images byte-equal; a stopped
    server that cannot be reached answers None, not an error."""
    ess = mod(server_pkg, "entrypoint.entity_search_server")
    build_index(server_pkg, str(tmp_path / "ei"))
    store = mod(server_pkg, "image_store").ImageStore(str(tmp_path / "img"))
    store.insert("img0.webp", b"RIFF\x00webp-bytes")
    cluster_mod = mod(client_pkg, "distributed.cluster")
    seed = cluster_mod.Cluster.join(cluster_mod.Service("api"), interval=0.1,
                                    failure_timeout=5.0)
    server, cluster = ess.run(str(tmp_path / "ei"), str(tmp_path / "img"),
                              gossip_seeds=[seed.gossip_addr])
    remote = mod(client_pkg, "entrypoint.entity_search_server")
    client = mod(client_pkg, "distributed.replication").ReusableShardedClient(seed,
                                                                             "entity-search")
    try:
        assert seed.await_member(lambda m: m.service.kind == "entity-search", timeout=60)
        sidebar, images = remote.RemoteSidebarManager(client), remote.RemoteEntityImageStore(
            client)
        local = mod(client_pkg, "entity_index.index").SidebarManager(
            mod(client_pkg, "entity_index").EntityIndex(str(tmp_path / "ei")))
        deadline = time.time() + 60
        while sidebar.sidebar("w1") is None and time.time() < deadline:
            time.sleep(0.2)  # the client refreshes its members from gossip
        for q in ENTITY_QUERIES:
            assert sidebar.sidebar(q) == local.sidebar(q), q
        assert images.get("img0.webp") == b"RIFF\x00webp-bytes"
        assert images.get("nope") is None
    finally:
        if client_pkg == "stract_tpu_torch":  # the JAX package's client has no close
            client.close()
        server.stop()
        cluster.shutdown()
        seed.shutdown()
    rep = mod(client_pkg, "distributed.replication")
    dead = rep.ShardedClient({0: rep.ReplicatedClient([("127.0.0.1", _free_port())],
                                                      timeout=10)})
    assert remote.RemoteSidebarManager(dead).sidebar("w1") is None
    assert remote.RemoteEntityImageStore(dead).get("img0.webp") is None


def _free_port(kind=socket.SOCK_STREAM) -> int:
    with socket.socket(socket.AF_INET, kind) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_main_entity_search_server_as_a_process(tmp_path):
    """`python -m stract_tpu_torch.main entity-search-server CONFIG` serves the
    entity index and the image store to a JAX coordinator's remote clients
    found by gossip."""
    from stract_tpu.distributed.cluster import Cluster, Service
    from stract_tpu.distributed.replication import ReusableShardedClient
    from stract_tpu.entity_index.index import EntityIndex, SidebarManager
    from stract_tpu.entrypoint.entity_search_server import (RemoteEntityImageStore,
                                                            RemoteSidebarManager)
    from stract_tpu.image_store import ImageStore

    build_index("stract_tpu", str(tmp_path / "ei"))
    ImageStore(str(tmp_path / "img")).insert("img0.webp", b"RIFF\x00webp")
    seed = Cluster.join(Service("api"), interval=0.1, failure_timeout=5.0)
    cfg = tmp_path / "ess.toml"
    gossip = _free_port(socket.SOCK_DGRAM)
    cfg.write_text(f'index_path = "{tmp_path}/ei"\nimage_store_path = "{tmp_path}/img"\n'
                   f'port = {_free_port()}\n[gossip]\naddr = "127.0.0.1:{gossip}"\n'
                   f'seeds = ["{seed.gossip_addr[0]}:{seed.gossip_addr[1]}"]\n')
    proc = subprocess.Popen([sys.executable, "-m", "stract_tpu_torch.main",
                             "entity-search-server", str(cfg)], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    client = ReusableShardedClient(seed, "entity-search")
    try:
        assert proc.stdout.readline().startswith("entity-search-server rpc=")
        assert seed.await_member(lambda m: m.service.kind == "entity-search", timeout=120)
        sidebar = RemoteSidebarManager(client)
        deadline = time.time() + 120
        while sidebar.sidebar("w1") is None and time.time() < deadline:
            time.sleep(0.2)
        local = SidebarManager(EntityIndex(str(tmp_path / "ei")))
        for q in ENTITY_QUERIES:
            assert sidebar.sidebar(q) == local.sidebar(q), q
        assert RemoteEntityImageStore(client).get("img0.webp") == b"RIFF\x00webp"
    finally:
        proc.kill()
        proc.wait(timeout=60)
        seed.shutdown()


# ---- the slice's other host modules --------------------------------------------------
@pytest.fixture(scope="module")
def generic_index(tmp_path_factory):
    from stract_tpu.index import InvertedIndex

    idx = InvertedIndex(str(tmp_path_factory.mktemp("torch-generic")))
    rng = np.random.default_rng(2)
    for i in range(40):
        site = f"site{i % 4}.com"
        path = "/" if i < 4 else f"/p{i}"
        idx.insert(make_doc(f"https://{site}{path}", f"title {i}", f"body w{i % 7} text",
                            keywords="\n".join(rng.choice(["rust", "python", "go", "zig"],
                                                          int(rng.integers(0, 3))))))
    idx.commit()
    return idx.path


def _generic(pkg: str, path: str) -> list:
    gq = mod(pkg, "generic_query")
    index = (mod(pkg, "index").InvertedIndex(path) if pkg == "stract_tpu"
             else mod(pkg, "index.inverted").InvertedIndex(path, "cpu"))
    searchers = [mod(pkg, "searcher.local").LocalSearcher(index, shard_id=0)]
    queries = [gq.SizeQuery(), gq.GetWebpageQuery("https://site1.com/p5"),
               gq.GetWebpageQuery("https://nowhere.org/"), gq.GetHomepageQuery("site2.com"),
               gq.GetSiteUrlsQuery("site3.com", offset=1, limit=4),
               gq.GetSiteUrlsQuery("site0.com"), gq.TopKeyPhrasesQuery(top_n=3)]
    return [gq.run_generic_query(q, searchers) for q in queries]


def test_generic_queries_match_jax(generic_index):
    got = _generic("stract_tpu_torch", generic_index)
    assert got == _generic("stract_tpu", generic_index)
    assert got[0] == 40 and got[1]["url"] == "https://site1.com/p5" and got[2] is None
    assert len(got[4]) == 4 and got[6]


def test_leechy_matches_jax():
    """tests/test_aux_components.py test_leechy's SERP through the injected
    fetch, a failing engine before it, and the default engines' URLs."""
    serp = ("<html><body><a class=\"result__a\" href=\"https://one.com/x\">One</a>"
            "<a class=\"result__a\" href=\"https://two.com/y\">Two</a>"
            "<a class=\"result__a\" href=\"/relative\">rel</a>"
            "<a class=\"other\" href=\"https://nope.com\">skip</a></body></html>")
    out = []
    for pkg in PKGS:
        lm = mod(pkg, "leechy")
        calls = []

        def fetch(url, calls=calls):
            calls.append(url)
            return (500, "", 0) if "down" in url else (200, serp, 5)
        engines = [lm.Engine("down", "https://down.example/?q={query}", "//a"),
                   lm.Engine("test", "https://t.com/?q={query}",
                             "//a[contains(@class,'result__a')]")]
        le = lm.Leechy(fetch, engines)
        out.append((le.results("rust lang & more"), le.results("q", top_k=1),
                    le.annotate(["q", "r"]), calls,
                    [e.query_url("a b") for e in lm.DEFAULT_ENGINES],
                    lm.Engine("x", "", "//a").extract("<<<")))
    assert out[0] == out[1]
    assert out[1][0] == ["https://one.com/x", "https://two.com/y"]


def _lsp_session(module: str, frames: bytes) -> bytes:
    proc = subprocess.run([sys.executable, "-m", module], input=frames, capture_output=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_optics_lsp_answers_as_jax():
    """tests/test_optics_lsp.py's session and an unknown request, through
    `python -m` of each package's LSP: the same bytes."""
    from test_optics_lsp import BAD_OPTIC, GOOD_OPTIC, lsp_frames

    frames = lsp_frames(
        {"jsonrpc": "2.0", "id": 1, "method": "initialize", "params": {}},
        {"jsonrpc": "2.0", "method": "initialized", "params": {}},
        {"jsonrpc": "2.0", "method": "textDocument/didOpen", "params": {
            "textDocument": {"uri": "file:///a.optic", "text": BAD_OPTIC}}},
        {"jsonrpc": "2.0", "method": "textDocument/didChange", "params": {
            "textDocument": {"uri": "file:///a.optic"},
            "contentChanges": [{"text": GOOD_OPTIC}]}},
        {"jsonrpc": "2.0", "id": 2, "method": "textDocument/hover", "params": {
            "textDocument": {"uri": "file:///a.optic"}, "position": {"line": 4, "character": 12}}},
        {"jsonrpc": "2.0", "id": 5, "method": "textDocument/hover", "params": {
            "textDocument": {"uri": "file:///a.optic"}, "position": {"line": 0, "character": 0}}},
        {"jsonrpc": "2.0", "id": 3, "method": "textDocument/completion", "params": {
            "textDocument": {"uri": "file:///a.optic"}, "position": {"line": 0, "character": 0}}},
        {"jsonrpc": "2.0", "id": 6, "method": "workspace/unknown", "params": {}},
        {"jsonrpc": "2.0", "id": 4, "method": "shutdown", "params": {}},
        {"jsonrpc": "2.0", "method": "exit"},
    )
    got = _lsp_session("stract_tpu_torch.optics_lsp", frames)
    assert got == _lsp_session("stract_tpu.optics_lsp", frames)
    assert b"textDocument/publishDiagnostics" in got and b"Boost" in got


def test_host_hyperloglog_matches_jax():
    """Registers, sizes and bytes of the host sketch, the batched
    estimators (with the Monte-Carlo bias table at a small trial count)."""
    hj, hp = mod("stract_tpu", "utils.hyperloglog"), mod("stract_tpu_torch", "utils.hyperloglog")
    rng = np.random.default_rng(11)
    for precision, n in ((4, 10), (6, 1000), (12, 5000)):
        values = rng.integers(0, 2 ** 63, n, dtype=np.uint64)
        a, b = hj.HyperLogLog(precision), hp.HyperLogLog(precision)
        a.add_many_u64(values)
        b.add_many_u64(values)
        np.testing.assert_array_equal(b.registers, a.registers)
        assert (b.size(), len(b), b.to_bytes()) == (a.size(), len(a), a.to_bytes())
        c = hp.HyperLogLog.from_bytes(a.to_bytes())
        c.merge(hp.HyperLogLog.from_registers(b.registers))
        assert c.size() == a.size()
    regs = rng.integers(0, 12, (50, 64)).astype(np.uint8)
    regs[:10] = 0
    np.testing.assert_array_equal(hp.estimate_cardinalities(regs), hj.estimate_cardinalities(regs))
    np.testing.assert_array_equal(hp.raw_estimates(regs), hj.raw_estimates(regs))
    bias = hj.mc_bias_table(6, trials=50)
    for x, y in zip(hp.mc_bias_table(6, trials=50), bias):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(hp.estimate_cardinalities_pp(regs, bias),
                                  hj.estimate_cardinalities_pp(regs, bias))
