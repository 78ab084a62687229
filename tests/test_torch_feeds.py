"""The port's feeds and sitemaps (stract_tpu_torch/feed.py, sitemap.py on its
own recovering XML reader, xml_recover.py) against the JAX package's, which
read through lxml in recover mode, on the CPU.

Tolerance: none. parse_feed and parse_sitemap of each package give equal
dataclasses, field by field (title, url, published; url, lastmod,
is_sitemap), on 500 seeded documents (RSS 2.0, RSS 0.91 with its DOCTYPE,
RDF, Atom, urlset and sitemapindex; mixed-case tags, namespaces declared and
not, CDATA, `&amp;`, numeric and undefined references, raw `&` in URLs,
comments, CRLF, non-ASCII text, a UTF-8 BOM, an ISO-8859-1 declaration),
on 40 hand-made malformed documents (every recovery quirk of libxml2 the
reader reproduces: unescaped and undefined entities, truncation, mismatched
end tags, a stray `<`, `]]>` in text, bad character references, broken
attributes, unterminated CDATA / comments / PIs, encodings, bytes that are
not UTF-8) and on 600 seeded mutations of the seeded documents (cut,
characters inserted or deleted). Each document goes through both parsers
of each package, and the reader's whole tree (tags, attributes, text,
tails, comments, PIs, entity references) equals lxml's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

lxml_etree = pytest.importorskip("lxml.etree")

SEED_DOCS = 500
MUTATIONS = 600
CHUNK = 50

WORDS = ("news today fresh update release notes alpha beta gamma delta story post "
         "café naïve 中文 日本 über straße").split()


def _words(rng, k: int) -> str:
    return " ".join(rng.choice(WORDS, size=k))


def _esc(t: str) -> str:
    return t.replace("&", "&amp;").replace("<", "&lt;")


def _url(rng, host: str) -> str:
    u = f"https://{host}/p/{int(rng.integers(1_000_000))}"
    r = rng.random()
    if r < 0.2:
        u += f"?a={int(rng.integers(9))}&amp;b={int(rng.integers(9))}"
    elif r < 0.3:
        u += "?a=1&b=2"  # a raw & (recover mode drops "&b")
    elif r < 0.35:
        u += "?q=&#65;&#x42;"
    return u


def _title(rng) -> str:
    t = _words(rng, int(rng.integers(1, 6)))
    r = rng.random()
    if r < 0.15:
        return f"<![CDATA[{t} <b>x</b> & y]]>"
    if r < 0.25:
        return _esc(t) + " &amp; more &nbsp;x"
    if r < 0.3:
        return _esc(t) + "<!-- c -->tail"
    if r < 0.35:
        return f"  {_esc(t)}\r\n  {_esc(t)}  "
    return _esc(t)


def _case(rng, tag: str) -> str:
    r = rng.random()
    return tag.upper() if r < 0.1 else tag.capitalize() if r < 0.2 else tag


def _rss(rng, host: str) -> str:
    ch, it, ln, ti = (_case(rng, t) for t in ("channel", "item", "link", "title"))
    items = []
    for _ in range(int(rng.integers(0, 8))):
        parts = [f"<{ti}>{_title(rng)}</{ti}>", f"<{ln}>{_url(rng, host)}</{ln}>"]
        if rng.random() < 0.5:
            parts.append(f"<pubDate>Mon, 0{int(rng.integers(1, 9))} Jan 2024</pubDate>")
        if rng.random() < 0.2:
            parts.append(f"<dc:date>2024-01-0{int(rng.integers(1, 9))}</dc:date>")
        if rng.random() < 0.1:
            parts.append(f'<atom:link href="{_url(rng, host)}" rel="self"/>')
        if rng.random() < 0.1:
            parts[1] = f'<{ln} href="{_url(rng, host)}"/>'
        rng.shuffle(parts)
        items.append(f"<{it}>" + "\n".join(parts) + f"</{it}>")
    ns = ' xmlns:dc="http://purl.org/dc/elements/1.1/"' if rng.random() < 0.5 else ""
    ns += ' xmlns:atom="http://www.w3.org/2005/Atom"' if rng.random() < 0.5 else ""
    body = f"<{ch}><{ti}>{_title(rng)}</{ti}>\n" + "\n".join(items) + f"</{ch}>"
    if rng.random() < 0.15:
        return ('<rdf:RDF xmlns:rdf="http://www.w3.org/1999/02/22-rdf-syntax-ns#" '
                f'xmlns="http://purl.org/rss/1.0/"{ns}>' + body + "</rdf:RDF>")
    rt = _case(rng, "rss")
    return f'<{rt} version="2.0"{ns}>' + body + f"</{rt}>"


def _atom(rng, host: str) -> str:
    entries = []
    for _ in range(int(rng.integers(0, 8))):
        parts = []
        for _ in range(int(rng.integers(0, 3))):
            rel = rng.choice(["", ' rel="alternate"', ' rel="self"', " rel='enclosure'"])
            parts.append(f'<link{rel} href="{_url(rng, host)}"/>')
        parts.append(f"<title>{_title(rng)}</title>")
        if rng.random() < 0.5:
            parts.append("<published>2024-01-01</published>")
        if rng.random() < 0.5:
            parts.append("<updated>2024-01-02</updated>")
        rng.shuffle(parts)
        entries.append("<entry>" + "".join(parts) + "</entry>")
    ns = ' xmlns="http://www.w3.org/2005/Atom"' if rng.random() < 0.7 else ""
    return f"<feed{ns}><title>{_title(rng)}</title>" + "\n".join(entries) + "</feed>"


def _sitemap(rng, host: str) -> str:
    index = rng.random() < 0.3
    tag, inner = ("sitemapindex", "sitemap") if index else ("urlset", "url")
    parts = []
    for _ in range(int(rng.integers(0, 10))):
        lastmod = (f"<lastmod>2024-0{int(rng.integers(1, 9))}-01</lastmod>"
                   if rng.random() < 0.6 else "")
        loc = _url(rng, host) + (".xml" if index else "")
        if rng.random() < 0.1:
            loc = f"\n   {loc}  \n"
        parts.append(f"<{_case(rng, inner)}><{_case(rng, 'loc')}>{loc}</{_case(rng, 'loc')}>"
                     f"{lastmod}</{_case(rng, inner)}>")
    ns = ' xmlns="http://www.sitemaps.org/schemas/sitemap/0.9"' if rng.random() < 0.7 else ""
    return f"<{_case(rng, tag)}{ns}>" + "\n".join(parts) + f"</{_case(rng, tag)}>"


def seeded_document(rng, i: int):
    """Document i of the seeded set → str or bytes."""
    host = f"site{i}.com"
    body = (_rss, _atom, _sitemap)[i % 3](rng, host)
    r = rng.random()
    if r < 0.3:
        body = '<?xml version="1.0" encoding="UTF-8"?>\n' + body
    elif r < 0.4:
        body = "<?xml version='1.0'?>\r\n<!-- generated -->\n" + body
    elif r < 0.45:
        body = ('<?xml version="1.0"?>\n<!DOCTYPE rss PUBLIC "-//Netscape Communications//DTD '
                'RSS 0.91//EN" "http://my.netscape.com/publish/formats/rss-0.91.dtd">\n' + body)
    r = rng.random()
    if r < 0.5:
        return body
    if r < 0.6:
        return b"\xef\xbb\xbf" + body.encode()
    if r < 0.7 and not body.startswith("<?xml"):
        return (b'<?xml version="1.0" encoding="ISO-8859-1"?>'
                + body.encode("latin-1", errors="replace"))
    return body.encode()


_INSERTS = (b"<", b"&", b">", b"/", b'"', b"]]>", b"</x>", b"&#", b"&amp", b"<!--",
            b"<![CDATA[", b"\x01", b"\xe9", b"</", b"<?")


def mutate(rng, doc) -> bytes:
    """One seeded damage: a cut, an insertion, a deletion or a replacement."""
    b = doc if isinstance(doc, bytes) else doc.encode()
    op, k = int(rng.integers(0, 5)), int(rng.integers(0, len(b) + 1))
    ins = _INSERTS[int(rng.integers(0, len(_INSERTS)))]
    if op == 0:
        return b[:k]
    if op == 1:
        return b[:k] + ins + b[k:]
    if op == 2:
        return b[:k] + b[k + 1:]
    if op == 3:
        j = int(rng.integers(0, len(b) + 1))
        return b[:min(k, j)] + b[max(k, j):]
    return b[:k] + ins + b[k + 1:]


MALFORMED = [
    b'<urlset><url><loc>https://a.com/?x=1&y=2</loc></url></urlset>',           # raw &
    b'<urlset><url><loc>https://a.com/1</loc></url><url><loc>https://a.com/2</loc><lastm',
    b'<rss><channel><item><link>https://b.com/1</link></item><item><title>t</title><link>h',
    b'<rss><channel><title><![CDATA[Hi <b>x</b>]]></title><item><link>https://c/1</link>'
    b'</item></channel></rss>',                                                     # CDATA
    b'<urlset><url><loc>https://a.com/?a=1&amp;b=2</loc></url></urlset>',         # &amp;
    b'<RSS><Channel><Item><Link>https://d.com/1</Link><TITLE>T</TITLE></Item></Channel></RSS>',
    b'\xef\xbb\xbf<?xml version="1.0" encoding="ISO-8859-1"?><rss><channel><title>caf\xe9'
    b'</title></channel></rss>',                                                    # BOM wins
    b'<?xml version="1.0" encoding="ISO-8859-1"?><rss><channel><title>caf\xe9</title>'
    b'</channel></rss>',
    b"not xml at all <<<", b"", b"\x00\x01\x02", b"   ",
    b'<rss><channel><item><link>https://e.com/1</link><title>a &nbsp; b</title></item>'
    b'<item><link>https://e.com/2?a=1&amp;b=2</link></item></channel></rss>',   # after an error
    b'<urlset><url><loc>https://f.com/1</LOC></url><url><loc>https://f.com/2</loc></url>'
    b'</urlset>',                                                                   # mismatch
    b'<rss><channel><item><title>x < y</title><link>https://g.com/1</link></item></channel>'
    b'</rss>',                                                                      # stray <
    b'<urlset><url><loc>https://h.com/1]]>2</loc></url></urlset>',              # ]]> in text
    b'<urlset><url><loc>https://h.com/\xc3\xa9]]>2</loc></url></urlset>',
    b'<urlset><url><loc>https://i.com/&#xZZ;&#12a;&#0;&#65</loc></url></urlset>',
    b'<feed><entry><link href="https://j.com/1" rel=alternate/><title>t</title></entry>'
    b'<entry><link href="https://j.com/2"/></entry></feed>',                       # unquoted
    b'<feed><entry><link href rel="alternate"/></entry><entry><link href="https://k/2" '
    b'href="https://k/3"/></entry></feed>',                                        # no value
    b'<feed><entry><link href="https://l.com/a<b"/></entry></feed>',             # < in attr
    b'<feed><entry><link href="https://m.com/&#xZZ;" rel="x"/><title>t</title></entry>'
    b'</feed>',
    b'<rss><channel><item><link>https://n.com/1</link><title><![CDATA[unterminated',
    b'<rss><channel><item><link>https://n.com/1</link><title>a<!-- unterminated',
    b'<rss><channel><item><link>https://n.com/1</link><title>a<?pi unterminated',
    b'<?xml version="1.0" encoding="UTF-16"?><rss><channel><title>t</title></channel></rss>',
    b'<?xml version="1.0" encoding="bogus-enc"?><rss><channel><item><link>https://o/1&amp;2'
    b'</link></item></channel></rss>',
    b'<?xml version="1.0" encoding="windows-1252"?><rss><channel><title>\x93q\x94</title>'
    b'</channel></rss>',
    b'<urlset><url><loc>https://p.com/\xe9\xe9x\xf0\x9f\x98y</loc></url></urlset>',
    b'<urlset><url><loc>https://p.com/1</loc></url><url><loc>https://p.com/\xe2\x82',
    b'<!DOCTYPE rss SYSTEM "rss.dtd"><rss><channel><item><title>&nbsp;</title><link>'
    b'https://q.com/a&amp;b</link></item></channel></rss>',                      # external DTD
    b'<!DOCTYPE rss [<!ENTITY e "v">]><rss><channel><title>1&e;2</title></channel></rss>',
    b'<urlset><url><loc>https://r.com/1</loc></url></urlset><urlset><url><loc>https://r.com/2'
    b'</loc></url></urlset>',                                                       # after root
    b'<rss xmlns:atom="http://www.w3.org/2005/Atom"><channel><item><atom:link>https://s/1'
    b'</atom:link><x:link>https://s/2</x:link></item></channel></rss>',            # namespaces
    b'<rss><channel><item><link href="https://t.com/1"/></item></channel></rss>',
    b'<rdf:RDF xmlns:rdf="http://www.w3.org/1999/02/22-rdf-syntax-ns#"><channel><title>R'
    b'</title><item><link>https://u.com/1</link><dc:date>2024</dc:date></item></channel>'
    b'</rdf:RDF>',
    b'<urlset><url><loc>a\x01b\x0bc</loc></url><url><loc>\r\nd\re</loc></url></urlset>',
    b'<urlset><url><loc>https://v.com/1</loc></url></ urlset><url><loc>w</loc></url>',
    b'<feed><entry><link href="https://w.com/1"/><title>t</title></entry x><entry><link '
    b'href="https://w.com/2"/></entry></feed>',
    b'<?xml version="1.0" standalone="yes"?><!DOCTYPE rss SYSTEM "x.dtd"><rss><channel>'
    b'<title>&nbsp;&amp;</title></channel></rss>',
]


def _jax():
    from stract_tpu import feed, sitemap

    return feed.parse_feed, sitemap.parse_sitemap


def _port():
    from stract_tpu_torch import feed, sitemap

    return feed.parse_feed, sitemap.parse_sitemap


def _plain(out):
    """A parse result as plain data: the dataclasses' field names and values."""
    if isinstance(out, list):
        return [dataclasses.asdict(e) for e in out]
    return dataclasses.asdict(out)


def _lxml_tree(el):
    if el is None:
        return None
    kind = {lxml_etree.Comment: "comment", lxml_etree.ProcessingInstruction: "pi",
            lxml_etree.Entity: "entity"}.get(el.tag, "element")
    return (el.tag if kind == "element" else kind, dict(el.attrib) if kind == "element" else None,
            el.text, [_lxml_tree(c) for c in el], el.tail)


def _port_tree(el):
    if el is None:
        return None
    return (el.tag if el.kind == "element" else el.kind,
            dict(el.attrib) if el.kind == "element" else None,
            el.text, [_port_tree(c) for c in el], el.tail)


def _lxml_root(doc):
    data = doc.encode("utf-8", errors="replace") if isinstance(doc, str) else doc
    parser = lxml_etree.XMLParser(recover=True, resolve_entities=False, no_network=True)
    try:
        return lxml_etree.fromstring(data, parser=parser)
    except lxml_etree.XMLSyntaxError:
        return None


def assert_same(doc):
    """Both parsers of both packages agree on `doc`, and so do the trees."""
    from stract_tpu_torch import xml_recover

    for jax_fn, port_fn in zip(_jax(), _port()):
        assert _plain(port_fn(doc)) == _plain(jax_fn(doc)), (jax_fn.__name__, doc)
    root = _lxml_root(doc)
    assert _port_tree(xml_recover.fromstring(doc)) == _lxml_tree(root), doc
    return root


@pytest.fixture(scope="module")
def seeded():
    rng = np.random.default_rng(27)
    return [seeded_document(rng, i) for i in range(SEED_DOCS)]


@pytest.mark.parametrize("chunk", range(SEED_DOCS // CHUNK))
def test_seeded_documents_parse_as_in_the_jax_package(seeded, chunk):
    found = 0
    for doc in seeded[chunk * CHUNK:(chunk + 1) * CHUNK]:
        root = assert_same(doc)
        found += root is not None
    assert found == CHUNK  # every seeded document is one lxml reads a root from


def test_seeded_documents_yield_entries(seeded):
    """The seeded set reaches every branch: feed items from RSS, RDF and
    Atom, sitemap entries of both kinds, titles with CDATA and entities."""
    parse_feed, parse_sitemap = _port()
    items = [it for d in seeded[0::3] + seeded[1::3] for it in parse_feed(d).items]
    entries = [e for d in seeded[2::3] for e in parse_sitemap(d)]
    assert len(items) > 500 and any("<b>x</b>" in it.title for it in items)
    assert any(it.published for it in items) and any("=2" in it.url for it in items)
    assert {e.is_sitemap for e in entries} == {True, False} and any(e.lastmod for e in entries)


@pytest.mark.parametrize("case", range(len(MALFORMED)))
def test_malformed_document_parses_as_in_the_jax_package(case):
    assert_same(MALFORMED[case])


@pytest.mark.parametrize("chunk", range(MUTATIONS // 100))
def test_damaged_documents_parse_as_in_the_jax_package(seeded, chunk):
    rng = np.random.default_rng(1000 + chunk)
    for t in range(100):
        doc = mutate(rng, seeded[int(rng.integers(0, SEED_DOCS))])
        if rng.random() < 0.3:
            doc = mutate(rng, doc)
        assert_same(doc)


def test_recover_mode_quirks():
    """The quirks of recover mode, as the JAX functions show them."""
    parse_feed, parse_sitemap = _port()
    assert parse_sitemap(MALFORMED[0])[0].url == "https://a.com/?x=1=2"
    assert [e.url for e in parse_sitemap(MALFORMED[1])] == ["https://a.com/1", "https://a.com/2"]
    assert parse_feed(MALFORMED[3]).title == "Hi <b>x</b>"
    assert parse_sitemap(MALFORMED[4])[0].url == "https://a.com/?a=1&b=2"
    assert parse_feed(MALFORMED[5]).items[0].url == "https://d.com/1"
    assert parse_feed(MALFORMED[6]).title == "caf�"
    assert parse_feed(MALFORMED[7]).title == "café"
    for garbage in MALFORMED[8:12]:
        assert parse_sitemap(garbage) == [] and parse_feed(garbage).items == []
    # a defined entity's reference drops once the document is not well formed
    assert [it.url for it in parse_feed(MALFORMED[12]).items] == ["https://e.com/1",
                                                                 "https://e.com/2?a=1b=2"]
