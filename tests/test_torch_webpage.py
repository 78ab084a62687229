"""The port's page parse (stract_tpu_torch/webpage/: Html on the port's
element tree, webpage/tree.py, with no lxml) against the JAX package's (Html
on lxml.html) on the same inputs: every key of Html.prepare() and
Webpage.as_document() and every link with its rel flags, on seeded pages
shaped like crawled ones (stract_tpu_torch/warc_corpus.py) and on a list of
malformed and unusual documents; the trees themselves against lxml's on
seeded tag soup; and the page helpers (rake_keywords, simhash_text,
detect_lang, NaiveBayes / SafetyClassifier). Exact equality throughout
(time.time pinned: prepare() stamps insertion_timestamp).
"""

from __future__ import annotations

import random
from unittest import mock

import numpy as np
import pytest

from stract_tpu_torch import warc_corpus as WC

MALFORMED = {
    "p_only": "<p>hi</p>",
    "two_ps": "<p>a</p><p>b</p>",
    "text_and_inline": "text <b>x</b>",
    "title_then_p": "<title>t</title><p>x</p>",
    "empty": "",
    "blank": "   \n ",
    "comment_only": "<!-- nothing -->",
    "comment_script_tail": "<div>a<!-- cmt -->b<script>var x=1;</script><p>c</p>tail</div>",
    "unclosed_p": "<html><body><p>one<p>two<p>three has enough words to be a good paragraph "
                  "of the text for the extractor</body></html>",
    "nested_tables": "<html><body><table><tr><td>a<table><tr><td>inner cell with many words "
                     "in the nested table of the page</td></tr></table><td>b<tr><td>c</table>"
                     "</body></html>",
    "entities": "<html><head><title>T &amp; x &lt;y&gt; &copy2024 &#128;</title></head><body>"
                "<p>caf&eacute; na&iuml;ve &nbsp; &unknown; &#x27;quoted&#x27; and the rest of "
                "the words</p></body></html>",
    "script_style": "<html><head><style>p { color: red }</style><script>if (a < b) { x = '<p>' }"
                    "</script></head><body><p>visible text of the page with the words</p>"
                    "<noscript><p>no script here at all with the words</p></noscript>"
                    "</body></html>",
    "noindex": '<html><head><meta name="robots" content="NoIndex, follow"></head>'
               "<body>x</body></html>",
    "json_ld_graph": '<html><head><script type="application/ld+json">{"@graph": [{"@type": '
                     '"Recipe", "name": "Pasta", "recipeIngredient": ["eggs", "cheese"]}, '
                     '{"@type": "Person", "name": "Ann"}]}</script></head><body>b</body></html>',
    "json_ld_bad": '<html><head><script type="application/ld+json">{not json</script>'
                   '<script type="application/ld+json"></script></head><body>b</body></html>',
    "microdata": '<html><body><div itemscope itemtype="https://schema.org/QAPage">'
                 '<span itemprop="name">Q</span><div itemprop="suggestedAnswer" itemscope '
                 'itemtype="https://schema.org/Answer"><span itemprop="text">A1</span></div>'
                 '<div itemprop="suggestedAnswer" itemscope><span itemprop="text">A2</span>'
                 '</div><div itemscope itemtype="https://schema.org/Thing"><span '
                 'itemprop="name">inner</span></div><meta itemprop="isAccessibleForFree" '
                 'content="false"></div></body></html>',
    "links_rel": '<html><head><link rel="canonical" href="/c"><link rel="icon stylesheet" '
                 'href="https://cdn.x.org/s.css"><link href=""></head><body><nav><a href="/a" '
                 'rel="nofollow ugc">nav</a></nav><footer><a href="https://other.org/">f</a>'
                 '</footer><a href="#top">top</a><a href="javascript:void(0)">js</a><a href='
                 '"mailto:a@b.c">m</a><a href="b/c?q=1" rel="SPONSORED">rel <img src=i.png>'
                 '</a><a>no href</a><a href="ftp://x.org/">ftp</a></body></html>',
    "misnested": "<html><body><p>a <b>bold <i>it</p> after</i></b><div><p>x</div>y<span>"
                 "s</p>t</span></body></html>",
    "implied_body": "<html>text before <b>any</b> body<p>para</p></html>",
    "after_html": "<html><body><p>in</p></body></html><p>after the html</p> trailing",
    "misplaced": "<html lang=de><body><p>x<body class=c><head><title>t2</title></head>"
                 "<html lang=fr>y</body></html>",
    "self_closing": "<html><body><div/>x<span/>y<p/>z<br/><a href=x/>link</a></body></html>",
    "uppercase": '<HTML LANG="FR"><HEAD><TITLE>Le titre</TITLE></HEAD><BODY><P CLASS="h-entry">'
                 "Le texte de la page est dans la langue et pour les lecteurs</P></BODY></HTML>",
    "repeated_attr": '<html><body><a href="/1" href="/2" rel="nofollow" rel="ugc">x</a>'
                     "</body></html>",
    "xml_decl": '<?xml version="1.0" encoding="utf-8"?><html><body><p>x</p></body></html>',
    "xml_decl_no_encoding": '<?xml version="1.0"?><html><body><p>x</p></body></html>',
    "doctype_ws": "\n  <!DOCTYPE html>\n<!-- lead -->\n<html>\n<head>\n<title> spaced \n title "
                  "</title>\n</head>\n<body>\n<h1> H </h1>\n<h2>a<br>b</h2>\n</body>\n</html>\n",
    "lists_forms": "<html><body><ul><li>one<li>two<ol><li>n</ol></ul><dl><dt>t<dd>d</dl><form>"
                   "<p>f<form>g</form><select><option>1<option>2</select></body></html>",
    "paywall_trackers": '<html><head><script src="https://www.googletagmanager.com/gtm.js">'
                        '</script></head><body><div class="article paywall">x</div><iframe '
                        'src="https://ads.doubleclick.net/f">in iframe</iframe><img src='
                        '"//pixel.facebook.net/p.gif"></body></html>',
    "headings_in_bad": "<html><body><header><h1>Head</h1></header><aside><p>the aside text is "
                       "long enough and has the words</p></aside><article><h3>Art</h3><p>And "
                       "this is the article text with the words of the page</p></article>"
                       "</body></html>",
    "raw_text_tags": "<html><body><textarea>a &amp; <b>b</b></textarea><xmp><i>raw</i></xmp>"
                     "<title>late &lt; title</title><iframe><p>in</p></iframe></body></html>",
    "cdata_pi": "<html><body><?php echo 1 ?><p>x</p><!bogus><![CDATA[cd]]></body></html>",
    "fragment_blocks": "<div>x</div>\n<p>y</p><!--c-->",
    "fragment_inline": "plain text only <em>and</em> more",
    "lang_hint": '<html lang="sv-SE"><body><p>och det är att en som för med på inte</p>'
                 "</body></html>",
    "stopword_lang": "<html><body><p>der die und das ist nicht ein mit für auf der die "
                     "und das</p></body></html>",
}
URL = "https://www.example.com/path/to/page?q=1&x=2"


def _prepare(html_cls, raw, url=URL):
    with mock.patch("time.time", return_value=1_700_000_000.0):
        return html_cls(raw, url).prepare()


def _links(h):
    return [(l.source, l.destination, l.text, l.rel_flags) for l in h.links()]


@pytest.mark.parametrize("name", list(MALFORMED))
def test_prepare_matches_jax_on_malformed_documents(name):
    from stract_tpu.webpage.html import Html as JaxHtml
    from stract_tpu_torch.webpage.html import Html

    raw = MALFORMED[name]
    assert _prepare(Html, raw) == _prepare(JaxHtml, raw)
    assert _links(Html(raw, URL)) == _links(JaxHtml(raw, URL))
    assert Html(raw, URL).is_no_index() == JaxHtml(raw, URL).is_no_index()


def test_prepare_matches_jax_on_seeded_pages():
    """600 seeded pages: prepare(), the links with their rel flags, and (on
    every fifth page, with centralities, backlink labels, keywords and a
    safety label set) Webpage.as_document()."""
    from stract_tpu.webpage.core import Webpage as JaxWebpage
    from stract_tpu.webpage.html import Html as JaxHtml
    from stract_tpu_torch.webpage.core import Webpage
    from stract_tpu_torch.webpage.html import Html

    rng = np.random.default_rng(7)
    hosts = [f"www.site{h}.{('com', 'org', 'de')[h % 3]}" for h in range(60)]
    n_links = n_ld = n_noindex = 0
    for i in range(600):
        url, raw, noindex = WC.page(rng, 1, i, hosts, (20, 120))
        ha, hb = JaxHtml(raw, url), Html(raw, url)
        with mock.patch("time.time", return_value=1_700_000_000.0):
            a, b = ha.prepare(), hb.prepare()
        assert a == b, (i, [k for k in a if a[k] != b.get(k)])
        assert _links(ha) == _links(hb), i
        n_links += len(hb.links())
        n_ld += bool(b["schema_org_json"])
        n_noindex += hb.is_no_index()
        assert hb.is_no_index() == ha.is_no_index() == noindex
        if i % 5 == 0:
            kw = dict(fetch_time_ms=i, host_centrality=0.1 * (i % 7), page_centrality_rank=i,
                      backlink_labels=[f"label {k}" for k in range(i % 5)],
                      keywords=["k1", "k2"], safety_classification="sfw")
            with mock.patch("time.time", return_value=1_700_000_000.0):
                assert Webpage(Html(raw, url), **kw).as_document() == \
                    JaxWebpage(JaxHtml(raw, url), **kw).as_document()
    assert n_links > 600 * 20 and n_ld >= 60 and n_noindex == 12


def _soup(rng, n):
    tags = ("a b i span div p h1 h2 ul ol li dl dt dd table tr td th tbody caption form select "
            "option title meta link script style br img hr head body html nav footer section "
            "center font pre blockquote textarea iframe noscript label input small address "
            "fieldset legend").split()
    text = ["hello", " ", "\n", " world ", "a&amp;b", "x &lt; y", "&nbsp;", "caf&eacute;", "1 < 2"]
    out = []
    for _ in range(n):
        r, t = rng.random(), rng.choice(tags)
        if r < 0.35:
            attrs = f' class="c{rng.randint(0, 3)}"' if rng.random() < 0.3 else ""
            attrs += " itemscope" if rng.random() < 0.1 else ""
            out.append(f"<{t}{attrs}>" if rng.random() > 0.05 else f"<{t}{attrs}/>")
        elif r < 0.6:
            out.append(f"</{t}>")
        elif r < 0.95:
            out.append(rng.choice(text))
        else:
            out.append("<!-- c -->")
    s = "".join(out)
    if rng.random() < 0.5:
        s = "<html>" + s + "</html>" if rng.random() < 0.5 else "<!DOCTYPE html>\n" + s
    return s


def _dump(el, depth=0):
    tag = el.tag if isinstance(el.tag, str) else "#comment"
    attrs = sorted(dict(el.attrib).items()) if isinstance(el.tag, str) else []
    out = [(depth, tag, attrs, el.text, el.tail)]
    for ch in el:
        out += _dump(ch, depth + 1)
    return out


@pytest.mark.parametrize("seed", range(4))
def test_tree_matches_lxml_on_tag_soup(seed):
    """The port's tree (tags, attributes, text, tails, comments, the root
    fromstring picks) is lxml.html's on 500 seeded soups of misnested,
    unclosed and stray tags."""
    import lxml.etree
    import lxml.html

    from stract_tpu_torch.webpage import tree

    rng = random.Random(seed)
    for _ in range(500):
        s = _soup(rng, rng.randint(1, 30))
        try:
            ref = _dump(lxml.html.fromstring(s))
        except (ValueError, lxml.etree.ParserError) as e:
            ref = type(e).__name__
        try:
            got = _dump(tree.fromstring(s))
        except tree.ParserError:
            got = "ParserError"
        assert got == ref, s


def test_page_helpers_match_jax():
    from stract_tpu import keywords as jk
    from stract_tpu.utils import simhash as js
    from stract_tpu.webpage import region as jr
    from stract_tpu_torch import keywords as pk
    from stract_tpu_torch.utils import simhash as ps
    from stract_tpu_torch.webpage import region as pr

    rng = np.random.default_rng(3)
    hosts = [f"h{h}.org" for h in range(10)]
    for i in range(60):
        _, raw, _ = WC.page(rng, 2, i, hosts, (20, 200))
        text = " ".join(raw.split(">")[-40:])
        for lang in ("en", "de", "xx"):
            assert pk.rake_keywords(text, lang) == jk.rake_keywords(text, lang)
        assert ps.simhash_text(text) == js.simhash_text(text)
        assert pr.detect_lang(text) == jr.detect_lang(text)
        assert pr.detect_lang(text, "pt-BR") == jr.detect_lang(text, "pt-BR")
    assert ps.hamming_distance(5, 3) == js.hamming_distance(5, 3)
    assert [pr.Region.from_lang(c).lang() for c in ("nb", "pl", "zz")] == \
        [jr.Region.from_lang(c).lang() for c in ("nb", "pl", "zz")]


def test_safety_classifier_matches_jax(tmp_path):
    from stract_tpu.utils.naive_bayes import NaiveBayes as JaxNB
    from stract_tpu.webpage.safety import SafetyClassifier as JaxSC
    from stract_tpu_torch.utils.naive_bayes import NaiveBayes
    from stract_tpu_torch.webpage.safety import SafetyClassifier

    rng = np.random.default_rng(4)
    nsfw = "adult explicit nsfw xxx video porn".split()
    sfw = "cooking recipes dinner programming tutorial code garden travel".split()
    texts, labels = [], []
    for i in range(80):
        bad = i % 3 == 0
        texts.append(" ".join(rng.choice(nsfw if bad else sfw, 12)))
        labels.append("nsfw" if bad else "sfw")
    a, b = JaxSC.train(texts, labels), SafetyClassifier.train(texts, labels)
    probes = [" ".join(rng.choice(nsfw + sfw, 8)) for _ in range(40)]
    assert [b.classify(t) for t in probes] == [a.classify(t) for t in probes]
    doc = {"title": "explicit adult", "clean_text": "nsfw xxx"}
    assert b.classify_webpage(doc) == a.classify_webpage(doc) == "nsfw"
    b.save(str(tmp_path / "p.npz"))
    a.save(str(tmp_path / "j.npz"))
    pa, pb = JaxNB.load(str(tmp_path / "p.npz")), NaiveBayes.load(str(tmp_path / "j.npz"))
    for t in probes[:10]:
        assert pb.predict_proba(t) == pa.predict_proba(t)
    assert SafetyClassifier().classify("anything") == "sfw"
