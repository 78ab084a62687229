"""An HTML element tree built with the standard library's html.parser, shaped
as lxml.html builds it with libxml2's HTML parser (the JAX package parses
pages with lxml, which the card's machine does not have).

The elements carry lxml's interface as the port's readers use it: `tag`
(a str, or the `Comment` function for a comment), `get`, `text` and `tail`,
`getparent`, iteration over the children, `len`, `iter(tag)` in document
order (comments included when no tag is named), `itertext` (the text and
the children's tails, comments' text left out) and `find(".//tag")`.

The tree follows libxml2's legacy construction rules:

* an implied <html>, a <head> implied by a head element (title, meta, link,
  script, style, base) at the top, a <body> implied by any other element
  or by text that is not white space;
* a start tag closes the open element above it while the pair stands in
  START_CLOSE (a <p> by a block, a cell by a cell, an item by an item...),
  and <head> by any body element;
* an end tag closes the open element of its name and what is open inside
  it, unless something of a higher END_PRIORITY (a cell, a row, a table)
  stands between; an end tag with no open element is dropped;
* a misplaced <html>, <head> or <body> start tag is dropped with its end
  tag; text outside the root element is dropped, white space kept inside;
* script, style, xmp, iframe, noembed, noframes and plaintext hold raw
  text, title and textarea text with its references decoded.

`fromstring` then picks the root as lxml.html.fromstring does: the document
for a whole page, else the single element of a fragment or its body renamed
div or span. tests/test_torch_webpage.py holds Html.prepare() on these trees
to the JAX package's on lxml's.
"""

from __future__ import annotations

import html as _html
import re
from html.parser import HTMLParser


def Comment(text=None):  # noqa: N802 — lxml's name for the comment tag
    """The `tag` of a comment node (as lxml's etree.Comment is)."""
    return Element(Comment, {}, text)


VOID = frozenset({"area", "base", "basefont", "br", "col", "frame", "hr", "img", "input",
                  "isindex", "link", "meta", "param"})
RAW_TEXT = frozenset({"script", "style", "xmp", "iframe", "noembed", "noframes", "plaintext"})
ESCAPABLE_RAW_TEXT = frozenset({"title", "textarea"})
# elements whose start tag at the top of the document implies a <head>
HEAD_ELEMENTS = frozenset({"script", "style", "meta", "link", "title", "base"})
# elements whose start tag closes an open <head> (the others may open inside it)
_HEAD_CLOSERS = frozenset({
    "a", "abbr", "acronym", "address", "b", "bdo", "big", "blockquote", "body", "br", "center",
    "cite", "code", "dd", "dfn", "dir", "div", "dl", "dt", "em", "fieldset", "font", "form",
    "frameset", "h1", "h2", "h3", "h4", "h5", "h6", "hr", "i", "iframe", "img", "kbd", "li",
    "listing", "map", "menu", "ol", "p", "pre", "q", "s", "samp", "small", "span", "strike",
    "strong", "sub", "sup", "table", "tt", "u", "ul", "var", "xmp"})
_HEADINGS = ("fieldset", "form", "li", "p", "table")
# (open element, start tag that closes it)
START_CLOSE = {
    "a": ("a", "fieldset", "table", "td", "th"),
    "address": ("dd", "dl", "dt", "form", "li", "ul"),
    "b": ("center", "p", "td", "th"),
    "big": ("p",),
    "caption": ("col", "colgroup", "tbody", "tfoot", "thead", "tr"),
    "colgroup": ("colgroup", "tbody", "tfoot", "thead", "tr"),
    "dd": ("dt",),
    "dir": ("dd", "dl", "dt", "form", "ul"),
    "dl": ("form", "li"),
    "dt": ("dd", "dl"),
    "font": ("center", "td", "th"),
    "form": ("form",),
    "h1": _HEADINGS, "h2": _HEADINGS, "h3": _HEADINGS, "h4": _HEADINGS, "h5": _HEADINGS,
    "h6": _HEADINGS,
    "i": ("center", "p", "td", "th"),
    "legend": ("fieldset",),
    "li": ("li",),
    "listing": ("dd", "dl", "dt", "fieldset", "form", "li", "table", "ul"),
    "menu": ("dd", "dl", "dt", "form", "ul"),
    "ol": ("form",),
    "option": ("optgroup", "option"),
    "p": ("address", "blockquote", "body", "caption", "center", "col", "colgroup", "dd", "dir",
          "div", "dl", "dt", "fieldset", "form", "h1", "h2", "h3", "h4", "h5", "h6", "head",
          "hr", "li", "listing", "menu", "ol", "p", "pre", "table", "tbody", "td", "tfoot", "th",
          "title", "tr", "ul", "xmp"),
    "pre": ("dd", "dl", "dt", "fieldset", "form", "li", "table", "ul"),
    "s": ("p",), "small": ("p",), "strike": ("p",), "tt": ("p",),
    "span": ("td", "th"),
    "tbody": ("tbody", "tfoot"),
    "td": ("tbody", "td", "tfoot", "th", "tr"),
    "tfoot": ("tbody",),
    "th": ("tbody", "td", "tfoot", "th", "tr"),
    "thead": ("tbody", "tfoot"),
    "tr": ("tbody", "tfoot", "tr"),
    "u": ("p", "td", "th"),
    "ul": ("address", "form", "menu", "pre"),
}
START_CLOSE = {k: frozenset(v) for k, v in START_CLOSE.items()}
START_CLOSE["head"] = _HEAD_CLOSERS
# an end tag closes no open element of a higher priority than its own
END_PRIORITY = {"div": 150, "td": 160, "th": 160, "tr": 170, "thead": 180, "tbody": 180,
                "tfoot": 180, "table": 190, "head": 200, "body": 200, "html": 220}
# lxml.html.defs.block_tags: a fragment's body holding one becomes a div, else a span
BLOCK_TAGS = frozenset({
    "address", "blockquote", "caption", "center", "col", "colgroup", "dd", "del", "dir", "div",
    "dl", "dt", "fieldset", "form", "h1", "h2", "h3", "h4", "h5", "h6", "hr", "ins", "isindex",
    "legend", "li", "menu", "noscript", "ol", "optgroup", "option", "p", "pre", "table",
    "tbody", "td", "tfoot", "th", "thead", "tr", "ul"})
_WS = " \t\n\r\f"  # libxml2's HTML white space
_FULL_HTML = re.compile(r"^\s*<(?:html|!doctype)", re.I).match
# lxml refuses a str that declares its encoding
_XML_ENCODING = re.compile(
    r'^(<\?xml[^>]+)\s+encoding\s*=\s*["\'][^"\']*["\'](\s*\?>|)', re.U).match


class ParserError(ValueError):
    """The document holds no element (lxml.etree.ParserError's role)."""


class Element:
    """An element or a comment: tag, attributes, text, tail, children."""

    __slots__ = ("tag", "attrib", "text", "tail", "children", "parent")

    def __init__(self, tag, attrib: dict, text=None, parent=None):
        self.tag, self.attrib, self.text, self.tail = tag, attrib, text, None
        self.children: list = []
        self.parent = parent

    def __repr__(self):
        return f"<Element {self.tag if isinstance(self.tag, str) else 'comment'}>"

    def __iter__(self):
        return iter(self.children)

    def __len__(self):
        return len(self.children)

    def __getitem__(self, i):
        return self.children[i]

    def get(self, name: str, default=None):
        return self.attrib.get(name, default)

    def getparent(self):
        return self.parent

    def iter(self, tag: str | None = None):
        """This node and its descendants in document order: all of them, or
        the elements named `tag`."""
        stack = [self]
        while stack:
            node = stack.pop()
            if tag is None or node.tag == tag:
                yield node
            stack.extend(reversed(node.children))

    def itertext(self):
        if not isinstance(self.tag, str):
            return
        if self.text:
            yield self.text
        for c in self.children:
            yield from c.itertext()
            if c.tail:
                yield c.tail

    def find(self, path: str):
        """The first descendant named by a ".//tag" path, or None."""
        if not path.startswith(".//"):
            raise ValueError(f"only .//tag paths: {path!r}")
        tag = path[3:]
        return next((e for e in self.iter(tag) if e is not self), None)

    def findall(self, tag: str) -> list:
        """The children named `tag`."""
        return [c for c in self.children if c.tag == tag]

    def _append(self, node) -> None:
        node.parent = self
        self.children.append(node)

    def _add_text(self, data: str) -> None:
        if self.children:
            last = self.children[-1]
            last.tail = data if last.tail is None else last.tail + data
        else:
            self.text = data if self.text is None else self.text + data


class _TreeBuilder(HTMLParser):
    # the raw-text elements are set here, on every version of html.parser
    CDATA_CONTENT_ELEMENTS = ()
    RCDATA_CONTENT_ELEMENTS = ()

    def __init__(self):
        super().__init__(convert_charrefs=True)
        self.root: Element | None = None
        self.stack: list = []
        self.phase = 0  # libxml2's ctxt->html: 3 once a head opened, 10 once a body
        self.misplaced = 0  # dropped html/head/body start tags, whose end tags drop too
        self.done = False  # the root closed: what follows lies outside the document
        self._rcdata: Element | None = None

    # -- the open elements ---------------------------------------------------------
    def _push(self, tag: str, attrs: dict) -> Element:
        node = Element(tag, attrs)
        if self.stack:
            self.stack[-1]._append(node)
        else:
            self.root = node
        if tag == "head" and self.phase < 3:
            self.phase = 3
        if tag == "body" and self.phase < 10:
            self.phase = 10
        self.stack.append(node)
        return node

    def _pop(self) -> None:
        self.stack.pop()
        if not self.stack:
            self.done = True

    def _auto_close(self, tag: str) -> None:
        while len(self.stack) > 1 and tag in START_CLOSE.get(self.stack[-1].tag, ()):
            self._pop()

    def _check_implied(self, tag: str) -> None:
        if tag == "html":
            return
        if not self.stack:
            self._push("html", {})
        if tag in ("body", "head"):
            return
        if len(self.stack) <= 1 and tag in HEAD_ELEMENTS:
            if self.phase < 3:
                self._push("head", {})
        elif tag not in ("noframes", "frame", "frameset"):
            if self.phase >= 10 or any(e.tag in ("body", "head") for e in self.stack):
                return
            self._push("body", {})

    # -- parser events ----------------------------------------------------------------
    def handle_starttag(self, tag, attrs):
        self._start(tag, attrs)

    def _start(self, tag, attrs) -> Element | None:
        """Open an element → the element (the open one a misplaced html,
        head or body start tag leaves in place), None past the root."""
        if self.done:
            return None
        self._auto_close(tag)
        self._check_implied(tag)
        if (tag == "html" and self.stack) or (tag == "head" and len(self.stack) != 1) or (
                tag == "body" and any(e.tag == "body" for e in self.stack)):
            self.misplaced += 1
            return self.stack[-1]
        attrib: dict = {}
        for k, v in attrs:  # a repeated attribute keeps its first value, as libxml2's
            attrib.setdefault(k, v if v is not None else "")
        node = self._push(tag, attrib)
        if tag in VOID:
            self.stack.pop()
        elif tag in RAW_TEXT or tag in ESCAPABLE_RAW_TEXT:
            # raw text as the tag's content; title's and textarea's references
            # are decoded at its end (set_cdata_mode hands the text over raw)
            self.set_cdata_mode(tag)
            self._rcdata = node if tag in ESCAPABLE_RAW_TEXT else None
        return node

    def handle_startendtag(self, tag, attrs):
        # libxml2 closes any element written <tag/> (a misplaced one: the
        # element open where it stands)
        node = self._start(tag, attrs)
        if node is not None and tag not in VOID:
            if self.cdata_elem is not None:
                self.clear_cdata_mode()
                self._rcdata = None
            if self.stack and self.stack[-1] is node:
                self._pop()

    def handle_endtag(self, tag):
        self._decode_rcdata()
        if self.done:
            return
        if tag in ("html", "body", "head") and self.misplaced > 0:
            self.misplaced -= 1
            return
        for i in range(len(self.stack) - 1, -1, -1):
            if self.stack[i].tag == tag:
                break
        else:
            return
        prio = END_PRIORITY.get(tag, 100)
        if any(END_PRIORITY.get(e.tag, 100) > prio for e in self.stack[i + 1:]):
            return
        del self.stack[i + 1:]
        self._pop()

    def handle_data(self, data):
        if self.done or not data:
            return
        rest = data.lstrip(_WS)
        if rest and (not self.stack or self.stack[-1].tag in ("html", "head")):
            # text implies a body; the white space before it stays where it is
            if self.stack and len(rest) < len(data):
                self.stack[-1]._add_text(data[:len(data) - len(rest)])
            data = rest
            self._auto_close("p")
            self._check_implied("p")
        if self.stack:
            self.stack[-1]._add_text(data)

    def handle_comment(self, data):
        if not self.done and self.stack:
            self.stack[-1]._append(Element(Comment, {}, data))

    def handle_pi(self, data):
        self.handle_comment("?" + data)

    def unknown_decl(self, data):  # <![CDATA[x]]>: a comment "[CDATA[x]]"
        self.handle_comment("[" + data + "]]" if data.startswith("CDATA[") else data)

    def close(self):
        super().close()
        self._decode_rcdata()

    def _decode_rcdata(self) -> None:
        if self._rcdata is not None and self._rcdata.text is not None:
            self._rcdata.text = _html.unescape(self._rcdata.text)
        self._rcdata = None


def document(raw: str) -> Element:
    """The root element of the document libxml2 builds from `raw` (an
    implied <html> around a fragment). Raises ParserError when the text
    holds no element, ValueError for a str declaring an XML encoding."""
    if _XML_ENCODING(raw):
        raise ValueError("Unicode strings with encoding declaration are not supported.")
    builder = _TreeBuilder()
    builder.feed(raw)
    builder.close()
    if builder.root is None:
        raise ParserError("Document is empty")
    return builder.root


def fromstring(raw: str) -> Element:
    """lxml.html.fromstring's root: the document of a whole page (one that
    starts with <html or <!doctype); of a fragment, its single element, or
    its body renamed div (when it holds a block) or span."""
    doc = document(raw)
    if _FULL_HTML(raw):
        return doc
    bodies = doc.findall("body")
    body = bodies[0] if bodies else None
    for other in bodies[1:]:
        if other.text:
            if len(body):
                body[-1].tail = (body[-1].tail or "") + other.text
            else:
                body.text = (body.text or "") + other.text
        for c in other.children:
            body._append(c)
        doc.children.remove(other)
    if doc.findall("head") or body is None:
        return doc
    if len(body) == 1 and (not body.text or not body.text.strip()) and (
            not body[-1].tail or not body[-1].tail.strip()):
        return body[0]
    body.tag = "div" if any(isinstance(e.tag, str) and e.tag in BLOCK_TAGS
                            for e in body.iter()) else "span"
    return body


def parse_html(raw: str) -> Element:
    """The <html> element of an HTML document or fragment (implied around a
    fragment; an empty one for a text that holds no element)."""
    try:
        return document(raw or "<html></html>")
    except ValueError:
        return Element("html", {})
