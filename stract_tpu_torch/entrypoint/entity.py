"""Entity-index construction from ZIM dumps — the port of
stract_tpu/entrypoint/entity.py, run by `main.py indexer entity CONFIG`
(role of reference entrypoint/entity.rs:194: ZIM → parse wiki article →
Entity{title, abstract, image, infobox} → entity index).

The JAX package parses an article with lxml, which the card's machine does
not have; the port builds the same element tree with the standard library's
html.parser (`parse_html`): void elements, a <p> closed by the block that
starts inside it, a cell or row closed by the next one, an end tag closing
the open element of its name, comments dropped, entities decoded. On an
article's HTML it gives parse_wiki_article's Entity exactly as the lxml
tree does (tests/test_torch_entity.py holds it to the JAX package)."""

from __future__ import annotations

from html.parser import HTMLParser

from ..entity_index import Entity, EntityIndex
from ..zim import ZimFile

VOID = frozenset({"area", "base", "br", "col", "embed", "hr", "img", "input", "link", "meta",
                  "param", "source", "track", "wbr"})
# elements whose start closes an open <p> (libxml2's auto-close of a paragraph)
BLOCKS = frozenset({"address", "article", "aside", "blockquote", "dd", "details", "dialog",
                    "div", "dl", "dt", "fieldset", "figcaption", "figure", "footer", "form",
                    "h1", "h2", "h3", "h4", "h5", "h6", "header", "hr", "li", "main", "nav",
                    "ol", "p", "pre", "section", "table", "ul"})
# a start tag closes the nearest open element named in its first set (and
# what is open inside it) unless an element of its second set comes first: a
# cell closes a cell of its own row, a row a row of its own table
SECTIONS = {"tbody", "thead", "tfoot"}
CLOSES = {"td": ({"td", "th"}, {"tr", "table"}), "th": ({"td", "th"}, {"tr", "table"}),
          "tr": ({"tr"}, {"table"} | SECTIONS), "tbody": (SECTIONS, {"table"}),
          "thead": (SECTIONS, {"table"}), "tfoot": (SECTIONS, {"table"}),
          "li": ({"li"}, {"ul", "ol"}), "option": ({"option"}, {"select"})}


class Node:
    """An element: tag, attributes, children (Nodes and text) in order."""

    __slots__ = ("tag", "attrs", "children", "parent")

    def __init__(self, tag: str, attrs: dict, parent=None):
        self.tag, self.attrs, self.children, self.parent = tag, attrs, [], parent

    def get(self, name: str, default=None):
        return self.attrs.get(name, default)

    def getparent(self):
        return self.parent

    def iter(self, tag: str):
        """The elements named `tag` in document order, this one included."""
        stack = [self]
        while stack:
            node = stack.pop()
            if node.tag == tag:
                yield node
            stack.extend(c for c in reversed(node.children) if isinstance(c, Node))

    def itertext(self):
        for c in self.children:
            if isinstance(c, Node):
                yield from c.itertext()
            else:
                yield c


class _TreeBuilder(HTMLParser):
    def __init__(self):
        super().__init__(convert_charrefs=True)
        self.root = Node("html", {})
        self.stack = [self.root]

    def _pop_to(self, tags, boundary) -> None:
        for i in range(len(self.stack) - 1, 0, -1):
            tag = self.stack[i].tag
            if tag in tags:
                del self.stack[i:]
                return
            if tag in boundary:
                return

    def handle_starttag(self, tag, attrs):
        if tag in BLOCKS:
            self._pop_to({"p"}, BLOCKS | {"td", "th", "table", "body", "html"})
        if tag in CLOSES:
            self._pop_to(*CLOSES[tag])
        node = Node(tag, {}, self.stack[-1])
        for k, v in attrs:  # a repeated attribute keeps its first value, as libxml2's
            node.attrs.setdefault(k, v if v is not None else "")
        self.stack[-1].children.append(node)
        if tag not in VOID:
            self.stack.append(node)

    def handle_startendtag(self, tag, attrs):
        self.handle_starttag(tag, attrs)
        if tag not in VOID:
            self.handle_endtag(tag)

    def handle_endtag(self, tag):
        self._pop_to({tag}, ())

    def handle_data(self, data):
        self.stack[-1].children.append(data)


def parse_html(html: str) -> Node:
    """The element tree of an HTML document or fragment → its root."""
    builder = _TreeBuilder()
    builder.feed(html)
    builder.close()
    return builder.root


def parse_wiki_article(html: str, title: str) -> Entity | None:
    root = parse_html(html or "")

    # abstract = first substantial paragraph outside the infobox
    abstract = ""
    for p in root.iter("p"):
        in_infobox = False
        cur = p.getparent()
        while cur is not None:
            if "infobox" in (cur.get("class") or ""):
                in_infobox = True
                break
            cur = cur.getparent()
        if in_infobox:
            continue
        text = " ".join("".join(p.itertext()).split())
        if len(text) > 50:
            abstract = text
            break

    info = {}
    image = ""
    for table in root.iter("table"):
        if "infobox" not in (table.get("class") or ""):
            continue
        for img in table.iter("img"):
            if img.get("src"):
                image = img.get("src")
                break
        for tr in table.iter("tr"):
            cells = list(tr.iter("th")) + list(tr.iter("td"))
            if len(cells) >= 2:
                k = " ".join("".join(cells[0].itertext()).split())
                v = " ".join("".join(cells[1].itertext()).split())
                if k and v and len(k) < 64:
                    info[k] = v[:256]
        break

    if not abstract and not info:
        return None
    return Entity(title=title, abstract=abstract, image=image, info=info)


def build_entity_index(zim_path: str, output_path: str, limit: int | None = None) -> EntityIndex:
    zim = ZimFile(zim_path)
    index = EntityIndex(output_path)
    n = 0
    for article in zim.articles():
        e = parse_wiki_article(article.text(), article.title)
        if e is None:
            continue
        index.insert(e)
        n += 1
        if limit and n >= limit:
            break
    index.commit()
    zim.close()
    return index
