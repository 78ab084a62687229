"""Entity-index construction from ZIM dumps — the port of
stract_tpu/entrypoint/entity.py, run by `main.py indexer entity CONFIG`
(role of reference entrypoint/entity.rs:194: ZIM → parse wiki article →
Entity{title, abstract, image, infobox} → entity index).

The JAX package parses an article with lxml, which the card's machine does
not have; the port builds the same element tree with the standard library's
html.parser (webpage/tree.py `parse_html`, libxml2's construction rules). On
an article's HTML it gives parse_wiki_article's Entity exactly as the lxml
tree does (tests/test_torch_entity.py holds it to the JAX package)."""

from __future__ import annotations

from ..entity_index import Entity, EntityIndex
from ..webpage.tree import Element as Node, _TreeBuilder, parse_html  # noqa: F401
from ..zim import ZimFile


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
