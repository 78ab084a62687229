"""RSS/Atom feed parsing — the port of stract_tpu/feed.py (role of
reference feed/, 302 LoC): RSS 0.9x / 2.0, RDF and Atom, read by the port's
own recovering XML reader (xml_recover.py) where the JAX package reads
through lxml in recover mode; the feeds are the JAX package's."""

from __future__ import annotations

from dataclasses import dataclass, field

from .xml_recover import fromstring


@dataclass
class FeedItem:
    url: str
    title: str = ""
    published: str = ""


@dataclass
class Feed:
    title: str = ""
    items: list = field(default_factory=list)


def _text(el) -> str:
    return " ".join("".join(el.itertext()).split()) if el is not None else ""


def _local(tag) -> str:
    return tag.rsplit("}", 1)[-1].lower() if isinstance(tag, str) else ""


def parse_feed(content: str | bytes) -> Feed:
    root = fromstring(content)
    if root is None:
        return Feed()

    feed = Feed()
    tag = _local(root.tag)
    if tag == "rss" or tag == "rdf":
        channel = next((c for c in root if _local(c.tag) == "channel"), root)
        for el in channel:
            n = _local(el.tag)
            if n == "title" and not feed.title:
                feed.title = _text(el)
            elif n == "item":
                item = FeedItem(url="")
                for f in el:
                    fn = _local(f.tag)
                    if fn == "link":
                        item.url = _text(f) or f.get("href", "")
                    elif fn == "title":
                        item.title = _text(f)
                    elif fn in ("pubdate", "date"):
                        item.published = _text(f)
                if item.url:
                    feed.items.append(item)
    elif tag == "feed":  # Atom
        for el in root:
            n = _local(el.tag)
            if n == "title" and not feed.title:
                feed.title = _text(el)
            elif n == "entry":
                item = FeedItem(url="")
                for f in el:
                    fn = _local(f.tag)
                    if fn == "link" and (f.get("rel") in (None, "alternate")):
                        item.url = f.get("href", "")
                    elif fn == "title":
                        item.title = _text(f)
                    elif fn in ("published", "updated"):
                        item.published = item.published or _text(f)
                if item.url:
                    feed.items.append(item)
    return feed
