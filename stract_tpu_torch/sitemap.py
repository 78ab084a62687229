"""Sitemap XML parsing — the port of stract_tpu/sitemap.py (role of
reference sitemap.rs): urlset + sitemapindex, read by the port's own
recovering XML reader (xml_recover.py) where the JAX package reads through
lxml in recover mode; the entries are the JAX package's."""

from __future__ import annotations

from dataclasses import dataclass

from .xml_recover import fromstring


@dataclass
class SitemapEntry:
    url: str
    lastmod: str = ""
    is_sitemap: bool = False  # nested sitemap index entry


def _local(tag) -> str:
    return tag.rsplit("}", 1)[-1].lower() if isinstance(tag, str) else ""


def parse_sitemap(content: str | bytes) -> list[SitemapEntry]:
    root = fromstring(content)
    if root is None:
        return []
    is_index = _local(root.tag) == "sitemapindex"
    out = []
    for el in root:
        if _local(el.tag) not in ("url", "sitemap"):
            continue
        loc, lastmod = "", ""
        for f in el:
            if _local(f.tag) == "loc":
                loc = "".join(f.itertext()).strip()
            elif _local(f.tag) == "lastmod":
                lastmod = "".join(f.itertext()).strip()
        if loc:
            out.append(SitemapEntry(loc, lastmod, is_sitemap=is_index))
    return out
