"""HTML processing — the port of stract_tpu/webpage/html.py (role of
reference webpage/html/mod.rs:47-55 Html::parse + links.rs link/RelFlags
extraction + into_tantivy.rs field population).

Parses with the port's element tree (webpage/tree.py: html.parser shaped as
lxml.html builds its tree, since the card's machine has no lxml), extracts
main text (just_text.py), links with rel flags, schema.org entities,
microformats, robots meta, region — and produces the prepared document dict
the index builder consumes (index/segment.py SegmentBuilder.add)."""

from __future__ import annotations

import json
import re
import time
from dataclasses import dataclass, field
from urllib.parse import urljoin, urlparse

from ..utils.hashing import prehash
from ..webgraph.edge import RelFlags
from . import adservers, schema_org, tree
from .just_text import extract_paragraphs
from .region import Region, detect_lang

MICROFORMATS = ["h-card", "h-entry", "h-feed", "h-event", "h-review", "h-recipe", "h-product"]

_REL_MAP = {
    "nofollow": RelFlags.NOFOLLOW,
    "sponsored": RelFlags.SPONSORED,
    "ugc": RelFlags.UGC,
    "alternate": RelFlags.ALTERNATE,
    "author": RelFlags.AUTHOR,
    "bookmark": RelFlags.BOOKMARK,
    "canonical": RelFlags.CANONICAL,
    "external": RelFlags.EXTERNAL,
    "help": RelFlags.HELP,
    "icon": RelFlags.ICON,
    "license": RelFlags.LICENSE,
    "me": RelFlags.ME,
    "next": RelFlags.NEXT,
    "noopener": RelFlags.NOOPENER,
    "noreferrer": RelFlags.NOREFERRER,
    "opener": RelFlags.OPENER,
    "pingback": RelFlags.PINGBACK,
    "prev": RelFlags.PREV,
    "privacy-policy": RelFlags.PRIVACY_POLICY,
    "search": RelFlags.SEARCH,
    "stylesheet": RelFlags.STYLESHEET,
    "tag": RelFlags.TAG,
    "terms-of-service": RelFlags.TERMS_OF_SERVICE,
}


@dataclass
class Link:
    source: str
    destination: str
    text: str = ""
    rel_flags: int = 0


def _icann_domain(host: str) -> str:
    parts = host.lower().split(".")
    return ".".join(parts[-2:]) if len(parts) >= 2 else host


class Html:
    def __init__(self, raw: str, url: str):
        self.raw = raw
        self.url = url
        p = urlparse(url)
        self.site = p.netloc.lower()
        host = self.site[4:] if self.site.startswith("www.") else self.site
        self.host = host
        self.domain = _icann_domain(host)
        self.path = p.path or "/"
        self.query = p.query
        try:
            self.root = tree.fromstring(raw or "<html></html>")
        except ValueError:  # tree.ParserError included: lxml's two refusals
            self.root = tree.fromstring("<html></html>")

    @classmethod
    def parse(cls, raw: str, url: str) -> "Html":
        return cls(raw, url)

    # -- basic fields -------------------------------------------------------------
    def title(self) -> str:
        el = self.root.find(".//title")
        return " ".join((el.text or "").split()) if el is not None else ""

    def _heads(self, tag: str) -> list[str]:
        return [" ".join("".join(h.itertext()).split()) for h in self.root.iter(tag)]

    def first_h1(self) -> str:
        hs = self._heads("h1")
        return hs[0] if hs else ""

    def description(self) -> str:
        for el in self.root.iter("meta"):
            name = (el.get("name") or el.get("property") or "").lower()
            if name in ("description", "og:description"):
                return el.get("content") or ""
        return ""

    def lang(self) -> str:
        hint = self.root.get("lang") or ""
        clean, _, _ = self._text_cache()
        return detect_lang(" ".join(clean[:20]), hint)

    def region(self) -> Region:
        return Region.from_lang(self.lang())

    def _text_cache(self):
        if not hasattr(self, "_texts"):
            hint = self.root.get("lang") or "en"
            self._texts = extract_paragraphs(self.root, detect_lang("", hint) or "en")
        return self._texts

    def clean_text(self) -> str:
        clean, _, _ = self._text_cache()
        return "\n".join(clean)

    def all_text(self) -> str:
        _, everything, _ = self._text_cache()
        return "\n".join(everything)

    def link_density(self) -> float:
        _, _, ld = self._text_cache()
        return ld

    # -- robots meta (role of webpage robots meta handling) -------------------------
    def robots_meta(self) -> set[str]:
        out = set()
        for el in self.root.iter("meta"):
            if (el.get("name") or "").lower() == "robots":
                out.update(t.strip().lower() for t in (el.get("content") or "").split(","))
        return out

    def is_no_index(self) -> bool:
        return "noindex" in self.robots_meta()

    # -- links (role of webpage/html/links.rs:56-173) ---------------------------------
    def links(self) -> list[Link]:
        out = []
        for a in self.root.iter("a"):
            href = a.get("href")
            if not href or href.startswith(("#", "javascript:", "mailto:", "tel:")):
                continue
            dest = urljoin(self.url, href)
            if not dest.startswith(("http://", "https://")):
                continue
            flags = 0
            for rel in (a.get("rel") or "").lower().split():
                flags |= int(_REL_MAP.get(rel, 0))
            cur = a.getparent()
            while cur is not None:
                t = str(cur.tag).lower() if isinstance(cur.tag, str) else ""
                if t == "footer":
                    flags |= int(RelFlags.IS_IN_FOOTER)
                elif t == "nav":
                    flags |= int(RelFlags.IS_IN_NAVIGATION)
                cur = cur.getparent()
            if any(isinstance(ch.tag, str) and ch.tag.lower() == "img" for ch in a.iter()):
                flags |= int(RelFlags.IMAGE)
            dest_host = urlparse(dest).netloc.lower()
            if _icann_domain(dest_host) == self.domain:
                flags |= int(RelFlags.SAME_ICANN_DOMAIN)
            text = " ".join("".join(a.itertext()).split())
            out.append(Link(self.url, dest, text, flags))
        for l in self.root.iter("link"):
            href = l.get("href")
            if not href:
                continue
            dest = urljoin(self.url, href)
            if not dest.startswith(("http://", "https://")):
                continue
            flags = int(RelFlags.LINK_TAG)
            for rel in (l.get("rel") or "").lower().split():
                flags |= int(_REL_MAP.get(rel, 0))
            out.append(Link(self.url, dest, "", flags))
        return out

    def resource_urls(self) -> list[str]:
        urls = []
        for el in self.root.iter("script"):
            if el.get("src"):
                urls.append(urljoin(self.url, el.get("src")))
        for el in self.root.iter("img"):
            if el.get("src"):
                urls.append(urljoin(self.url, el.get("src")))
        for el in self.root.iter("iframe"):
            if el.get("src"):
                urls.append(urljoin(self.url, el.get("src")))
        return urls

    # -- structured data ------------------------------------------------------------
    def schema_org(self) -> list[dict]:
        return schema_org.parse_json_ld(self.root) + schema_org.parse_microdata(self.root)

    def microformats(self) -> list[str]:
        found = set()
        for el in self.root.iter():
            classes = (el.get("class") or "").split()
            for mf in MICROFORMATS:
                if mf in classes:
                    found.add(mf)
        return sorted(found)

    def likely_has_paywall(self) -> bool:
        for it in self.schema_org():
            v = it.get("isAccessibleForFree")
            if str(v).lower() in ("false", "no", "0"):
                return True
        return bool(re.search(r"class=[\"'][^\"']*paywall", self.raw[:200_000], re.I))

    def trackers(self) -> int:
        return adservers.count_trackers(self.resource_urls())

    def is_homepage(self) -> bool:
        return self.path in ("", "/") and not self.query

    # -- prepared document (role of into_tantivy.rs:203) ------------------------------
    def prepare(self, fetch_time_ms: int = 0, last_updated: int = 0) -> dict:
        lang = self.lang()
        items = self.schema_org()
        flattened = "\n".join(schema_org.flatten(items))
        url_no_query = self.url.split("?")[0]
        title = self.title()
        path_q = self.path + (("?" + self.query) if self.query else "")
        doc = {
            "url": self.url,
            "title": title,
            "clean_text": self.clean_text(),
            "all_text": self.all_text(),
            "site": self.host,
            "domain": self.domain,
            "domain_name": self.domain.split(".")[0],
            "description": self.description(),
            "schema_org_json": json.dumps(items) if items else "",
            "flattened_schema_org": flattened,
            "microformats": " ".join(self.microformats()),
            "first_h1": self.first_h1(),
            "all_h2": "\n".join(self._heads("h2")),
            "all_h3": "\n".join(self._heads("h3")),
            "recipe_first_ingredient_tag_id": schema_org.first_ingredient_tag_id(items),
            "insertion_timestamp": str(int(time.time())),
            "links": "\n".join(l.destination for l in self.links()[:200]),
            "lang": lang,
            # numeric columns
            "is_homepage": self.is_homepage(),
            "region": int(self.region()),
            "fetch_time_ms": fetch_time_ms,
            "last_updated": last_updated,
            "tracker_score": self.trackers(),
            "likely_has_ads": adservers.likely_has_ads(self.resource_urls()),
            "likely_has_paywall": self.likely_has_paywall(),
            "link_density": self.link_density(),
            "num_path_and_query_slashes": path_q.count("/"),
            "num_path_and_query_digits": sum(c.isdigit() for c in path_q),
            "site_hash1": prehash("sh1:" + self.host),
            "site_hash2": prehash("sh2:" + self.host),
            "url_without_query_hash1": prehash("uq1:" + url_no_query),
            "url_without_query_hash2": prehash("uq2:" + url_no_query),
            "title_hash1": prehash("th1:" + title),
            "title_hash2": prehash("th2:" + title),
            "url_hash1": prehash("uh1:" + self.url),
            "url_hash2": prehash("uh2:" + self.url),
            "domain_hash1": prehash("dh1:" + self.domain),
            "domain_hash2": prehash("dh2:" + self.domain),
            "url_without_tld_hash1": prehash("ut1:" + self.host.rsplit(".", 1)[0] + self.path),
            "url_without_tld_hash2": prehash("ut2:" + self.host.rsplit(".", 1)[0] + self.path),
            "host_node_id": prehash(self.host),
        }
        from ..utils.simhash import simhash_text

        doc["sim_hash"] = simhash_text(doc["clean_text"]) or simhash_text(title)
        return doc
