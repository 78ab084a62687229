"""Live crawler — the port of stract_tpu/live_index/crawler.py (role of
reference live_index/crawler/: per-site checkers — Feeds / Sitemap /
Frontpage — on check intervals, fetch new urls, push IndexWebpages to
live-index shards, ShardedCrawledDb dedup). Feeds and sitemaps parse on the
port's recovering XML reader (feed.py, sitemap.py), front pages on its
page parser (webpage/html.py); host work all."""

from __future__ import annotations

import time
import urllib.parse
from dataclasses import dataclass, field

from ..feed import parse_feed
from ..sitemap import parse_sitemap
from ..kv import Db

CHECK_INTERVALS = {"feeds": 600.0, "sitemap": 3600.0, "frontpage": 1800.0}


@dataclass
class SiteChecker:
    site: str
    feeds: list = field(default_factory=list)
    sitemaps: list = field(default_factory=list)
    last_checked: dict = field(default_factory=lambda: {"feeds": 0.0, "sitemap": 0.0, "frontpage": 0.0})

    def due(self, kind: str, now: float) -> bool:
        return now - self.last_checked.get(kind, 0.0) >= CHECK_INTERVALS[kind]


class LiveCrawler:
    """Discovers fresh urls per site and indexes them into a LiveIndex (or
    pushes to live-index shards via an index_fn)."""

    def __init__(self, fetch_fn, index_fn, crawled_db: Db | None = None, clock=time.time):
        """fetch_fn(url) → (status, body, ms); index_fn(list[(url, html)]) indexes."""
        self.fetch = fetch_fn
        self.index_fn = index_fn
        self.crawled = crawled_db
        self.clock = clock
        self.checkers: dict[str, SiteChecker] = {}

    def add_site(self, site: str, feeds=(), sitemaps=()) -> SiteChecker:
        c = SiteChecker(site, list(feeds), list(sitemaps))
        self.checkers[site] = c
        return c

    def _already_crawled(self, url: str) -> bool:
        if self.crawled is None:
            return False
        if url.encode() in self.crawled:
            return True
        self.crawled.insert(url.encode(), int(self.clock()))
        return False

    def _check_feeds(self, c: SiteChecker) -> list[str]:
        urls = []
        for feed_url in c.feeds:
            status, body, _ = self.fetch(feed_url)
            if status != 200:
                continue
            for item in parse_feed(body).items:
                urls.append(item.url)
        return urls

    def _check_sitemaps(self, c: SiteChecker) -> list[str]:
        urls = []
        for sm_url in list(c.sitemaps)[:8]:
            status, body, _ = self.fetch(sm_url)
            if status != 200:
                continue
            for e in parse_sitemap(body)[:500]:
                if e.is_sitemap:
                    c.sitemaps.append(e.url)
                else:
                    urls.append(e.url)
        return urls

    def _check_frontpage(self, c: SiteChecker) -> list[str]:
        from ..webpage.html import Html

        status, body, _ = self.fetch(f"https://{c.site}/")
        if status != 200:
            return []
        html = Html.parse(body, f"https://{c.site}/")
        urls = []
        for link in html.links()[:100]:
            host = urllib.parse.urlparse(link.destination).netloc.lower().removeprefix("www.")
            if host == c.site:
                urls.append(link.destination)
        return urls

    def tick(self) -> int:
        """One scheduling round: check due sites, fetch + index new urls."""
        now = self.clock()
        indexed = 0
        for c in self.checkers.values():
            new_urls: list[str] = []
            for kind, check in (
                ("feeds", self._check_feeds),
                ("sitemap", self._check_sitemaps),
                ("frontpage", self._check_frontpage),
            ):
                if c.due(kind, now):
                    new_urls.extend(check(c))
                    c.last_checked[kind] = now
            batch = []
            for url in dict.fromkeys(new_urls):
                if self._already_crawled(url):
                    continue
                status, body, _ = self.fetch(url)
                if status == 200 and body:
                    batch.append((url, body))
            if batch:
                self.index_fn(batch)
                indexed += len(batch)
        if self.crawled is not None:
            self.crawled.commit()
        return indexed
