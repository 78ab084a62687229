"""External-SERP scraper for auto-annotation — the port's copy of
stract_tpu/leechy.py (role of reference crates/leechy: queries configured
external engines and extracts result urls via XPath,
leechy/src/engine.rs:24-40; learning to rank uses it to bootstrap training
judgments).

fetch_fn is injectable (zero-egress environments / tests). Extracting a
page's results evaluates the engine's XPath with lxml, as the JAX package
does; the module imports it only then."""

from __future__ import annotations

import urllib.parse
from dataclasses import dataclass


@dataclass
class Engine:
    name: str
    search_url: str            # {query} placeholder
    result_xpath: str          # xpath returning result <a> hrefs

    def query_url(self, query: str) -> str:
        return self.search_url.replace("{query}", urllib.parse.quote_plus(query))

    def extract(self, html: str) -> list[str]:
        import lxml.html  # XPath: only where an engine is queried

        try:
            root = lxml.html.fromstring(html)
        except (ValueError, lxml.etree.ParserError):
            return []
        urls = []
        for el in root.xpath(self.result_xpath):
            href = el.get("href") if hasattr(el, "get") else str(el)
            if href and href.startswith(("http://", "https://")):
                urls.append(href)
        return urls


DEFAULT_ENGINES = [
    Engine("ddg-html", "https://html.duckduckgo.com/html/?q={query}",
           "//a[contains(@class,'result__a')]"),
    Engine("mojeek", "https://www.mojeek.com/search?q={query}",
           "//a[contains(@class,'title')]"),
]


class Leechy:
    def __init__(self, fetch_fn, engines: list[Engine] | None = None):
        self.fetch = fetch_fn
        self.engines = engines or list(DEFAULT_ENGINES)

    def results(self, query: str, top_k: int = 10) -> list[str]:
        for engine in self.engines:
            status, body, _ = self.fetch(engine.query_url(query))
            if status != 200 or not body:
                continue
            urls = engine.extract(body)
            if urls:
                return urls[:top_k]
        return []

    def annotate(self, queries: list[str], top_k: int = 10) -> dict:
        """query → {url: graded relevance} with rank-decayed grades (role of
        ltr/auto_annotate.py)."""
        out = {}
        for q in queries:
            urls = self.results(q, top_k)
            out[q] = {u: max(top_k - i, 1) / top_k * 4.0 for i, u in enumerate(urls)}
        return out
