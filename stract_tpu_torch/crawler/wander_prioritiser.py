"""Wander prioritization — the port of stract_tpu/crawler/wander_prioritiser.py
(role of reference crawler/wander_prioritiser.rs):
crawl-time discovered same-site urls, ranked by how often they were seen."""

from __future__ import annotations

import urllib.parse
from collections import Counter


class WanderPrioritiser:
    def __init__(self):
        self.counts: Counter = Counter()
        self.popped: set[str] = set()

    def observe(self, url: str, weight: float = 1.0) -> None:
        self.counts[url] += weight

    def pop_best(self, domain: str) -> str | None:
        best = None
        for url, _ in self.counts.most_common():
            if url in self.popped:
                continue
            host = urllib.parse.urlparse(url).netloc.lower().removeprefix("www.")
            if host == domain or host.endswith("." + domain):
                best = url
                break
        if best is not None:
            self.popped.add(best)
        return best
