"""DDG-style bang redirects (role of reference bangs.rs).

Loads the bangs.json format the reference's `configure` downloads
(entries like {"t": "g", "u": "https://google.com/search?q={{{s}}}"}), with a
small built-in fallback set."""

from __future__ import annotations

import json
import urllib.parse
from dataclasses import dataclass

BANG_PREFIX = "!"

_BUILTIN = [
    {"t": "g", "u": "https://www.google.com/search?q={{{s}}}"},
    {"t": "w", "u": "https://en.wikipedia.org/wiki/Special:Search?search={{{s}}}"},
    {"t": "gh", "u": "https://github.com/search?q={{{s}}}"},
    {"t": "yt", "u": "https://www.youtube.com/results?search_query={{{s}}}"},
    {"t": "ddg", "u": "https://duckduckgo.com/?q={{{s}}}"},
]


@dataclass
class BangHit:
    bang: str
    redirect_to: str

    def to_json(self):
        return {"bang": self.bang, "redirectTo": self.redirect_to}


class Bangs:
    def __init__(self, entries: list[dict]):
        self.by_tag = {e["t"]: e for e in entries}

    @classmethod
    def from_path(cls, path: str) -> "Bangs":
        with open(path) as fh:
            return cls(json.load(fh))

    @classmethod
    def builtin(cls) -> "Bangs":
        return cls(list(_BUILTIN))

    def get(self, query) -> BangHit | None:
        """query: parsed Query (query/query.py). First matching bang wins."""
        for tag in query.bangs:
            entry = self.by_tag.get(tag.lower())
            if entry is None:
                continue
            rest = " ".join(query.simple_terms)
            url = entry["u"].replace("{{{s}}}", urllib.parse.quote_plus(rest))
            if not url.startswith(("http://", "https://")):
                url = "https://" + url
            return BangHit(bang=tag, redirect_to=url)
        return None
