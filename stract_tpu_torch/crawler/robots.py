"""robots.txt parser/matcher — the port of stract_tpu/crawler/robots.py
(role of reference crates/robotstxt, 2,122 LoC —
RFC 9309 compliant).

Implements the RFC 9309 rules: longest-match precedence, allow wins ties,
`*` wildcards and `$` end anchors, user-agent group selection with most-specific
agent match, crawl-delay and sitemaps extensions."""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from urllib.parse import unquote


@dataclass
class _Group:
    agents: list = field(default_factory=list)
    rules: list = field(default_factory=list)  # (allow: bool, pattern: str)
    crawl_delay: float | None = None


def _pattern_matches(pattern: str, path: str) -> int:
    """→ match length for precedence, or -1 if no match. Supports * and $."""
    anchored = pattern.endswith("$")
    if anchored:
        pattern = pattern[:-1]
    parts = [re.escape(p) for p in pattern.split("*")]
    rx = ".*".join(parts)
    rx = "^" + rx + ("$" if anchored else "")
    m = re.match(rx, path)
    if m is None:
        return -1
    return len(pattern)


class Robots:
    def __init__(self, groups: list[_Group], sitemaps: list[str]):
        self.groups = groups
        self.sitemaps = sitemaps

    @classmethod
    def parse(cls, content: str) -> "Robots":
        groups: list[_Group] = []
        sitemaps: list[str] = []
        cur: _Group | None = None
        last_was_agent = False
        for raw_line in content.splitlines():
            line = raw_line.split("#", 1)[0].strip()
            if not line or ":" not in line:
                continue
            key, val = line.split(":", 1)
            key = key.strip().lower()
            val = val.strip()
            if key == "user-agent":
                if cur is None or not last_was_agent:
                    cur = _Group()
                    groups.append(cur)
                cur.agents.append(val.lower())
                last_was_agent = True
                continue
            last_was_agent = False
            if key == "sitemap":
                sitemaps.append(val)
                continue
            if cur is None:
                continue
            if key == "allow":
                cur.rules.append((True, val))
            elif key == "disallow":
                cur.rules.append((False, val))
            elif key == "crawl-delay":
                try:
                    cur.crawl_delay = float(val)
                except ValueError:
                    pass
        return cls(groups, sitemaps)

    def _group_for(self, user_agent: str) -> _Group | None:
        ua = user_agent.lower()
        best, best_len = None, -1
        for g in self.groups:
            for agent in g.agents:
                if agent == "*":
                    if best_len < 0:
                        best, best_len = g, 0
                elif agent in ua and len(agent) > best_len:
                    best, best_len = g, len(agent)
        return best

    def is_allowed(self, user_agent: str, path: str) -> bool:
        g = self._group_for(user_agent)
        if g is None:
            return True
        path = unquote(path) or "/"
        best_len, best_allow = -1, True
        for allow, pattern in g.rules:
            if pattern == "" and not allow:
                continue  # empty disallow = allow all
            ml = _pattern_matches(unquote(pattern), path)
            if ml > best_len or (ml == best_len and allow and not best_allow):
                if ml >= 0:
                    best_len, best_allow = ml, allow
        return best_allow if best_len >= 0 else True

    def crawl_delay(self, user_agent: str) -> float | None:
        g = self._group_for(user_agent)
        return g.crawl_delay if g else None
