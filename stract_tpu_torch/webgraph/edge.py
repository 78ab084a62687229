"""Edges + rel flags (role of reference webgraph/edge.rs:31 SmallEdge{from,to,
rel_flags} and webpage/html/links.rs:56-173 RelFlags bitmask)."""

from __future__ import annotations

import enum
from dataclasses import dataclass


class RelFlags(enum.IntFlag):
    NONE = 0
    NOFOLLOW = 1 << 0
    SPONSORED = 1 << 1
    UGC = 1 << 2
    ALTERNATE = 1 << 3
    AUTHOR = 1 << 4
    BOOKMARK = 1 << 5
    CANONICAL = 1 << 6
    EXTERNAL = 1 << 7
    HELP = 1 << 8
    ICON = 1 << 9
    LICENSE = 1 << 10
    ME = 1 << 11
    NEXT = 1 << 12
    NOOPENER = 1 << 13
    NOREFERRER = 1 << 14
    OPENER = 1 << 15
    PINGBACK = 1 << 16
    PREV = 1 << 17
    PRIVACY_POLICY = 1 << 18
    SEARCH = 1 << 19
    STYLESHEET = 1 << 20
    TAG = 1 << 21
    TERMS_OF_SERVICE = 1 << 22
    IS_IN_FOOTER = 1 << 23
    IS_IN_NAVIGATION = 1 << 24
    LINK_TAG = 1 << 25
    SCRIPT_TAG = 1 << 26
    META_TAG = 1 << 27
    SAME_ICANN_DOMAIN = 1 << 28
    IMAGE = 1 << 29


@dataclass
class Edge:
    from_name: str
    to_name: str
    rel_flags: int = 0
    label: str = ""

    def to_json(self):
        return {"from": self.from_name, "to": self.to_name,
                "rel_flags": int(self.rel_flags), "label": self.label}

    @classmethod
    def from_json(cls, d):
        return cls(d["from"], d["to"], d.get("rel_flags", 0), d.get("label", ""))
