"""Canonical-URL index (role of reference canon_index.rs + entrypoint/
canonical.rs: url → canonical url mapping in a speedy-kv store, built from
rel=canonical links at parse time, consulted at indexing to dedup)."""

from __future__ import annotations

from .kv import Db


class CanonicalIndex:
    def __init__(self, path: str):
        self.db = Db.open(path)

    def insert(self, url: str, canonical: str) -> None:
        if url != canonical:
            self.db.insert(url.encode(), canonical)

    def commit(self) -> None:
        self.db.commit()

    def canonical_of(self, url: str) -> str:
        """Resolves chains up to depth 4."""
        cur = url
        for _ in range(4):
            nxt = self.db.get(cur.encode())
            if nxt is None or nxt == cur:
                return cur
            cur = nxt
        return cur

    def is_canonical(self, url: str) -> bool:
        return self.canonical_of(url) == url


def build_from_warcs(warc_paths: list, output_path: str) -> CanonicalIndex:
    """(role of entrypoint/canonical.rs run)"""
    from .warc import WarcReader
    from .webpage.html import Html
    from .webgraph.edge import RelFlags

    ci = CanonicalIndex(output_path)
    for path in warc_paths:
        for rec in WarcReader.open(path):
            html = Html.parse(rec.text(), rec.url)
            for link in html.links():
                if link.rel_flags & RelFlags.CANONICAL:
                    ci.insert(rec.url, link.destination)
                    break
    ci.commit()
    return ci
