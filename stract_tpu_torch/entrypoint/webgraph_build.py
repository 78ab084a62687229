"""Webgraph construction from WARCs (role of reference entrypoint/webgraph.rs:
`webgraph create` extracts links from crawled pages into host/page graphs)."""

from __future__ import annotations

from ..warc import WarcReader
from ..webgraph import Edge, WebgraphBuilder
from ..webgraph.edge import RelFlags
from ..webpage.html import Html

# links that don't convey endorsement are excluded from the centrality graph
SKIP_FLAGS = int(RelFlags.NOFOLLOW) | int(RelFlags.SPONSORED) | int(RelFlags.UGC) | int(
    RelFlags.LINK_TAG
) | int(RelFlags.STYLESHEET) | int(RelFlags.ICON)


def build_from_warcs(warc_paths: list[str], output_path: str, level: str = "host"):
    """level: 'host' (host-level graph) or 'page'."""
    b = WebgraphBuilder(host_graph=(level == "host"))
    for path in warc_paths:
        for rec in WarcReader.open(path):
            html = Html.parse(rec.text(), rec.url)
            for link in html.links():
                if link.rel_flags & SKIP_FLAGS:
                    continue
                b.insert(Edge(link.source, link.destination, link.rel_flags, link.text))
    return b.build(output_path)
