"""Per-site statistics job (role of reference entrypoint/site_stats.rs:
aggregates page counts, centrality and crawl health per site into a kv store,
used for crawl planning and ops)."""

from __future__ import annotations

from collections import defaultdict

from .kv import Db


def compute_site_stats(index, host_centrality: Db | None = None) -> dict:
    """index: InvertedIndex → {site: {pages, avg_fetch_ms, centrality, langs}}"""
    stats: dict = defaultdict(lambda: {"pages": 0, "langs": defaultdict(int)})
    for seg in index.segments:
        for doc_id in range(seg.num_docs):
            stored = seg.stored_doc(doc_id)
            site = stored.get("site", "")
            if not site:
                continue
            s = stats[site]
            s["pages"] += 1
            s["langs"][stored.get("lang", "en")] += 1
    out = {}
    for site, s in stats.items():
        entry = {
            "pages": s["pages"],
            "langs": dict(s["langs"]),
            "centrality": 0.0,
        }
        if host_centrality is not None:
            v = host_centrality.get(site.encode())
            if v:
                entry["centrality"] = v.get("centrality", 0.0)
        out[site] = entry
    return out


def run(index, output_path: str, host_centrality: Db | None = None) -> None:
    db = Db.open(output_path)
    for site, entry in compute_site_stats(index, host_centrality).items():
        db.insert(site.encode(), entry)
    db.commit()
