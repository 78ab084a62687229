"""Webpage — a fetched page plus crawl metadata (role of reference
webpage/mod.rs:44 Webpage struct: html + centralities + fetch time + backlink
labels, converted into the index document)."""

from __future__ import annotations

from dataclasses import dataclass, field

from .html import Html


@dataclass
class Webpage:
    html: Html
    fetch_time_ms: int = 0
    last_updated: int = 0
    host_centrality: float = 0.0
    host_centrality_rank: int = 2**40
    page_centrality: float = 0.0
    page_centrality_rank: int = 2**40
    backlink_labels: list = field(default_factory=list)
    dmoz_description: str = ""
    keywords: list = field(default_factory=list)
    safety_classification: str = ""
    title_embedding: object = None
    keyword_embedding: object = None

    @classmethod
    def parse(cls, raw_html: str, url: str, **kw) -> "Webpage":
        return cls(html=Html.parse(raw_html, url), **kw)

    def as_document(self) -> dict:
        """The prepared dict SegmentBuilder.add consumes (role of
        Webpage::as_tantivy, webpage/mod.rs:169)."""
        doc = self.html.prepare(self.fetch_time_ms, self.last_updated)
        doc.update(
            host_centrality=self.host_centrality,
            host_centrality_rank=self.host_centrality_rank,
            page_centrality=self.page_centrality,
            page_centrality_rank=self.page_centrality_rank,
            dmoz_description=self.dmoz_description,
            keywords="\n".join(self.keywords),
            backlink_text=" ".join(self.backlink_labels[:32]),
        )
        # backlink label groups: labels spread over 10 fields by hash (reference
        # BacklinkLabelsGroup0-9, schema/text_field.rs:202-211)
        groups: dict[int, list] = {}
        for lb in self.backlink_labels:
            groups.setdefault(hash(lb) % 10, []).append(lb)
        for g, labels in groups.items():
            doc[f"backlink_labels_{g}"] = " ".join(labels[:16])
        if self.safety_classification:
            doc["safety_classification"] = self.safety_classification
        if self.title_embedding is not None:
            doc["title_embedding"] = self.title_embedding
        if self.keyword_embedding is not None:
            doc["keyword_embedding"] = self.keyword_embedding
        return doc
