"""Indexer pipeline — the port of stract_tpu/entrypoint/indexer.py (role of
reference entrypoint/indexer/mod.rs:43 run + worker.rs:268
IndexingWorker::process).

Per WARC file: parse HTML → prepared doc, attach host/page centralities (kv
stores from the centrality jobs), safety classification, RAKE keywords,
dual-encoder title/keyword embeddings (batched through the port's
DualEncoder.embed, on the card the encoder was loaded onto), backlink text
from the webgraph — then insert into an InvertedIndex segment, one segment a
WARC file, merged into one at the end (indexer/mod.rs:92-144). Parsing and
the segment writes run on the host; the segments it writes are the JAX
package's, byte for byte."""

from __future__ import annotations

import os
import time

from ..index.inverted import InvertedIndex
from ..keywords import rake_keywords
from ..kv import Db
from ..warc import WarcReader
from ..webpage.core import Webpage
from ..webpage.html import Html


class IndexingWorker:
    def __init__(
        self,
        host_centrality: Db | None = None,
        page_centrality: Db | None = None,
        safety_classifier=None,
        dual_encoder=None,
        webgraph=None,
        embedding_batch: int = 32,
    ):
        self.host_centrality = host_centrality
        self.page_centrality = page_centrality
        self.safety = safety_classifier
        self.dual_encoder = dual_encoder
        self.webgraph = webgraph
        self.embedding_batch = embedding_batch

    def _centrality(self, db: Db | None, key: str) -> tuple[float, int]:
        if db is None:
            return 0.0, 2**40
        v = db.get(key.encode())
        if v is None:
            return 0.0, 2**40
        return float(v.get("centrality", 0.0)), int(v.get("rank", 2**40))

    def prepare(self, html_raw: str, url: str, fetch_time_ms: int = 0, last_updated: int = 0) -> dict | None:
        html = Html.parse(html_raw, url)
        if html.is_no_index():
            return None
        page = Webpage(html=html, fetch_time_ms=fetch_time_ms, last_updated=last_updated)
        page.host_centrality, page.host_centrality_rank = self._centrality(self.host_centrality, html.host)
        page.page_centrality, page.page_centrality_rank = self._centrality(
            self.page_centrality, url
        )
        if self.webgraph is not None:
            page.backlink_labels = self.webgraph.backlink_labels(html.host)

        doc = page.as_document()
        doc["keywords"] = "\n".join(rake_keywords(doc["clean_text"], doc["lang"]))
        if self.safety is not None:
            doc["safety_classification"] = self.safety.classify_webpage(doc)
        return doc

    def attach_embeddings(self, docs: list[dict]) -> None:
        """Batch dual-encoder embeddings for titles + keywords (role of
        worker.rs:389,451 set_title_embeddings/set_keyword_embeddings)."""
        if self.dual_encoder is None:
            return
        titles = [d.get("title", "") for d in docs]
        keywords = [d.get("keywords", "").replace("\n", " ") for d in docs]
        t = self.dual_encoder.embed(titles)
        k = self.dual_encoder.embed(keywords)
        for i, d in enumerate(docs):
            d["title_embedding"] = t[i]
            d["keyword_embedding"] = k[i]

    def process_warc(self, warc_path: str, index: InvertedIndex) -> int:
        batch: list[dict] = []
        n = 0

        def flush():
            nonlocal n
            self.attach_embeddings(batch)
            for d in batch:
                index.insert(d)
                n += 1
            batch.clear()

        for rec in WarcReader.open(warc_path):
            t0 = time.perf_counter()
            doc = self.prepare(rec.text(), rec.url)
            if doc is None:
                continue
            doc["fetch_time_ms"] = doc["fetch_time_ms"] or int((time.perf_counter() - t0) * 1000)
            batch.append(doc)
            if len(batch) >= self.embedding_batch:
                flush()
        flush()
        return n


def run(
    warc_paths: list[str],
    output_path: str,
    worker: IndexingWorker | None = None,
    embedding_dim: int = 0,
    merge: bool = True,
    device="cuda",
) -> InvertedIndex:
    """Build an index from WARC files (role of indexer::run,
    entrypoint/indexer/mod.rs:43): one segment per WARC, merged at the end.
    `device` is the returned index's search device (the writes use none)."""
    worker = worker or IndexingWorker()
    index = InvertedIndex(output_path, device, embedding_dim=embedding_dim)
    for path in warc_paths:
        worker.process_warc(path, index)
        index.commit()
    if merge:
        index.merge_all()
    return index
