"""Crawl coordinator — the port of stract_tpu/crawler/coordinator.py
(role of reference crawler/coordinator.rs:20-31: pops jobs
from an on-disk FileQueue and hands them to workers via the router; tracks
urls discovered at crawl time for future plans)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..kv import Db
from .file_queue import FileQueue


@dataclass
class UrlToInsert:
    url: str
    weight: float = 0.0

    def to_json(self):
        return {"url": self.url, "weight": self.weight}


@dataclass
class Job:
    """A site-exclusive crawl job (politeness: one worker per site at a time,
    docs/architecture/crawler.md:4-14)."""

    domain: str
    urls: list = field(default_factory=list)
    wandering_urls: int = 0  # budget for crawl-time discovered urls

    def to_json(self):
        return {"domain": self.domain, "urls": self.urls, "wandering_urls": self.wandering_urls}

    @classmethod
    def from_json(cls, d):
        return cls(d["domain"], d.get("urls", []), d.get("wandering_urls", 0))


class CrawlCoordinator:
    """RPC service: workers (via the router) call new_job; finished crawls
    report discovered urls for the next plan."""

    def __init__(self, queue_path: str, discovered_db_path: str | None = None):
        self.queue = FileQueue(queue_path)
        self.discovered = Db.open(discovered_db_path) if discovered_db_path else None

    def add_jobs(self, jobs: list[Job]) -> None:
        self.queue.push_many([j.to_json() for j in jobs])

    # -- RPC methods ----------------------------------------------------------
    def new_job(self, body=None):
        j = self.queue.pop()
        return j  # None → crawl done

    def add_urls(self, body: dict):
        """Record crawl-time discovered urls (wander candidates for next plan)."""
        if self.discovered is not None:
            for u in body.get("urls", []):
                prev = self.discovered.get(u["url"].encode()) or 0.0
                self.discovered.insert(u["url"].encode(), prev + u.get("weight", 0.0))
            self.discovered.commit()
        return True

    def remaining(self, body=None) -> int:
        return len(self.queue)
