"""Crawl planner — the port of stract_tpu/crawler/planner.py
(role of reference crawler/planner.rs:50-52: builds crawl
plans from harmonic centrality — per-domain budgets proportional to centrality,
jobs grouped into 1024 groups for distribution)."""

from __future__ import annotations

import math
import os
from collections import defaultdict

from .coordinator import Job

NUM_JOB_GROUPS = 1024  # planner.rs:50-52


def make_crawl_plan(
    host_centrality: dict[str, float],
    known_urls: dict[str, list],
    total_budget: int,
    wander_fraction: float = 0.2,
) -> list[Job]:
    """host_centrality: host → centrality; known_urls: host → urls.
    Budget split ∝ sqrt(centrality) with a floor of 1 per known host."""
    hosts = [h for h in known_urls if known_urls[h]]
    if not hosts:
        return []
    weights = {h: math.sqrt(max(host_centrality.get(h, 0.0), 0.0)) + 1e-9 for h in hosts}
    total_w = sum(weights.values())
    jobs = []
    for h in sorted(hosts, key=lambda x: -weights[x]):
        budget = max(int(total_budget * weights[h] / total_w), 1)
        urls = known_urls[h][:budget]
        wander = int(budget * wander_fraction)
        jobs.append(Job(domain=h, urls=urls, wandering_urls=wander))
    return jobs


def write_plan(jobs: list[Job], out_dir: str) -> list[str]:
    """Write jobs into NUM_JOB_GROUPS FileQueues (one per group)."""
    from .file_queue import FileQueue

    os.makedirs(out_dir, exist_ok=True)
    groups: dict[int, list] = defaultdict(list)
    for j in jobs:
        groups[hash(j.domain) % NUM_JOB_GROUPS].append(j)
    paths = []
    for g, js in groups.items():
        q = FileQueue(os.path.join(out_dir, f"group_{g:04d}"))
        q.push_many([j.to_json() for j in js])
        paths.append(q.path)
    return paths
