"""Betweenness centrality — the port's copy of stract_tpu/webgraph/betweenness.py
(role of reference webgraph/centrality/betweenness.rs).

Brandes' algorithm, host-side (the reference computes it in-process too; it is
an offline analytics job, not a query-time path). `num_samples` approximates
on large graphs by accumulating from that many sources drawn by
np.random.default_rng(seed), scaled by N/k."""

from __future__ import annotations

from collections import deque

import numpy as np

from .store import Webgraph


def betweenness_centrality(
    graph: Webgraph, num_samples: int | None = None, seed: int = 0
) -> dict[str, float]:
    n = graph.num_nodes
    if n == 0:
        return {}
    out_off = np.asarray(graph.out_offsets, dtype=np.int64)
    tgt = np.asarray(graph.out_targets, dtype=np.int64)
    adj = [tgt[out_off[i] : out_off[i + 1]] for i in range(n)]

    if num_samples is None or num_samples >= n:
        sources = range(n)
        scale = 1.0
    else:
        rng = np.random.default_rng(seed)
        sources = rng.choice(n, size=num_samples, replace=False)
        scale = n / num_samples

    bc = np.zeros(n)
    for s in sources:
        # single-source shortest-path counts (BFS, unweighted)
        sigma = np.zeros(n)
        sigma[s] = 1.0
        dist = -np.ones(n, dtype=np.int64)
        dist[s] = 0
        preds: list[list[int]] = [[] for _ in range(n)]
        order = []
        q = deque([s])
        while q:
            v = q.popleft()
            order.append(v)
            for w in adj[v]:
                w = int(w)
                if dist[w] < 0:
                    dist[w] = dist[v] + 1
                    q.append(w)
                if dist[w] == dist[v] + 1:
                    sigma[w] += sigma[v]
                    preds[w].append(v)
        # back-propagation of dependencies
        delta = np.zeros(n)
        for w in reversed(order):
            for v in preds[w]:
                delta[v] += sigma[v] / sigma[w] * (1.0 + delta[w])
            if w != s:
                bc[w] += delta[w]
    bc *= scale
    norm = max((n - 1) * (n - 2), 1)
    return {graph.name_of(i): float(bc[i]) / norm for i in range(n)}
