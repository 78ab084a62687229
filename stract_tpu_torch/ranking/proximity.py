"""Term-proximity (slop) signals (role of reference non_core/text.rs
MinTitleSlop / MinCleanBodySlop: minimal window slop of the query terms in the
title/body — coordinator-side, computed for the retrieved page only).

min_slop = (size of the smallest token window containing all query terms)
           − (number of query terms), or a large sentinel when not all terms
           appear. Score = 1 / (1 + slop)."""

from __future__ import annotations

from ..tokenizer import tokenize

MAX_SLOP = 1000.0


def min_slop(query_terms: list[str], text: str, max_tokens: int = 2000) -> float:
    terms = [t.lower() for t in query_terms]
    uniq = list(dict.fromkeys(terms))
    if not uniq or not text:
        return MAX_SLOP
    # truncate BEFORE tokenizing: the regex pass over a full stored document
    # costs more than the window scan itself (~15 chars/token upper bound)
    toks = tokenize(text[: max_tokens * 15])[:max_tokens]
    positions = {t: [] for t in uniq}
    for i, tok in enumerate(toks):
        if tok in positions:
            positions[tok].append(i)
    if any(not v for v in positions.values()):
        return MAX_SLOP
    if len(uniq) == 1:
        return 0.0

    # sliding minimal window over the merged position lists
    import heapq

    iters = {t: 0 for t in uniq}
    heap = [(positions[t][0], t) for t in uniq]
    heapq.heapify(heap)
    cur_max = max(p for p, _ in heap)
    best = MAX_SLOP
    while True:
        p, t = heapq.heappop(heap)
        best = min(best, (cur_max - p + 1) - len(uniq))
        iters[t] += 1
        if iters[t] >= len(positions[t]):
            break
        np_ = positions[t][iters[t]]
        cur_max = max(cur_max, np_)
        heapq.heappush(heap, (np_, t))
    return max(best, 0.0)


def slop_score(slop: float) -> float:
    return 1.0 / (1.0 + slop)
