#!/usr/bin/env python3
"""Counts the posting rows K1 (stage A) reads for each query, E = sum_p
min(len_p, L) over the query's slots as the index builds them (build_slots,
then the impact prefix of InvertedIndex._augment_with_impact), and how many
queries' tables pass what a thread block cluster's shared memory holds (K1's
global form, ops/kernels.py stage_a_plan), on the bench corpus:

    python3 scripts/stage_a_entries.py [--docs 1000000] [--queries 2000] [--seed 0]

Query sets: the bench sampler's (bench_corpus.sample_queries: a head term of
the 300 most common and a term of the next 19,700), and n-term queries of
head terms only, n = 2, 3, 4, 6, 8 (the most rows a query of n terms can
reach). The corpus is built once under data/kernel_times_corpus (the one
scripts/kernel_times.py reads) and opened on the CPU: no card is needed.
Prints one JSON line a set: its slot buckets (P), the used slots a query,
E's quantiles, the largest E that stays in shared memory and the share of
queries past it.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEAD_TERMS, MID_TERMS = 300, 20_000
HEAD_ONLY_TERMS = (2, 3, 4, 6, 8)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--L", type=int, default=1024)
    ap.add_argument("--C", type=int, default=4096)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import numpy as np

    from stract_tpu_torch import bench_corpus as bc
    from stract_tpu_torch.index.inverted import InvertedIndex
    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch.ops import scoring as O
    from stract_tpu_torch.ranking.computer import QueryContext, build_slots

    path = bc.ensure_corpus(os.path.join(ROOT, "data", "kernel_times_corpus"), args.docs,
                            seed=0, log=lambda *a: None)
    index = InvertedIndex(path, "cpu")
    seg = index.segments[0]
    dev = index.device_segment_for(seg)
    # the largest E whose table some cluster holds in shared memory
    lo, hi = 1, 1 << 24
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if kernels.stage_a_plan(mid, 1, args.C, 132).form == "global":
            hi = mid - 1
        else:
            lo = mid
    cap = lo
    rng = np.random.default_rng(args.seed)
    sets = [("sampler", bc.sample_queries(rng, args.queries))]
    for n in HEAD_ONLY_TERMS:
        sets.append((f"head_{n}", [" ".join(bc.token_of(int(t)) for t in
                                            rng.choice(HEAD_TERMS, n, replace=False))
                                   for _ in range(args.queries)]))
    for name, queries in sets:
        entries, used, buckets = [], [], {}
        for q in queries:
            ctx = QueryContext(raw=q, simple_terms=q.split(), current_ts=1.7e9)
            slots, _ = build_slots(ctx, seg, index.num_docs, index.region_scores())
            qa = InvertedIndex._augment_with_impact(seg, dev, slots, args.L)[0]
            lens = np.asarray(qa.lens)
            entries.append(int(O.stage_a_entries(lens, args.L)[0]))
            used.append(int((lens > 0).sum()))
            buckets[int(lens.shape[0])] = buckets.get(int(lens.shape[0]), 0) + 1
        e = np.array(entries)
        print(json.dumps({
            "set": name, "queries": len(queries), "docs": args.docs, "L": args.L,
            "P": buckets, "used_slots": [int(min(used)), float(np.mean(used)), int(max(used))],
            "E_quantiles": {str(p): int(np.percentile(e, p)) for p in (0, 50, 90, 99, 100)},
            "shared_cap": cap, "past_cap": int((e > cap).sum()),
            "past_cap_share": float((e > cap).mean())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
