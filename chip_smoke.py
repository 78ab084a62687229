"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from stract_tpu_torch/csrc, builds (or reuses) a
1,000,000-doc synthetic corpus under data/torch_smoke/, holds each kernel
against its plain PyTorch version at the main path's shapes, then serves the
corpus over HTTP in process (stract_tpu_torch.main) and drives the search
route: every answer must be a 200 with webpages, every kernel must have been
launched by that traffic, and the top-10 of sample queries must match the
same stack run with the plain versions on the card. Prints per-kernel times,
qps and p50, and as its last line the device record. Any failure raises, so
the exit code is non-zero; without a card it exits 2 before doing anything.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
DOCS = 1_000_000
SEED = 0
NOW = 1.7e9
# main-path shapes of the three programs
B, L, C, KD, OUT_K, SIG_K, PAGE_K = 32, 1024, 4096, 4096, 1024, 64, 128
N_REQUESTS, CLIENTS = 128, 16
CUSTOM = {"host_centrality": 3.0, "bm25_clean_body": -0.2}

# Tolerances, kernel against plain version on the same card:
#  stage A  scores rtol 1e-5, atol 5e-2: the plain version takes per-doc sums
#           as differences of an f32 cumsum over P*L = 65,536 entries per
#           query (running sums ~1e5), the kernel sums each doc with atomics;
#           docs compared as sets above the C-th score (tie order differs)
#  stage B  scores rtol 1e-5, atol 1e-4 (sums over P <= 64 slots in another
#           order); fused signals within one q16 step
#  pass 2   q16 rows within one step, scales rtol 1e-5
A_TOL, B_TOL = (1e-5, 5e-2), (1e-5, 1e-4)


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def topk_match(docs_a, scores_a, docs_b, scores_b, num_docs, rtol, atol) -> float:
    """Raise unless two top-k lists agree (sorted scores within tolerance;
    every doc clearly above the k-th score in both); → max |score diff|."""
    import numpy as np

    fa, fb = np.isfinite(scores_a), np.isfinite(scores_b)
    if fa.sum() != fb.sum():
        raise AssertionError(f"finite counts differ: {fa.sum()} vs {fb.sum()}")
    if not ((docs_a[~fa] == num_docs).all() and (docs_b[~fb] == num_docs).all()):
        raise AssertionError("pad entries must carry the pad doc")
    sa, sb = np.sort(scores_a[fa])[::-1], np.sort(scores_b[fb])[::-1]
    err = float(np.max(np.abs(sa - sb))) if len(sa) else 0.0
    np.testing.assert_allclose(sb, sa, rtol=rtol, atol=atol)
    if len(sa):
        cut = sa[-1] + 2 * (abs(sa[-1]) * rtol + atol) if fa.all() else -np.inf
        mb = dict(zip(docs_b[fb].tolist(), scores_b[fb].tolist()))
        for d, s in zip(docs_a[fa].tolist(), scores_a[fa].tolist()):
            if s > cut:
                if d not in mb:
                    raise AssertionError(f"doc {d} (score {s}) missing")
                err = max(err, abs(mb[d] - s))
                np.testing.assert_allclose(mb[d], s, rtol=rtol, atol=atol)
    return err


def time_ms(fn, iters: int = 10) -> float:
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def kernel_phase(index, device) -> list:
    """K1, K2, K3 against their plain versions on real slots of sampled
    queries, for both static modes. → rows per (kernel, default_static)."""
    import numpy as np
    import torch

    from stract_tpu_torch import bench_corpus as bc
    from stract_tpu_torch.index.inverted import InvertedIndex
    from stract_tpu_torch.ops import scoring as O
    from stract_tpu_torch.ranking.computer import QueryContext, build_slots

    seg = index.segments[0]
    dev = index.device_segment_for(seg)
    nd = seg.num_docs
    T = lambda x, dt=torch.int32: torch.as_tensor(x, dtype=dt).to(device)  # noqa: E731
    queries = bc.sample_queries(np.random.default_rng(SEED), B)
    rows = []
    for ds in (True, False):
        ctxs = [QueryContext(raw=q, simple_terms=q.split(), current_ts=NOW,
                             coefficients={} if ds else CUSTOM) for q in queries]
        slots = [build_slots(c, seg, index.num_docs, index.region_scores()) for c in ctxs]
        P = max(q.starts.shape[0] for q, _ in slots)
        if any(q.starts.shape[0] != P for q, _ in slots):
            raise AssertionError("sampled queries must share one slot bucket")
        qa = O.to_tensors(O.stack([InvertedIndex._augment_with_impact(seg, dev, q)
                                   for q, _ in slots]), device)

        # K1: stage A
        run_k = lambda: O.score_candidates_batch(dev.arrays, qa, L, C, ds, True)  # noqa: E731
        run_p = lambda: O.score_candidates_batch_plain(dev.arrays, qa, L, C, ds, True)  # noqa: E731
        d_k, s_k = [x.cpu().numpy() for x in run_k()]
        d_p, s_p = [x.cpu().numpy() for x in run_p()]
        err = max(topk_match(d_p[b], s_p[b], d_k[b], s_k[b], nd, *A_TOL) for b in range(B))
        if not np.isfinite(s_k).any():
            raise AssertionError("stage A found no candidates")
        rows.append(("stage_a", ds, err, time_ms(run_k), time_ms(run_p)))

        # K2: stage B over stage A's candidates, fused signals
        comp = [InvertedIndex._compact_slots(q, a, min_p=16) for q, a in slots]
        Pc = max(q.starts.shape[0] for q, _ in comp)
        comp = [(q._replace(**{f: np.pad(getattr(q, f), (0, Pc - q.starts.shape[0]),
                                         constant_values=O.OPTIONAL_GROUP if f == "group" else 0)
                               for f in ("starts", "lens", "group", "idf", "w_bm25", "w_bm25f",
                                         "w_presence")}),
                 a._replace(**{f: np.pad(getattr(a, f), ((0, 0), (0, Pc - q.starts.shape[0])))
                               for f in a._fields})) for q, a in comp]
        facs = np.zeros((B, Pc, KD), np.int32)
        for j, (q, _) in enumerate(comp):
            InvertedIndex._slot_factors_for(seg, q, d_k[j], out=facs[j])
        qc = O.to_tensors(O.stack([q for q, _ in comp]), device)
        ac = O.to_tensors(O.stack([a for _, a in comp]), device)
        f_t, c_t = T(facs), T(d_k)
        run_k = lambda: O.score_driver_batch_with_signals(  # noqa: E731
            dev.arrays, qc, f_t, c_t, ac, ds, OUT_K, SIG_K)
        run_p = lambda: O.score_driver_batch_plain(  # noqa: E731
            dev.arrays, qc, f_t, c_t, ds, OUT_K, ac, SIG_K)
        dk, sk, sigk = O.unpack_stageb(run_k(), OUT_K, 46, SIG_K)
        res_p = run_p()
        dp, sp, sigp = O.unpack_stageb(res_p, OUT_K, 46, SIG_K)
        scale = res_p[3].cpu().numpy()
        err = 0.0
        for b in range(B):
            err = max(err, topk_match(dp[b], sp[b], dk[b], sk[b], nd, *B_TOL))
            col = {int(d): i for i, d in enumerate(dp[b][:SIG_K]) if d < nd}
            for i, d in enumerate(dk[b][:SIG_K]):
                if d < nd and int(d) in col:
                    diff = np.abs(sigk[b][:, i] - sigp[b][:, col[int(d)]])
                    if (diff > 1.001 * scale[b] + 1e-30).any():
                        raise AssertionError(f"stage-B signals differ by {diff.max()}")
                    err = max(err, float(diff.max()))
        rows.append(("stage_b", ds, err, time_ms(run_k), time_ms(run_p)))

        # K3: pass 2 over a page of stage B's winners
        page = dk[:, :PAGE_K].astype(np.int32)
        pf = np.zeros((B, Pc, PAGE_K), np.int32)
        for j, (q, _) in enumerate(comp):
            InvertedIndex._slot_factors_for(seg, q, page[j], out=pf[j])
        pf_t, pg_t = T(pf), T(page)
        run_k = lambda: O.compute_signals_from_factors_batch_q16(  # noqa: E731
            dev.arrays, qc, ac, pf_t, pg_t)
        run_p = lambda: O.compute_signals_from_factors_batch_q16_plain(  # noqa: E731
            dev.arrays, qc, ac, pf_t, pg_t)
        qk, sck = run_k()
        qp, scp = run_p()
        torch.testing.assert_close(sck, scp, rtol=1e-5, atol=1e-35)
        step = int((qk.int() - qp.int()).abs().max().item())
        if step > 1:
            raise AssertionError(f"pass-2 q16 rows differ by {step} steps")
        err = float((O.dequantize_signals(qk, sck) - O.dequantize_signals(qp, scp)).__abs__().max())
        rows.append(("signals_q16", ds, err, time_ms(run_k), time_ms(run_p)))
    return rows


def requests_mix(n: int) -> list:
    """Generated search bodies: 2-term AND queries (driver and scan mode),
    a three-term query, custom coefficients, an exclusion, deep pages (their
    page signals miss the fused stage-B rows and run pass 2)."""
    import numpy as np

    from stract_tpu_torch import bench_corpus as bc

    rng = np.random.default_rng(SEED + 1)
    qs = bc.sample_queries(rng, n)
    out = []
    for i, q in enumerate(qs):
        body = {"query": q}
        kind = i % 8
        if kind == 1:
            body["query"] = f"w{i % 5} w{5 + i % 7}"  # two head terms: the scan path
        elif kind == 2:
            body["query"] = f"{q} w{int(rng.integers(0, 50))}"
        elif kind == 3:
            body["signalCoefficients"] = CUSTOM
        elif kind == 4:
            body["query"] = f"{q} -w{int(rng.integers(50, 100))}"
        elif kind == 5:
            body.update(page=4, numResults=20)
        elif kind == 6:
            body["returnRankingSignals"] = True
        out.append(body)
    return out


def post(url: str, body: dict):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"content-type": "application/json"})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=300) as resp:
        status, data = resp.status, json.loads(resp.read())
    return status, data, time.perf_counter() - t0


@contextlib.contextmanager
def plain_versions():
    """Route the serving stack's device programs to their plain PyTorch
    versions on the same card (the reference run of the comparison)."""
    import torch

    from stract_tpu_torch.ops import scoring as O

    def stage_a(seg, qs, L, K, ds, soft_required=False):
        qs = O.to_tensors(O._batched(qs, O.QuerySlots), seg.postings.device)
        return O.score_candidates_batch_plain(seg, qs, L, K, ds, soft_required)

    def stage_b(seg, qs, f, d, aggs, ds, out_k, sig_k):
        dev = seg.postings.device
        return O.score_driver_batch_plain(
            seg, O.to_tensors(O._batched(qs, O.QuerySlots), dev),
            torch.as_tensor(f).to(dev), torch.as_tensor(d).to(dev), ds, out_k,
            O.to_tensors(O._batched(aggs, O.QueryAggregates), dev), sig_k)

    def signals(seg, qs, aggs, f, c):
        dev = seg.postings.device
        return O.compute_signals_from_factors_batch_q16_plain(
            seg, O.to_tensors(O._batched(qs, O.QuerySlots), dev),
            O.to_tensors(O._batched(aggs, O.QueryAggregates), dev),
            torch.as_tensor(f).to(dev), torch.as_tensor(c).to(dev))

    saved = (O.score_candidates_batch, O.score_driver_batch_with_signals,
             O.compute_signals_from_factors_batch_q16)
    O.score_candidates_batch, O.score_driver_batch_with_signals = stage_a, stage_b
    O.compute_signals_from_factors_batch_q16 = signals
    try:
        yield
    finally:
        (O.score_candidates_batch, O.score_driver_batch_with_signals,
         O.compute_signals_from_factors_batch_q16) = saved


def serve_phase(searcher) -> dict:
    """HTTP traffic through the in-process server; counters reset first."""
    import numpy as np

    from stract_tpu_torch.api.server import build_app
    from stract_tpu_torch.main import ServerThread
    from stract_tpu_torch.ops import kernels

    bodies = requests_mix(N_REQUESTS)
    server = ServerThread(build_app(searcher, max_concurrency=2 * CLIENTS))
    try:
        post(server.url + "/beta/api/search", {"query": "w1 w2"})  # warm-up, not counted
        kernels.reset_launches()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(CLIENTS) as pool:
            results = list(pool.map(lambda b: post(server.url + "/beta/api/search", b), bodies))
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        with urllib.request.urlopen(server.url + "/metrics", timeout=60) as resp:
            metrics = resp.read().decode()
    finally:
        server.stop()
    lat = np.array([r[2] for r in results])
    for body, (status, data, _) in zip(bodies, results):
        if status != 200 or data.get("type") != "websites" or "webpages" not in data:
            raise AssertionError(f"bad answer to {body}: {status} {str(data)[:200]}")
    n_hits = sum(len(d["webpages"]) for _, d, _ in results)
    if n_hits == 0:
        raise AssertionError("no request returned a webpage")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel was not launched by the HTTP traffic: {launches}")
    if f'search_requests_total{{status="ok"}} {len(bodies) + 1}' not in metrics:
        raise AssertionError("metrics do not count every answered request")
    return {"requests": len(bodies), "clients": CLIENTS, "wall_s": wall,
            "qps": len(bodies) / wall, "p50_ms": float(np.median(lat) * 1e3),
            "p99_ms": float(np.quantile(lat, 0.99) * 1e3), "webpages": n_hits,
            "launches": launches}


def compare_phase(searcher) -> dict:
    """Top-10 of 8 queries: kernels against the plain versions, same card."""
    import numpy as np

    from stract_tpu_torch.searcher.query import SearchQuery

    bodies = [b for b in requests_mix(64) if "page" not in b][:8]
    kern = [searcher.search(SearchQuery.from_json({**b, "numResults": 10})).to_json()
            for b in bodies]
    with plain_versions():
        plain = [searcher.search(SearchQuery.from_json({**b, "numResults": 10})).to_json()
                 for b in bodies]
    err, n = 0.0, 0
    for pk, pp in zip(kern, plain):
        wk, wp = pk["webpages"], pp["webpages"]
        ids = {w["url"]: i for i, w in enumerate(wk + wp)}
        err = max(err, topk_match(np.array([ids[w["url"]] for w in wp]),
                                  np.array([w["score"] for w in wp]),
                                  np.array([ids[w["url"]] for w in wk]),
                                  np.array([w["score"] for w in wk]), -1, 1e-3, 1e-3))
        n += len(wk)
    if n == 0:
        raise AssertionError("the compared queries returned nothing")
    return {"queries": len(bodies), "docs": n, "max_score_diff": err}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from stract_tpu_torch import bench_corpus as bc
    from stract_tpu_torch.main import build_searcher
    from stract_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    t = time.perf_counter()
    kernels.build(verbose=True)
    log(f"[setup] kernels built in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    index_dir = bc.ensure_corpus(os.path.join(ROOT, "data", "torch_smoke"), DOCS, seed=SEED,
                                 log=log)
    log(f"[setup] corpus ready in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    searcher = build_searcher(index_dir, "cuda")
    index = searcher.searcher.searchers[0].index
    torch.cuda.synchronize()
    log(f"[setup] index on the card in {time.perf_counter() - t:.1f}s; "
        f"{torch.cuda.memory_allocated() / 2**20:.0f} MiB held")

    rows = kernel_phase(index, "cuda")
    for name, ds, err, ms, pms in rows:
        log(f"[kernel] {name:12s} default_static={ds!s:5s} max_abs_err={err:.3g} "
            f"kernel={ms:.3f} ms plain={pms:.3f} ms")
    torch.cuda.reset_peak_memory_stats()
    served = serve_phase(searcher)
    log(f"[serve] {json.dumps(served)}")
    cmp = compare_phase(searcher)
    log(f"[compare] top-10 kernels vs plain versions: {json.dumps(cmp)}")
    log(f"[result] docs={DOCS} qps={served['qps']:.2f} p50_ms={served['p50_ms']:.1f} "
        f"p99_ms={served['p99_ms']:.1f} device_mem_peak_MiB="
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} device_mem_held_MiB="
        f"{torch.cuda.memory_allocated() / 2**20:.0f} card={card}")

    replaces = {"stage_a": "stract_tpu/ops/scoring.py:807",
                "stage_b": "stract_tpu/ops/scoring.py:660",
                "signals_q16": "stract_tpu/ops/scoring.py:886"}
    kernels_out = []
    for name in ("stage_a", "stage_b", "signals_q16"):
        mine = [r for r in rows if r[0] == name]
        main_row = next(r for r in mine if r[1])
        kernels_out.append({
            "name": name, "route": "cuda", "source": "stract_tpu_torch/csrc/scoring.cu",
            "replaces": replaces[name], "launches": served["launches"][name],
            "max_abs_err": max(r[2] for r in mine), "ms": main_row[3],
            "plain_ms": main_row[4]})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels_out}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
