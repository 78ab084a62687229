"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from stract_tpu_torch/csrc, builds (or reuses) a
1,000,000-doc synthetic corpus under data/torch_smoke/, holds each kernel
against its plain PyTorch version at the main path's shapes, then serves the
corpus over HTTP in process (stract_tpu_torch.main) and drives the search
route: every answer must be a 200 with webpages, every kernel must have been
launched by that traffic, and the top-10 of sample queries must match the
same stack run with the plain versions on the card.

Then the ranking pipeline: a 30,522-piece WordPiece vocab fit on the corpus;
the train phase trains MiniLM-L6 dual and cross encoders on the card from
triples synthesised from the corpus (stract_tpu_torch.entrypoint.
train_bench_encoders at its defaults: 400 steps, dual batch 64, 128 tokens,
4,096 triples; then the cross encoder warm-started from the dual trunk and
distilled from it), saves both and loads them back, and fails when the dual
encoder's held-out accuracy is under 0.65; every training kernel (K14a-d,
K5d) and the forward kernels (K5a-c) must be launched by that training. A
40-tree depth-3 forest is trained on the pipeline-off signal rows. The
trained dual encoder writes the corpus's embedding columns on the card; the
forest (K4), encoder (K5a-d) and training (K14a-d) kernels are held against
their plain versions, and one whole train step is timed with kernels and
with plain versions; the stack is served again with the three models loaded
as `main.py serve --dual-encoder/--cross-encoder/--lambdamart` loads them,
every serving kernel must be launched by that traffic, and its top-10 pages
must match the plain versions'.

The pipeline-on route serves 8 rounds of the request mix in one process,
and every request must be answered.

Then the webgraph centrality job (entrypoint/bench_centrality.py's graph:
1,000,000 nodes, 20,000,000 Pareto edges, seed 0, written to disk): `main.py
centrality harmonic` and `approx-harmonic` (256 sampled sources) on the card
through the function the command line calls; every HyperBall kernel (K6a
merge, K6b estimate) and the BFS relaxation (K7) must be launched by them;
the kernels are held against their plain versions at the job's shapes, and
the whole HyperBall and BFS against the same jobs through the plain
versions.

Then the shard search's other configurations, each built through
build_searcher and served one round of the request mix over HTTP with the
pipeline off: q8 posting rows, the device factor join, both, and block-max UB
scoring (ub_lambda 0.5); every request must be answered, each configuration's
own kernels launched by its traffic, and the top-10 of the compare queries
under the q16 device join must equal the default configuration's. The host
factor join is timed with and without the device join. The device-only entry
points, which no entry point of either package calls (factors_join, compute_signals_batch over the slots' L-row prefixes,
rerank_topk_batch over the corpus's f16 title embeddings and the trained dual
encoder's query embeddings) are driven once at the main shapes and checked
against the host join and a numpy rerank; then K1 on q8 rows, K1 with UB,
K11 (alone, in stage B, in pass 2), K12 and K10 are held against their plain
versions. The merge configuration (merge_kernel: stage A through the P-way
bitonic merge, K13) is served the same round; its top-10 pages must match
the same configuration run with the plain versions on the card (how many
equal the default's is printed, not gated: on the impact slots' tf-ordered
rows the merge gives other candidates, by design of the reference), and K13
is held against its plain version at B = 32, P = 64, L = 1024, C = 4096 with
the network's keys and payloads bit-equal.

Then the MoE training path: a MiniLM-L6 cross encoder at full width with 4
experts per layer (make_train_state(num_experts=4); the shared trunk
warm-started from the trained dual encoder), 20 distilled steps at 32 pairs
x 128 tokens on the smoke's triples, launch counts reset just before and
read just after: the loss must be finite and fall (mean of the last 5 steps
under the mean of the first 5), the router (K15a), select-and-scale (K15b),
loss heads (K15c) and bf16 AdamW (K15d) must be launched by those steps,
and the same 20 steps through the plain versions on the card must give the
same loss curve within 5 % per step; one step is timed with kernels and
with plain versions, and K15a-d are held against their plain versions at
the step's shapes.

Prints per-kernel times beside the least time the card could take (bytes
once over 3.35 TB/s or operations over the peak) and the time of a PyTorch
call computing the same function where there is one, qps, p50 and p99, the
centrality jobs' stage times, and as its last line the device record. Any
failure raises, so the exit code is non-zero; without a card it exits 2
before doing anything; it fails when the native host library does not
load. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
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
# the ranking pipeline: vocab, tokenizer sample, forest training queries,
# encoder batch of the kernel phase, sequence lengths, forest rows
VOCAB, TOK_DOCS, FOREST_QUERIES, ENC_B = 30522, 20_000, 32, 32
ATTN_T, ENC_T, FOREST_K, EMB_BATCH = (16, 128, 256), 128, (256, 16384), 4096
# training: the dual encoder's batch and length (the kernel phase's shapes),
# the held-out bar of tools/train_bench_encoders.py, and the step count
# (the tool's default; cut, and the cut printed, if training outgrows the run)
TRAIN_B, TRAIN_T, MIN_DUAL_ACC, TRAIN_STEPS = 64, 128, 0.65, 400
SCORING = ("stage_a", "stage_b", "signals_q16")
# the shard search's other configurations (build_searcher's arguments) and the
# kernels each one's traffic must launch
CONFIGS = {
    "q8": (dict(row_layout="q8"), ("stage_a_q8", "stage_b", "signals_q16")),
    "join": (dict(device_join=True), ("stage_a", "stage_b_joined", "signals_joined")),
    "q8_join": (dict(row_layout="q8", device_join=True),
                ("stage_a_q8", "stage_b_joined", "signals_joined")),
    "ub": (dict(ub_lambda=0.5), ("stage_a_ub", "stage_b", "signals_q16")),
    "merge": (dict(merge_kernel=True), ("stage_a_merge", "stage_b", "signals_q16")),
}
# device programs that no entry point of either package calls (the JAX package
# keeps them as library functions): the smoke calls each wrapper once at the main
# shapes, so their `launches` show that the wrapper launches, not a served path
DIRECT = ("factors_join", "signals_prefix", "dense_rerank")
# the dense rerank: candidates per query, kept, the similarity's weight
RERANK_K, RERANK_TOP, RERANK_W = 1024, 20, 0.01
SERVING = SCORING + ("forest", "attention", "add_layernorm", "bias_gelu", "mean_pool")
TRAINING = ("attention", "add_layernorm", "bias_gelu", "mean_pool", "attention_backward",
            "add_layernorm_backward", "bias_gelu_backward", "adamw")
# the centrality job: the benchmark graph (entrypoint/bench_centrality.py)
# and the sampled sources of approx-harmonic
GRAPH_NODES, GRAPH_EDGES, GRAPH_SAMPLES = 1_000_000, 20_000_000, 256
# pipeline-on serving: rounds of the request mix in one process
SERVE_ON_ROUNDS = 8
# K13 held against its plain version: slots per query (the index's larger
# stage-A bucket)
MERGE_P = 64
# the MoE training path: experts per layer, distilled steps, pairs per step,
# the smoke's cross recipe (lr, distillation weight, teacher scale), the
# steps timed; the kernels the steps must launch
MOE_E, MOE_STEPS, MOE_B, MOE_LR, MOE_ALPHA, TEACHER_SCALE = 4, 20, 32, 3e-4, 2.0, 5.0
MOE_TIMED = 3
MOE_KERNELS = ("moe_router", "moe_select", "loss_heads", "adamw_bf16", "adamw")
DEVICE = "cuda"  # the phases run here; a CPU rehearsal of the flow sets "cpu"

# Tolerances, kernel against plain version on the same card:
#  stage A  scores rtol 1e-5, atol 5e-2: the plain version takes per-doc sums
#           as differences of an f32 cumsum over P*L = 65,536 entries per
#           query (running sums ~1e5), the kernel sums each doc with atomics;
#           docs compared as sets above the C-th score (tie order differs)
#  stage B  scores rtol 1e-5, atol 1e-4 (sums over P <= 64 slots in another
#           order); fused signals within one q16 step
#  pass 2   q16 rows within one step, scales rtol 1e-5
#  forest  rtol 1e-6, atol 1e-6 x sum over trees of max |leaf| (same leaves,
#           the tree sum in another order)
#  attention, LN, GELU  bf16 outputs within one bf16 step (rtol 2^-7) plus
#           atol 1e-2: f32 sums in another order, exp / rsqrt / tanh in
#           another implementation, each may move a value across a rounding
#           boundary of the bf16 cast
#  backward kernels, pool  within one bf16 step of the plain version's
#           largest magnitude (rtol 2^-7, atol 2^-7 x max |plain|): the same
#           reasons, on intermediate roundings (probabilities, dP, each step of
#           the GELU chain); LN parameter gradients (f32 column sums over 8,192
#           rows) rtol 1e-4, atol 1e-4 x max |plain|
#  adamw    rtol 1e-6, atol 1e-6 x max |plain| after 3 steps (the same f32 ops;
#           division and square root may round differently by an ulp)
#  K6a, K7  registers and distances bit-equal (max and min are exact); K6b
#           sizes rel 1e-6 (the 64 powers of two of a row summed in another
#           order); whole HyperBall centrality rtol 1e-6 with the same rounds
#  K1 on q8 rows, K1 with UB  as stage A (UB adds (contrib - ub) + U per
#           entry and takes n*U back out: the same sums, in the atomics' order)
#  K11 alone  bit-equal (integer work), and equal to the host join on q16 rows
#  joined stage B  as stage B; joined pass 2  as pass 2
#  K12     f32 rows rtol 1e-5, atol 1e-5 (sums over P slots in another order)
#  K10     scores rtol 1e-6, atol 2e-6 (a 384-term dot product summed by a
#           warp in another order, times the weight, added to base scores of
#           ~10); indices compared as sets above the k-th score
#  K13     the network's keys and payloads bit-equal (a fixed list of
#           compare-exchanges on bit-equal inputs); scores as stage A (the
#           plain version's run sums are f32 cumsum differences, the kernel's
#           direct sums of each run), compared as multisets of (doc, score)
#           above the C-th score: a doc may stand in several runs
#  K15a    probabilities rtol 1e-5 (f32 sums over H in another order, expf),
#           the expert chosen equal where the top two probabilities differ by
#           more than 1e-5, gate and dx within one bf16 step, the logits'
#           cotangent rtol 1e-5, atol 1e-6 x max |plain|
#  K15b    forward and the experts' cotangent bit-equal; the gate's cotangent
#           (an f32 row sum in another order, rounded to bf16) one bf16 step
#  K15c    rtol 1e-5 (sums over B in another order, exp and log in another
#           implementation)
#  K15d    one bf16 step after 3 steps (every operation rounds to bf16;
#           Triton's division and square root are not correctly rounded in
#           f32, which may move a value across a bf16 rounding boundary)
#  MoE     the 20-step loss curve through the kernels within 5 % per step of
#           the plain versions': one-step differences within a bf16 step grow
#           through AdamW, whose first updates are ~lr x sign(g)
A_TOL, B_TOL = (1e-5, 5e-2), (1e-5, 1e-4)
P12_TOL, RERANK_TOL = (1e-5, 1e-5), (1e-6, 2e-6)
MOE_CURVE_RTOL = 0.05
# top-10 pages of a configuration against the default's, scores within rtol
# 1e-3: the q16 device join must give all of the default's pages (its stage B is
# held to the host-joined stage B bit for bit in the kernel phase; the page's
# scores are read back from q16 signal rows, the default's from stage B's fused
# rows scaled over 64 columns and the join's from pass 2 scaled over the page, so
# they differ by the q16 steps); the other configurations are printed, not gated
PAGE_RTOL = 1e-3
ENC_TOL = (2 ** -7, 1e-2)
STEP = 2 ** -7
# model signals, kernels against plain versions on one card: embedding
# similarities within 2e-2, cross-encoder sigmoids within 1e-2; page scores
# within 5e-3 + 1e-3 relative (0.01 and 0.17 are those signals' weights)
MODEL_TOL = {"title_embedding_similarity": 2e-2, "keyword_embedding_similarity": 2e-2,
             "cross_encoder_snippet": 1e-2, "cross_encoder_title": 1e-2}
PIPE_SCORE_TOL = (1e-3, 5e-3)
TOL_TEXT = {"stage_a": f"rtol {A_TOL[0]} atol {A_TOL[1]}",
            "stage_b": f"rtol {B_TOL[0]} atol {B_TOL[1]}",
            "signals_q16": "1 q16 step, scales rtol 1e-5",
            "stage_a_q8": f"rtol {A_TOL[0]} atol {A_TOL[1]}",
            "stage_a_ub": f"rtol {A_TOL[0]} atol {A_TOL[1]}",
            "stage_a_ub_q8": f"rtol {A_TOL[0]} atol {A_TOL[1]}",
            "factors_join": "bit-equal",
            "stage_b_joined": f"rtol {B_TOL[0]} atol {B_TOL[1]}",
            "signals_joined": "1 q16 step, scales rtol 1e-5",
            "signals_prefix": f"rtol {P12_TOL[0]} atol {P12_TOL[1]}",
            "dense_rerank": f"rtol {RERANK_TOL[0]} atol {RERANK_TOL[1]}",
            "forest": "rtol 1e-6 atol 1e-6*sum|leaf|",
            "attention": f"rtol 2^-7 atol {2 * ENC_TOL[1]}",
            "add_layernorm": f"rtol 2^-7 atol {ENC_TOL[1]}",
            "bias_gelu": f"rtol 2^-7 atol {ENC_TOL[1]}",
            "mean_pool": "rtol 2^-7 atol 2^-7*max|plain|",
            "attention_backward": "rtol 2^-7 atol 2^-7*max|plain|",
            "add_layernorm_backward": "rtol 2^-7 atol 2^-7*max|plain|; dw, db rtol 1e-4",
            "bias_gelu_backward": "rtol 2^-7 atol 2^-7*max|plain|",
            "adamw": "rtol 1e-6 atol 1e-6*max|plain|",
            "stage_a_merge": f"network bit-equal; rtol {A_TOL[0]} atol {A_TOL[1]}",
            "moe_router": "probs rtol 1e-5; gate, dx 1 bf16 step; dlogits rtol 1e-5",
            "moe_select": "bit-equal; d gate 1 bf16 step",
            "loss_heads": "rtol 1e-5",
            "adamw_bf16": "1 bf16 step after 3 steps",
            "hll_merge": "registers bit-equal, sizes rel 1e-6",
            "hll_estimate": "rel 1e-6", "bfs_relax": "bit-equal"}


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


def topk_runs_match(docs_a, scores_a, docs_b, scores_b, num_docs, rtol, atol) -> float:
    """topk_match for results in which a doc may stand several times (stage
    A under the merge): sorted scores within tolerance, and every entry
    clearly above the k-th score matched by an entry of the same doc with its
    score, each used once; → max |score diff|."""
    import numpy as np

    fa, fb = np.isfinite(scores_a), np.isfinite(scores_b)
    if fa.sum() != fb.sum():
        raise AssertionError(f"finite counts differ: {fa.sum()} vs {fb.sum()}")
    if not ((docs_a[~fa] == num_docs).all() and (docs_b[~fb] == num_docs).all()):
        raise AssertionError("pad entries must carry the pad doc")
    sa, sb = np.sort(scores_a[fa])[::-1], np.sort(scores_b[fb])[::-1]
    err = float(np.max(np.abs(sa - sb))) if len(sa) else 0.0
    np.testing.assert_allclose(sb, sa, rtol=rtol, atol=atol)
    cut = sa[-1] + 2 * (abs(sa[-1]) * rtol + atol) if len(sa) and fa.all() else -np.inf
    left: dict = {}
    for d, x in zip(docs_b[fb].tolist(), scores_b[fb].tolist()):
        left.setdefault(d, []).append(x)
    for d, x in zip(docs_a[fa].tolist(), scores_a[fa].tolist()):
        if x <= cut:
            continue
        near = [y for y in left.get(d, []) if abs(y - x) <= atol + rtol * abs(x)]
        if not near:
            raise AssertionError(f"doc {d} (score {x}) missing")
        best = min(near, key=lambda y: abs(y - x))
        left[d].remove(best)
        err = max(err, abs(best - x))
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


def search_rows(lens, n: int, steps=None, cap=None) -> int:
    """The distinct posting rows that n binary searches over each slot of
    `lens` rows can touch, summed over the slots: step d of a search has at
    most min(2^d, n) different midpoints (the searches of one slot share their
    upper levels), and a slot gives no more rows than it holds (or than `cap`).
    `steps` is the fixed step count of the prefix search; else a slot of len
    rows takes ceil(log2(len + 1)) steps."""
    import numpy as np

    lens = np.asarray(lens, dtype=np.int64)
    held = lens if cap is None else np.minimum(lens, cap)
    depth = (np.ceil(np.log2(held + 1)).astype(np.int64) if steps is None
             else np.where(held > 0, steps, 0))
    rows = np.zeros_like(held)
    for d in range(int(depth.max(initial=0))):
        rows += np.where(d < depth, min(1 << d, n), 0)
    return int(np.minimum(rows, held).sum())


def pad_slots(q, P: int):
    """Query slots padded with empty optional slots to P."""
    import numpy as np

    from stract_tpu_torch.ops import scoring as O

    n = q.starts.shape[0]
    if n > P:
        raise ValueError(f"{n} slots do not fit {P}")
    return q._replace(**{f: np.pad(getattr(q, f), (0, P - n),
                                   constant_values=O.OPTIONAL_GROUP if f == "group" else 0)
                         for f in ("starts", "lens", "group", "idf", "w_bm25", "w_bm25f",
                                   "w_presence")})


def compacted_slots(slots: list) -> tuple:
    """Stage B's view of sampled queries: each (slots, aggregates) pair
    compacted (empty slots dropped) and padded to the batch's one slot count
    → (pairs, that count)."""
    import numpy as np

    from stract_tpu_torch.index.inverted import InvertedIndex

    comp = [InvertedIndex._compact_slots(q, a, min_p=16) for q, a in slots]
    Pc = max(q.starts.shape[0] for q, _ in comp)
    return [(pad_slots(q, Pc),
             a._replace(**{f: np.pad(getattr(a, f), ((0, 0), (0, Pc - q.starts.shape[0])))
                           for f in a._fields})) for q, a in comp], Pc


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
        qa = O.to_tensors(O.stack([InvertedIndex._augment_with_impact(seg, dev, q)[0]
                                   for q, _ in slots]), device)

        # K1: stage A
        run_k = lambda: O.score_candidates_batch(dev.arrays, qa, L, C, ds, True)  # noqa: E731
        run_p = lambda: O.score_candidates_batch_plain(dev.arrays, qa, L, C, ds, True)  # noqa: E731
        d_k, s_k = [x.cpu().numpy() for x in run_k()]
        d_p, s_p = [x.cpu().numpy() for x in run_p()]
        err = max(topk_match(d_p[b], s_p[b], d_k[b], s_k[b], nd, *A_TOL) for b in range(B))
        if not np.isfinite(s_k).any():
            raise AssertionError("stage A found no candidates")
        scanned = int(qa.lens.clamp(max=L).sum())  # posting rows of the slots' prefixes
        rows.append(("stage_a", ds, err, time_ms(run_k), time_ms(run_p), C,
                     12 * scanned + sum(x.numel() * 4 for x in qa) + 8 * B * C, 10 * scanned))

        # K2: stage B over stage A's candidates, fused signals
        comp, Pc = compacted_slots(slots)
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
        rows.append(("stage_b", ds, err, time_ms(run_k), time_ms(run_p), KD,
                     4 * (f_t.numel() + c_t.numel()) + sum(x.numel() * 4 for x in (*qc, *ac))
                     + 8 * B * OUT_K + 2 * B * 46 * SIG_K, 10 * f_t.numel()))

        # K3: pass 2 over a page of stage B's winners, and over a 300-row
        # recall block (the pipeline's K=512 bucket)
        for page_k in (PAGE_K, 512):
            page = dk[:, :page_k].astype(np.int32)
            pf = np.zeros((B, Pc, page_k), np.int32)
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
            err = float(np.abs(O.dequantize_signals(qk, sck)
                               - O.dequantize_signals(qp, scp)).max())
            rows.append(("signals_q16", ds, err, time_ms(run_k), time_ms(run_p), page_k,
                         4 * (pf_t.numel() + pg_t.numel()) + sum(x.numel() * 4 for x in
                                                                 (*qc, *ac))
                         + 2 * B * 46 * page_k + 4 * B * 46, 2 * 46 * pf_t.numel()))
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
    """Route the device programs to their plain PyTorch versions on the same
    card (the reference run of the comparisons): K1-K3 in ops/scoring.py, K4
    in ops/forest.py, K5a-d and their gradients K14a-c in ops/encoder.py (the
    dispatchers the autograd Functions call), K14d and K15d in optim.py,
    K15a-b in ops/moe.py, K15c in ops/losses.py, K6a-b in ops/hll_ops.py and
    K7 in webgraph/shortest_path.py (over the edges of the reverse CSR the
    kernels take). Stage A keeps its configuration's arguments (UB bounds,
    the merge)."""
    import torch

    from stract_tpu_torch import optim
    from stract_tpu_torch.ops import encoder as E
    from stract_tpu_torch.ops import forest as FO
    from stract_tpu_torch.ops import hll_ops as HO
    from stract_tpu_torch.ops import losses as LO
    from stract_tpu_torch.ops import moe as MO
    from stract_tpu_torch.ops import scoring as O
    from stract_tpu_torch.webgraph import shortest_path as SP

    def stage_a(seg, qs, L, K, ds, soft_required=False, ub_entry=None, ub_total=None,
                merge=False):
        dev = seg.postings.device
        qs = O.to_tensors(O._batched(qs, O.QuerySlots), dev)
        return O.score_candidates_batch_plain(seg, qs, L, K, ds, soft_required,
                                              O._on(ub_entry, dev, torch.float32),
                                              O._on(ub_total, dev, torch.float32), merge)

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

    def csr_targets(csr, n):
        counts = (csr.offsets[1:] - csr.offsets[:-1]).long()
        return torch.repeat_interleave(torch.arange(n, device=csr.offsets.device), counts)

    def hll_merge(regs, csr, out=None, sizes=True):
        new = HO.merge_iteration_plain(regs, csr.sources, csr_targets(csr, regs.shape[0]))
        changed = torch.tensor([int(not torch.equal(new, regs))], dtype=torch.int32,
                               device=regs.device)
        return new, HO.estimate_sizes_plain(new) if sizes else None, changed

    def bfs_relax(dist_ns, csr, out=None):
        new = SP.relax_plain(dist_ns.t(), csr.sources, csr_targets(csr, dist_ns.shape[0]))
        new = new.t().contiguous()
        return new, torch.tensor([int(not torch.equal(new, dist_ns))], dtype=torch.int32,
                                 device=dist_ns.device)

    swaps = [(O, "score_candidates_batch", stage_a),
             (O, "score_driver_batch_with_signals", stage_b),
             (O, "compute_signals_from_factors_batch_q16", signals),
             (FO, "gbdt_forward", FO.gbdt_forward_plain),
             (E, "attention_forward", E.attention_plain),
             (E, "add_layernorm_forward", E.add_layernorm_plain),
             (E, "bias_gelu_forward", E.bias_gelu_plain),
             (E, "mean_pool_forward", E.mean_pool_plain),
             (E, "attention_backward", E.attention_backward_plain),
             (E, "add_layernorm_backward", E.add_layernorm_backward_plain),
             (E, "bias_gelu_backward", E.bias_gelu_backward_plain),
             (E, "mean_pool_backward", E.mean_pool_backward_plain),
             (optim, "adamw_update", optim.adamw_update_plain),
             (optim, "adamw_bf16_update", optim.adamw_bf16_update_plain),
             (MO, "router_forward", MO.router_plain),
             (MO, "router_backward", MO.router_backward_plain),
             (MO, "select_scale_forward", MO.select_scale_plain),
             (MO, "select_scale_backward", MO.select_scale_backward_plain),
             (LO, "pair_loss_forward", LO.pair_loss_plain),
             (LO, "info_nce_forward", LO.info_nce_plain),
             (HO, "merge_csr", hll_merge), (HO, "estimate_sizes", HO.estimate_sizes_plain),
             (SP, "relax", bfs_relax)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def serve_phase(searcher, expect, rounds: int = 1) -> dict:
    """HTTP traffic through the in-process server, `rounds` rounds of the
    request mix; counters reset first. Every request must be answered, and
    every kernel named in `expect` launched by that traffic. qps is over all
    rounds; "round_qps" lists each round's."""
    import numpy as np

    from stract_tpu_torch.api.server import build_app
    from stract_tpu_torch.main import ServerThread
    from stract_tpu_torch.ops import kernels

    bodies = requests_mix(N_REQUESTS)
    server = ServerThread(build_app(searcher, max_concurrency=2 * CLIENTS))
    results, round_qps = [], []
    try:
        post(server.url + "/beta/api/search", {"query": "w1 w2"})  # warm-up, not counted
        kernels.reset_launches()
        t0 = time.perf_counter()
        for _ in range(rounds):
            t1 = time.perf_counter()
            with ThreadPoolExecutor(CLIENTS) as pool:
                results += pool.map(lambda b: post(server.url + "/beta/api/search", b), bodies)
            round_qps.append(len(bodies) / (time.perf_counter() - t1))
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        with urllib.request.urlopen(server.url + "/metrics", timeout=60) as resp:
            metrics = resp.read().decode()
    finally:
        server.stop()
    lat = np.array([r[2] for r in results])
    bad = [(body, status, data) for body, (status, data, _) in zip(bodies * rounds, results)
           if status != 200 or data.get("type") != "websites" or "webpages" not in data]
    if bad:
        body, status, data = bad[0]
        raise AssertionError(f"{len(bad)} bad answers, the first to {body}: {status} "
                             f"{str(data)[:200]}")
    n_hits = sum(len(d["webpages"]) for _, d, _ in results)
    if n_hits == 0:
        raise AssertionError("no request returned a webpage")
    if any(launches[k] == 0 for k in expect):
        raise AssertionError(f"a kernel was not launched by the HTTP traffic: {launches}")
    if f'search_requests_total{{status="ok"}} {len(results) + 1}' not in metrics:
        raise AssertionError("metrics do not count every answered request")
    return {"requests": len(results), "rounds": rounds, "clients": CLIENTS, "wall_s": wall,
            "failed": len(bad), "qps": len(results) / wall, "round_qps": round_qps,
            "p50_ms": float(np.median(lat) * 1e3),
            "p99_ms": float(np.quantile(lat, 0.99) * 1e3), "webpages": n_hits,
            "launches": launches}


def compare_pipeline_page(pp, pk, forest) -> tuple:
    """Pipeline-on pages, plain (pp) against kernels (pk): model signals
    within MODEL_TOL, others within 1e-3 relative; a row whose two signal
    vectors lie on two sides of a forest split may flip a leaf, so its
    lambda_mart and score are not compared and a page holding one is
    compared on its shared rows only. → (max score diff, flipped rows)."""
    import numpy as np

    from stract_tpu_torch.ranking.models.lambdamart import signal_matrix

    wp, wk = pp["webpages"], pk["webpages"]
    by_url = {w["url"]: i for i, w in enumerate(wp)}
    shared = [(by_url[w["url"]], ik) for ik, w in enumerate(wk) if w["url"] in by_url]
    flips = forest.split_between(signal_matrix([wp[i] for i, _ in shared]),
                                 signal_matrix([wk[i] for _, i in shared]))
    err = 0.0
    for (ip, ik), flip in zip(shared, flips):
        a, b = wk[ik]["rankingSignals"], wp[ip]["rankingSignals"]
        for name in (set(a) | set(b)) - {"lambda_mart"}:
            x, y = a.get(name, 0.0), b.get(name, 0.0)
            if abs(x - y) > MODEL_TOL.get(name, 1e-3 * max(1.0, abs(y))):
                raise AssertionError(f"signal {name} differs: {x} vs {y}")
        if not flip:
            err = max(err, abs(wk[ik]["score"] - wp[ip]["score"]))
            if abs(a.get("lambda_mart", 0.0) - b.get("lambda_mart", 0.0)) > 1e-5 * max(
                    1.0, abs(b.get("lambda_mart", 0.0))):
                raise AssertionError("lambda_mart differs on a row that walks the same leaves")
    if not flips.any():
        if {w["url"] for w in wp} != {w["url"] for w in wk}:
            raise AssertionError("the pages hold other documents")
        ids = {w["url"]: i for i, w in enumerate(wp)}
        err = max(err, topk_match(np.array([ids[w["url"]] for w in wp]),
                                  np.array([w["score"] for w in wp]),
                                  np.array([ids[w["url"]] for w in wk]),
                                  np.array([w["score"] for w in wk]), -1, *PIPE_SCORE_TOL))
    return err, int(flips.sum())


def compare_phase(searcher, forest=None) -> dict:
    """Top-10 of 8 queries: kernels against the plain versions, same card.
    With the pipeline on (`forest` given), pages carry their signals and
    compare through compare_pipeline_page."""
    import numpy as np

    from stract_tpu_torch.searcher.query import SearchQuery

    extra = {"numResults": 10, "returnRankingSignals": forest is not None}
    bodies = compare_bodies()
    kern = [searcher.search(SearchQuery.from_json({**b, **extra})).to_json() for b in bodies]
    with plain_versions():
        plain = [searcher.search(SearchQuery.from_json({**b, **extra})).to_json()
                 for b in bodies]
    err, n, flipped = 0.0, 0, 0
    for pk, pp in zip(kern, plain):
        wk, wp = pk["webpages"], pp["webpages"]
        if forest is not None:
            e, f = compare_pipeline_page(pp, pk, forest)
            err, flipped = max(err, e), flipped + f
        else:
            ids = {w["url"]: i for i, w in enumerate(wk + wp)}
            err = max(err, topk_match(np.array([ids[w["url"]] for w in wp]),
                                      np.array([w["score"] for w in wp]),
                                      np.array([ids[w["url"]] for w in wk]),
                                      np.array([w["score"] for w in wk]), -1, 1e-3, 1e-3))
        n += len(wk)
    if n == 0:
        raise AssertionError("the compared queries returned nothing")
    return {"queries": len(bodies), "docs": n, "max_score_diff": err, "forest_flips": flipped}


@contextlib.contextmanager
def join_timer():
    """Time the host factor join (InvertedIndex._slot_factors_for) while the
    block runs → {"calls", "seconds"}, summed over the server's threads."""
    import threading

    from stract_tpu_torch.index.inverted import InvertedIndex

    real = InvertedIndex.__dict__["_slot_factors_for"]
    acc, lock = {"calls": 0, "seconds": 0.0}, threading.Lock()

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real.__func__(*a, **kw)
        finally:
            dt = time.perf_counter() - t0
            with lock:
                acc["calls"] += 1
                acc["seconds"] += dt
    InvertedIndex._slot_factors_for = staticmethod(timed)
    try:
        yield acc
    finally:
        InvertedIndex._slot_factors_for = real


def compare_bodies() -> list:
    return [b for b in requests_mix(64) if "page" not in b][:8]


def top10_pages(searcher) -> list:
    """The top-10 page of each compare query, through the searcher."""
    from stract_tpu_torch.searcher.query import SearchQuery

    return [searcher.search(SearchQuery.from_json({**b, "numResults": 10})).to_json()["webpages"]
            for b in compare_bodies()]


def page_diff(wa, wb, rtol: float):
    """Two top-10 pages hold the same documents with the same scores: a
    document on both has scores within rtol (relative, of at least 1), and a
    document on one page only ties both pages' last scores within rtol (a
    tie at the cut may fall either way). → the largest score difference, or None
    where the pages differ."""
    if len(wa) != len(wb):
        return None
    sa, sb = ({w["url"]: w["score"] for w in page} for page in (wa, wb))
    close = lambda x, y: abs(x - y) <= rtol * max(abs(x), abs(y), 1.0)  # noqa: E731
    for mine, other in ((sa, sb), (sb, sa)):
        if any(not (close(s, min(mine.values())) and close(s, min(other.values())))
               for u, s in mine.items() if u not in other):
            return None
    if any(not close(sa[u], sb[u]) for u in sa.keys() & sb.keys()):
        return None
    return max((abs(sa[u] - sb[u]) for u in sa.keys() & sb.keys()), default=0.0)


def config_phase(index_dir: str, default_pages: list, card: str) -> dict:
    """Each configuration of CONFIGS: built through build_searcher, served one
    round of the request mix over HTTP (pipeline off) with the host join
    timed, its top-10 pages compared with the default configuration's, and
    freed before the next. The q16 device join must give all of the default's
    top-10s; the merge's top-10s must match its own plain versions'. →
    {name: record}."""
    import torch

    from stract_tpu_torch.main import build_searcher

    out = {}
    for name, (cfg, expect) in CONFIGS.items():
        t0 = time.perf_counter()
        searcher = build_searcher(index_dir, DEVICE, **cfg)
        index = searcher.searcher.searchers[0].index
        torch.cuda.synchronize()
        rows = index.device_segment_for(index.segments[0]).arrays.postings
        with join_timer() as jt:
            served = serve_phase(searcher, expect)
        pages = top10_pages(searcher)
        diffs = [page_diff(a, b, PAGE_RTOL) for a, b in zip(default_pages, pages)]
        same = sum(d is not None for d in diffs)
        rec = {"config": cfg, "qps": served["qps"], "p50_ms": served["p50_ms"],
               "p99_ms": served["p99_ms"], "requests": served["requests"], "failed": served["failed"],
               "postings_bytes": rows.numel() * 4, "postings_shape": list(rows.shape),
               "host_join_calls": jt["calls"], "host_join_s": jt["seconds"],
               "top10_equal_default": same, "compared": len(pages),
               "top10_max_score_diff": max((d for d in diffs if d is not None), default=None),
               "launches": {k: v for k, v in served["launches"].items() if v},
               "seconds": time.perf_counter() - t0}
        log(f"[config {name}] {json.dumps(rec)} card={card}")
        if cfg.get("device_join") and jt["calls"]:
            raise AssertionError("the device join still ran the host join")
        if name == "join" and same != len(pages):
            raise AssertionError(f"q16 device join: only {same} of {len(pages)} top-10 pages "
                                 "equal the default configuration's")
        if name == "merge":  # its pages against the same configuration's plain versions
            rec["vs_plain"] = compare_phase(searcher)
            log(f"[config merge] top-10 kernels vs plain versions: {json.dumps(rec['vs_plain'])} "
                f"card={card}")
        out[name] = rec
        del searcher, index, rows
        torch.cuda.empty_cache()
    return out


def config_kernel_phase(index_dir: str, dual_dir: str) -> tuple:
    """The device-only entry points driven once at the main shapes (launch
    counts reset just before, read just after): factors_join over stage A's
    candidates (held to the host join), compute_signals_batch over the slots'
    first L rows, rerank_topk_batch over the f16 title embeddings of stage
    B's top RERANK_K docs with the trained dual encoder's query embeddings
    (held to a numpy rerank). Then K1 on q8 rows, K1 with UB, K11 alone and
    inside stage B and pass 2, K12 and K10 against their plain versions on
    the same slots; then K13 at P = MERGE_P: the network's keys and payloads
    bit-equal to the plain merge's, the candidates at stage A's tolerance,
    and torch.sort of the keys with a gather of the payloads timed beside it.
    → (rows as kernel_phase's, launches of the driven calls, {kernel: the
    library call's ms})."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from stract_tpu_torch import bench_corpus as bc
    from stract_tpu_torch.index.device import DeviceSegment
    from stract_tpu_torch.index.inverted import InvertedIndex
    from stract_tpu_torch.models.dual_encoder import DualEncoder
    from stract_tpu_torch.ops import dense_rerank as R
    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch.ops import scoring as O
    from stract_tpu_torch.ranking.computer import QueryContext, build_slots

    index = InvertedIndex(index_dir, DEVICE)
    seg = index.segments[0]
    dev, dev8 = index.device_segment_for(seg), DeviceSegment(seg, DEVICE, "q8")
    nd = seg.num_docs
    T = lambda x, dt=torch.int32: torch.as_tensor(x, dtype=dt).to(DEVICE)  # noqa: E731
    queries = bc.sample_queries(np.random.default_rng(SEED), B)
    ctxs = [QueryContext(raw=q, simple_terms=q.split(), current_ts=NOW) for q in queries]
    slots = [build_slots(c, seg, index.num_docs, index.region_scores()) for c in ctxs]

    comp, Pc = compacted_slots(slots)
    qc_np = O.stack([q for q, _ in comp])
    qc, ac = O.to_tensors(qc_np, DEVICE), O.to_tensors(O.stack([a for _, a in comp]), DEVICE)

    def augmented(d):
        aug = [InvertedIndex._augment_with_impact(seg, d, q, L, 0.5) for q, _ in slots]
        return (O.to_tensors(O.stack([a[0] for a in aug]), DEVICE),
                T(np.stack([a[1] for a in aug]), torch.float32),
                T(np.array([a[2] for a in aug], dtype=np.float32), torch.float32))
    qa, ub, ubt = augmented(dev)
    qa8, ub8, ubt8 = augmented(dev8)
    if not (float(ubt.max()) > 0 and float(ubt8.max()) > 0):
        raise AssertionError("no sampled query has a truncated slot: UB would test nothing")
    scanned = int(qa.lens.clamp(max=L).sum())
    slot_bytes = sum(x.numel() * 4 for x in qa)

    # ---- the device-only entry points, once, counted --------------------------------
    cand, _ = O.score_candidates_batch(dev.arrays, qa, L, C, True, True)
    cand_np = cand.cpu().numpy()
    host = np.zeros((B, Pc, KD), np.int32)
    for j, (q, _) in enumerate(comp):
        InvertedIndex._slot_factors_for(seg, q, cand_np[j], out=host[j])
    sb_docs, sb_scores = O.score_driver_batch(dev.arrays, qc, T(host), cand, True, OUT_K)
    page = sb_docs[:, :512].contiguous()
    dual = DualEncoder.load(dual_dir, device=DEVICE)
    q_emb = torch.as_tensor(np.asarray(dual.embed(queries)), dtype=torch.float32).to(DEVICE)
    del dual
    top = sb_docs[:, :RERANK_K].cpu().numpy().astype(np.int64)
    real = top < nd
    title = seg.embeddings("title_embeddings")
    if title is None or title.dtype != np.float16:
        raise AssertionError("the corpus has no f16 title embedding column")
    emb = T(np.where(real[..., None], title[np.where(real, top, 0)], 0), torch.float16)
    base = sb_scores[:, :RERANK_K]
    base = torch.where(torch.isfinite(base), base, torch.full_like(base, -1e30))  # pad rows last
    torch.cuda.synchronize()
    kernels.reset_launches()
    joined = O.factors_join(dev.arrays, qc.starts, qc.lens, cand)
    prefix_sig = O.compute_signals_batch(dev.arrays, qc, ac, page, L)
    r_idx, r_scores = R.rerank_topk_batch(emb, q_emb, base, RERANK_W, RERANK_TOP)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if launches != dict.fromkeys(DIRECT, 1):
        raise AssertionError(f"the device-only entry points launched {launches}")
    if not np.array_equal(joined.cpu().numpy(), host):
        raise AssertionError("the device join differs from the host join")
    if not (torch.isfinite(prefix_sig).all() and bool((prefix_sig != 0).any())):
        raise AssertionError("prefix signals are empty or not finite")
    # a numpy rerank of the same inputs (f64 sums), ties to the lower index
    e64 = emb.cpu().numpy().astype(np.float64)
    norms = np.linalg.norm(e64, axis=2)
    sims = np.where(norms > 1e-6, np.einsum("bkh,bh->bk", e64, q_emb.cpu().numpy().astype(
        np.float64)) / np.maximum(norms, 1e-6), 0.0)
    total = base.cpu().numpy().astype(np.float64) + RERANK_W * sims
    ref_idx = np.argsort(-total, axis=1, kind="stable")[:, :RERANK_TOP]
    for b in range(B):
        topk_match(ref_idx[b], np.take_along_axis(total, ref_idx, 1)[b].astype(np.float32),
                   r_idx[b].cpu().numpy(), r_scores[b].cpu().numpy(), -1, 1e-5, 1e-5)

    rows = []
    def add(name, err, run_k, run_p, shape, nbytes, ops, iters=10):  # noqa: E306
        rows.append((name, True, err, time_ms(run_k), time_ms(run_p, iters), shape, nbytes, ops))

    # ---- K1 on q8 rows, K1 with UB ------------------------------------------------
    for name, arrays, q_, u_, t_, row_b in (("stage_a_q8", dev8.arrays, qa8, None, None, 8),
                                            ("stage_a_ub", dev.arrays, qa, ub, ubt, 12),
                                            ("stage_a_ub_q8", dev8.arrays, qa8, ub8, ubt8, 8)):
        run_k = lambda: O.score_candidates_batch(arrays, q_, L, C, True, True, u_, t_)  # noqa
        run_p = lambda: O.score_candidates_batch_plain(arrays, q_, L, C, True, True, u_, t_)  # noqa
        d_k, s_k = [x.cpu().numpy() for x in run_k()]
        d_p, s_p = [x.cpu().numpy() for x in run_p()]
        err = max(topk_match(d_p[b], s_p[b], d_k[b], s_k[b], nd, *A_TOL) for b in range(B))
        if not np.isfinite(s_k).any():
            raise AssertionError(f"{name} found no candidates")
        ub_bytes = 0 if u_ is None else 4 * (u_.numel() + t_.numel())
        add(name, err, run_k, run_p, (C, f"{row_b}B rows"),
            row_b * scanned + slot_bytes + ub_bytes + 8 * B * C, 10 * scanned)

    # ---- K11 alone: bit-equal to the plain join, on both layouts ---------------------
    lens = qc.lens.cpu().numpy().astype(np.int64)
    probes = int((np.ceil(np.log2(lens + 1)) * KD).sum())  # the compares this run's searches make
    found = int((joined != 0).sum())
    # bytes once: starts, lens, candidates; the doc word of each distinct row the
    # searches touch; the factor word of each row found
    join_in = 4 * (2 * B * Pc + B * KD) + 4 * search_rows(lens, KD) + 4 * found
    for arrays in (dev.arrays, dev8.arrays):
        f_k = O.factors_join(arrays, qc.starts, qc.lens, cand)
        if not torch.equal(f_k, O.factors_join_plain(arrays.postings, qc.starts, qc.lens, cand)):
            raise AssertionError("stract_factors_join differs from the plain join")
    add("factors_join", 0.0, lambda: O.factors_join(dev.arrays, qc.starts, qc.lens, cand),
        lambda: O.factors_join_plain(dev.arrays.postings, qc.starts, qc.lens, cand),
        KD, join_in + 4 * B * Pc * KD, probes, iters=3)

    # ---- joined stage B -------------------------------------------------------------
    run_k = lambda: O.score_driver_joined_batch(dev.arrays, qc, cand, True, OUT_K)  # noqa: E731
    run_p = lambda: O.score_driver_joined_batch_plain(dev.arrays, qc, cand, True, OUT_K)  # noqa
    (dk, sk), (dp, sp) = ([x.cpu().numpy() for x in r()] for r in (run_k, run_p))
    err = max(topk_match(dp[b], sp[b], dk[b], sk[b], nd, *B_TOL) for b in range(B))
    # and the host-joined verify (K2) bit for bit: the same factors folded in the
    # same order and sorted by the same network
    if not (np.array_equal(dk, sb_docs.cpu().numpy())
            and np.array_equal(sk, sb_scores.cpu().numpy())):
        raise AssertionError("joined stage B differs from stage B over the host join")
    add("stage_b_joined", err, run_k, run_p, KD,
        join_in + sum(x.numel() * 4 for x in qc) + 8 * B * OUT_K, probes + 10 * B * Pc * KD,
        iters=3)

    # ---- joined pass 2 at K = 512, K12 ------------------------------------------------
    lens_p = int((np.ceil(np.log2(lens + 1)) * 512).sum())
    found_p = int((O.factors_join(dev.arrays, qc.starts, qc.lens, page) != 0).sum())
    sig_bytes = (4 * B * 512 + sum(x.numel() * 4 for x in (*qc, *ac)) + 2 * B * 46 * 512
                 + 4 * B * 46)
    run_k = lambda: O.compute_signals_joined_batch_q16(dev.arrays, qc, ac, page)  # noqa: E731
    run_p = lambda: O.quantize_signals(  # noqa: E731
        O.compute_signals_joined_batch_plain(dev.arrays, qc, ac, page))
    (qk, sck), (qp, scp) = run_k(), run_p()
    torch.testing.assert_close(sck, scp, rtol=1e-5, atol=1e-35)
    step = int((qk.int() - qp.int()).abs().max().item())
    if step > 1:
        raise AssertionError(f"joined pass-2 q16 rows differ by {step} steps")
    err = float(np.abs(O.dequantize_signals(qk, sck) - O.dequantize_signals(qp, scp)).max())
    add("signals_joined", err, run_k, run_p, 512,
        sig_bytes + 4 * search_rows(lens, 512) + 4 * found_p,
        lens_p + 2 * 46 * B * Pc * 512, iters=3)

    steps = O._lookup_steps(L)
    run_k = lambda: O.compute_signals_batch(dev.arrays, qc, ac, page, L)  # noqa: E731
    run_p = lambda: O.compute_signals_batch_plain(dev.arrays, qc, ac, page, L)  # noqa: E731
    sig_k, sig_p = run_k(), run_p()
    torch.testing.assert_close(sig_k, sig_p, rtol=P12_TOL[0], atol=P12_TOL[1])
    n_slots = int((lens > 0).sum())
    found_l = int((O._slot_factor_lookup(*O._gather_packed(dev.arrays, qc, L), page, L)
                   != 0).sum())
    add("signals_prefix", float((sig_k - sig_p).abs().max()), run_k, run_p, 512,
        sig_bytes + 2 * B * 46 * 512 + 4 * search_rows(lens, 512, steps, cap=L) + 4 * found_l,
        n_slots * 512 * steps + 2 * 46 * B * Pc * 512, iters=3)

    # ---- K10 -------------------------------------------------------------------------
    run_k = lambda: R.rerank_topk_batch(emb, q_emb, base, RERANK_W, RERANK_TOP)  # noqa: E731
    run_p = lambda: R.rerank_topk_batch_plain(emb, q_emb, base, RERANK_W, RERANK_TOP)  # noqa
    (ik, rk), (ip, rp) = ([x.cpu().numpy() for x in r()] for r in (run_k, run_p))
    err = max(topk_match(ip[b], rp[b], ik[b], rk[b], -1, *RERANK_TOL) for b in range(B))
    H = emb.shape[2]
    add("dense_rerank", err, run_k, run_p, RERANK_K,
        2 * emb.numel() + 4 * (q_emb.numel() + base.numel()) + 8 * B * RERANK_TOP,
        4 * B * RERANK_K * H)
    e32 = emb.float()
    lib = time_ms(lambda: torch.topk(base + RERANK_W * torch.einsum(
        "bkh,bh->bk", F.normalize(e32, dim=2, eps=1e-6), q_emb), RERANK_TOP))
    log(f"[config kernels] K10 beside three PyTorch calls (normalize, einsum, topk; not one "
        f"call, so no library_ms): {lib:.3f} ms")

    # ---- K13: stage A through the merge network -----------------------------------
    qm = O.to_tensors(O.stack([pad_slots(InvertedIndex._augment_with_impact(seg, dev, q)[0],
                                         MERGE_P) for q, _ in slots]), DEVICE)
    N = MERGE_P * L
    kk, ck, ak = O.stage_a_network(dev.arrays, qm, L)
    keys, contrib, aux, _ = O._stage_a_entries(dev.arrays, qm, L)
    kp, (cp, ap) = O.merge_sorted_tiles_plain(keys, contrib, aux)
    if not (torch.equal(kk, kp) and torch.equal(ak, ap)
            and torch.equal(ck.view(torch.int32), cp.view(torch.int32))):
        raise AssertionError("the merge network's keys or payloads differ from the plain merge")
    ascending = int((kk[:, 1:] >= kk[:, :-1]).all(dim=1).sum())
    run_k = lambda: O.score_candidates_batch(dev.arrays, qm, L, C, True, True, merge=True)  # noqa
    run_p = lambda: O.score_candidates_batch_plain(dev.arrays, qm, L, C, True, True,  # noqa
                                                   merge=True)
    (d_k, s_k), (d_p, s_p) = ([x.cpu().numpy() for x in r()] for r in (run_k, run_p))
    err = max(topk_runs_match(d_p[b], s_p[b], d_k[b], s_k[b], nd, *A_TOL) for b in range(B))
    if not np.isfinite(s_k).any():
        raise AssertionError("the merge found no candidates")
    stages = sum(int(np.log2(2 * L * 2 ** r)) for r in range(int(np.log2(MERGE_P))))
    scanned_m = int(qm.lens.clamp(max=L).sum())
    add("stage_a_merge", err, run_k, run_p, (MERGE_P, L, C),
        12 * scanned_m + sum(x.numel() * 4 for x in qm) + 8 * B * C,
        B * (N // 2 * stages + 10 * N))
    kf, cf, af = (x.reshape(B, -1) for x in (keys, contrib, aux))

    def sort_gather():
        sk, perm = torch.sort(kf, dim=-1)
        return sk, cf.gather(1, perm), af.gather(1, perm)
    lib_ms = {"stage_a_merge": time_ms(sort_gather)}
    log(f"[config kernels] K13 at B={B} P={MERGE_P} L={L} C={C}: network bit-equal to the "
        f"plain merge; {ascending} of {B} queries' merged keys ascending (the others hold "
        f"tf-ordered impact slots); torch.sort + gather {lib_ms['stage_a_merge']:.3f} ms "
        f"(the same function only where every row ascends)")
    return rows, launches, lib_ms


def train_phase(index_dir: str, out_dir: str, tok) -> dict:
    """The encoder-training path: train_bench_encoders at its defaults with
    the cross encoder warm-started from the dual trunk, distilled from it and
    read out by the masked mean (the recipe the JAX package's records name:
    a CLS readout on the mean-pooled trunk stalls), on the card; launch
    counts reset just before and read just after. → {"dual", "cross":
    checkpoint dirs, "summary", "timing", "launches"}."""
    from stract_tpu_torch.entrypoint import train_bench_encoders as TBE
    from stract_tpu_torch.ops import kernels

    args = TBE.parser().parse_args(["--docs", str(DOCS), "--steps", str(TRAIN_STEPS),
                                    "--batch", str(TRAIN_B // 2), "--train-len",
                                    str(TRAIN_T), "--distill-cross", "--cross-pool", "mean",
                                    "--device", DEVICE])
    if args.steps != 400:
        log(f"[train] steps cut from the tool's 400 to {args.steps}")
    kernels.reset_launches()
    summary, timing = TBE.run(args, index_dir, out_dir, tokenizer=tok, log=log)
    launches = dict(kernels.LAUNCHES)
    log(f"[train] {json.dumps(summary)}")
    for kind in ("dual", "cross"):
        t = timing[kind]
        log(f"[train] {kind}: {t['steps']} steps in {t['seconds']:.1f}s: "
            f"{t['seconds'] / t['steps']:.4f} s/step, {t['steps'] / t['seconds']:.2f} steps/s; "
            f"loss {summary[f'{kind}_loss'][0]} -> {summary[f'{kind}_loss'][1]} "
            f"(mean of the first / last 10 steps)")
    log(f"[train] held-out pos>neg: dual {summary['dual_heldout_acc']}, cross "
        f"{summary['cross_heldout_acc']}; cross vs teacher spearman "
        f"{summary['cross_vs_teacher_spearman']}; launches {json.dumps(launches)}")
    if summary["dual_heldout_acc"] < MIN_DUAL_ACC:
        raise AssertionError(f"dual encoder held-out accuracy {summary['dual_heldout_acc']} "
                             f"is below {MIN_DUAL_ACC}")
    if any(launches[k] == 0 for k in TRAINING):
        raise AssertionError(f"a kernel was not launched by the training: {launches}")
    return {"dual": os.path.join(out_dir, f"dual_encoder-{DOCS}"),
            "cross": os.path.join(out_dir, f"cross_encoder-{DOCS}"),
            "summary": summary, "timing": timing, "launches": launches}


def models_phase(searcher, index_dir: str, out_dir: str) -> dict:
    """Tokenizer, MiniLM dual and cross encoders trained on the card (the
    train phase), and a forest trained on pipeline-off signal rows, saved
    through the port's writers. → the train phase's record plus {"forest":
    path, "rows": the forest's training matrix, "seconds"}."""
    import numpy as np

    from stract_tpu_torch import bench_corpus as bc
    from stract_tpu_torch.models.wordpiece import WordPieceTokenizer
    from stract_tpu_torch.ranking.models.lambdamart import LambdaMART, signal_matrix
    from stract_tpu_torch.searcher.query import SearchQuery

    t0 = time.perf_counter()
    seg = searcher.searcher.searchers[0].index.segments[0]
    rng = np.random.default_rng(SEED + 2)
    texts = []
    for d in rng.choice(seg.num_docs, size=min(TOK_DOCS, seg.num_docs), replace=False):
        stored = seg.stored_doc(int(d))
        texts.append(stored["title"] + " " + stored["clean_text"])
    texts += bc.sample_queries(rng, 2000)
    tok = WordPieceTokenizer.build(texts, vocab_size=VOCAB)
    log(f"[models] vocab of {len(tok.vocab)} pieces in {time.perf_counter() - t0:.1f}s")
    trained = train_phase(index_dir, out_dir, tok)
    forest_path = os.path.join(out_dir, "lambdamart.json")

    X, y = [], []
    for q in bc.sample_queries(np.random.default_rng(SEED + 3), FOREST_QUERIES):
        page = searcher.search(SearchQuery.from_json(
            {"query": q, "numResults": 20, "returnRankingSignals": True})).to_json()
        X.append(signal_matrix(page["webpages"]))
        for w in page["webpages"]:  # graded by title containment, as the bench's trainer
            hits = sum(t in w["title"].split() for t in q.split())
            y.append(2.0 ** (3.0 if hits == 2 else 2.0 if hits else 1.0) - 1.0)
    X = np.concatenate(X)[:2000]
    t1 = time.perf_counter()
    forest = LambdaMART.train(X, np.asarray(y)[:2000], num_trees=40, max_depth=3)
    with open(forest_path, "w") as fh:
        fh.write(forest.to_json())
    log(f"[models] forest of {forest.num_trees} trees on {len(X)} rows in "
        f"{time.perf_counter() - t1:.1f}s")
    return {**trained, "forest": forest_path, "rows": X, "seconds": time.perf_counter() - t0}


def model_kernel_phase(forest, rows) -> list:
    """K4 and K5a-c against their plain versions at the pipeline's shapes:
    the forest at K in FOREST_K over resampled training rows; attention at
    T in ATTN_T for a batch of ENC_B with one fully and one half masked row;
    LN and GELU at M = ENC_B x ENC_T. → rows (name, err, ms, plain ms, shape)."""
    import numpy as np
    import torch

    from stract_tpu_torch.ops import encoder as E
    from stract_tpu_torch.ops import forest as FO

    out = []
    rng = np.random.default_rng(SEED + 4)
    leaf_sum = float(forest.leaf_value.abs().max(dim=1).values.sum())
    for k in FOREST_K:
        x = torch.from_numpy(rows[rng.integers(0, len(rows), size=k)]).to(DEVICE)
        run_k = lambda: FO.gbdt_forward(*forest._arrays(), x, forest.max_depth)  # noqa: E731
        run_p = lambda: FO.gbdt_forward_plain(*forest._arrays(), x, forest.max_depth)  # noqa: E731
        a, b = run_k(), run_p()
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * leaf_sum)
        out.append(("forest", float((a - b).abs().max()), time_ms(run_k), time_ms(run_p), k))

    g = torch.Generator().manual_seed(SEED)
    bf = lambda *shape: torch.randn(shape, generator=g).to(DEVICE, torch.bfloat16)  # noqa: E731
    for t in ATTN_T:
        q, k, v = bf(ENC_B, t, 12, 32), bf(ENC_B, t, 12, 32), bf(ENC_B, t, 12, 32)
        mask = torch.ones((ENC_B, t), dtype=torch.int32)
        mask[1, t // 2:] = 0
        mask[2] = 0  # fully masked: uniform weights, finite
        mask = mask.to(DEVICE)
        run_k = lambda: E.attention(q, k, v, mask)  # noqa: E731
        run_p = lambda: E.attention_plain(q, k, v, mask)  # noqa: E731
        a, b = run_k().float(), run_p().float()
        if not torch.isfinite(a).all():
            raise AssertionError("attention gave a non-finite value")
        torch.testing.assert_close(a, b, rtol=ENC_TOL[0], atol=2 * ENC_TOL[1])
        out.append(("attention", float((a - b).abs().max()), time_ms(run_k), time_ms(run_p), t))

    m = ENC_B * ENC_T
    x, r = bf(m, 384), bf(m, 384)
    w = (1 + 0.1 * torch.randn(384, generator=g)).to(DEVICE)
    bias = (0.1 * torch.randn(384, generator=g)).to(DEVICE)
    run_k = lambda: E.add_layernorm(x, r, w, bias, 1e-12)  # noqa: E731
    run_p = lambda: E.add_layernorm_plain(x, r, w, bias, 1e-12)  # noqa: E731
    a, b = run_k().float(), run_p().float()
    torch.testing.assert_close(a, b, rtol=ENC_TOL[0], atol=ENC_TOL[1])
    out.append(("add_layernorm", float((a - b).abs().max()), time_ms(run_k), time_ms(run_p), m))

    y, yb = bf(m, 1536), (0.1 * torch.randn(1536, generator=g)).to(DEVICE, torch.bfloat16)
    run_k = lambda: E.bias_gelu(y, yb)  # noqa: E731
    run_p = lambda: E.bias_gelu_plain(y, yb)  # noqa: E731
    a, b = run_k().float(), run_p().float()
    torch.testing.assert_close(a, b, rtol=ENC_TOL[0], atol=ENC_TOL[1])
    out.append(("bias_gelu", float((a - b).abs().max()), time_ms(run_k), time_ms(run_p), m))
    return out


def _step_close(a, b) -> float:
    """Raise unless a is within one bf16 step of b's largest magnitude; →
    max |a - b|."""
    import torch

    a, b = a.float(), b.float()
    if not torch.isfinite(a).all():
        raise AssertionError("a kernel gave a non-finite value")
    torch.testing.assert_close(a, b, rtol=STEP, atol=STEP * float(b.abs().max()))
    return float((a - b).abs().max())


def training_kernel_phase(dual_dir: str) -> list:
    """K14a-d and K5d against their plain versions at the training shapes:
    attention backward at B=TRAIN_B, T=TRAIN_T with one fully and one half
    masked row; LN backward at TRAIN_B*TRAIN_T x 384; GELU backward at
    TRAIN_B*TRAIN_T x 1536; K5d forward + backward at TRAIN_B x TRAIN_T x 384;
    AdamW over the trained dual encoder's 22.7M parameters for 3 steps from
    the same state. → rows (name, err, ms, plain ms, shape)."""
    import torch

    from stract_tpu_torch import optim
    from stract_tpu_torch.models.store import load_encoder
    from stract_tpu_torch.ops import encoder as E

    out = []
    g = torch.Generator().manual_seed(SEED + 5)
    bf = lambda *shape: torch.randn(shape, generator=g).to(DEVICE, torch.bfloat16)  # noqa: E731
    B, T = TRAIN_B, TRAIN_T
    q, k, v, dout = bf(B, T, 12, 32), bf(B, T, 12, 32), bf(B, T, 12, 32), bf(B, T, 384)
    mask = torch.ones((B, T), dtype=torch.int32)
    mask[1, T // 2:] = 0
    mask[2] = 0
    mask = mask.to(DEVICE)
    run_k = lambda: E.attention_backward(q, k, v, mask, dout)  # noqa: E731
    run_p = lambda: E.attention_backward_plain(q, k, v, mask, dout)  # noqa: E731
    err = max(_step_close(a, b) for a, b in zip(run_k(), run_p()))
    out.append(("attention_backward", err, time_ms(run_k), time_ms(run_p), T))

    m = B * T
    x, r, dy = bf(m, 384), bf(m, 384), bf(m, 384)
    w = (1 + 0.1 * torch.randn(384, generator=g)).to(DEVICE)
    run_k = lambda: E.add_layernorm_backward(x, r, w, 1e-12, dy)  # noqa: E731
    run_p = lambda: E.add_layernorm_backward_plain(x, r, w, 1e-12, dy)  # noqa: E731
    (ds, dw, db), (ps, pw, pb) = run_k(), run_p()
    err = _step_close(ds, ps)
    for a, b in ((dw, pw), (db, pb)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))
        err = max(err, float((a - b).abs().max()))
    out.append(("add_layernorm_backward", err, time_ms(run_k), time_ms(run_p), m))

    y, gout = bf(m, 1536), bf(m, 1536)
    yb = (0.5 * torch.randn(1536, generator=g)).to(DEVICE, torch.bfloat16)
    run_k = lambda: E.bias_gelu_backward(y, yb, gout)  # noqa: E731
    run_p = lambda: E.bias_gelu_backward_plain(y, yb, gout)  # noqa: E731
    err = max(_step_close(a, b) for a, b in zip(run_k(), run_p()))
    out.append(("bias_gelu_backward", err, time_ms(run_k), time_ms(run_p), m))

    h, cot = bf(B, T, 384), torch.randn((B, 384), generator=g).to(DEVICE)

    def pool(fwd, bwd):
        pooled, raw = fwd(h, mask, True)
        return pooled, raw, bwd(mask, raw, cot, True, torch.bfloat16)
    run_k = lambda: pool(E.mean_pool_forward, E.mean_pool_backward)  # noqa: E731
    run_p = lambda: pool(E.mean_pool_plain, E.mean_pool_backward_plain)  # noqa: E731
    err = max(_step_close(a, b) for a, b in zip(run_k(), run_p()))
    out.append(("mean_pool", err, time_ms(run_k), time_ms(run_p), B * T))

    _, masters, _, _ = load_encoder(dual_dir, "dual")
    p0 = torch.cat([t.reshape(-1) for t in masters.values()]).to(DEVICE)
    n = p0.numel()
    grads = [torch.randn(n, generator=g).to(DEVICE) for _ in range(3)]

    def adamw(update, state):
        p, mo, ve = state
        for i, gr in enumerate(grads, 1):
            update(p, gr, mo, ve, 3e-4, 0.9, 0.999, 1e-8, 1e-4, 1 - 0.9 ** i, 1 - 0.999 ** i)
        return p, mo, ve
    fresh = lambda: (p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0))  # noqa: E731
    got, ref = adamw(optim.adamw_update, fresh()), adamw(optim.adamw_update_plain, fresh())
    err = 0.0
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max()))
        err = max(err, float((a - b).abs().max()))
    state = fresh()
    run_k = lambda: optim.adamw_update(state[0], grads[0], state[1], state[2], 3e-4, 0.9,  # noqa
                                       0.999, 1e-8, 1e-4, 0.1, 0.001)
    run_p = lambda: optim.adamw_update_plain(state[0], grads[0], state[1], state[2], 3e-4,  # noqa
                                             0.9, 0.999, 1e-8, 1e-4, 0.1, 0.001)
    out.append(("adamw", err, time_ms(run_k), time_ms(run_p), n))
    return out


def train_step_timing(tok, steps: int = 5) -> dict:
    """One whole dual-encoder train step (InfoNCE, B=TRAIN_B, T=TRAIN_T,
    MiniLM-L6 with the full vocab) with kernels and with plain versions, in
    turns (plain, kernels, kernels, plain) → ms per step of each."""
    import numpy as np
    import torch

    from stract_tpu_torch import bench_corpus as bc
    from stract_tpu_torch.models.bert import BertConfig, BertForEmbedding, random_init
    from stract_tpu_torch.optim import AdamW
    from stract_tpu_torch.parallel.train import info_nce_loss, train_step

    rng = np.random.default_rng(SEED + 6)
    queries = bc.sample_queries(rng, TRAIN_B)
    q_ids, q_mask, _ = tok.encode_batch(queries, TRAIN_T)
    d_ids, d_mask, _ = tok.encode_batch([" ".join(bc.sample_queries(rng, 20)) for _ in queries],
                                        TRAIN_T)
    batch = {k: torch.from_numpy(a).to(DEVICE) for k, a in
             (("q_ids", q_ids), ("q_mask", q_mask), ("d_ids", d_ids), ("d_mask", d_mask))}
    model = random_init(BertForEmbedding(BertConfig.mini_lm(vocab_size=VOCAB),
                                         param_dtype=torch.float32), SEED).to(DEVICE)
    opt = AdamW(model.parameters(), 3e-4)

    def timed():
        train_step(model, opt, batch, info_nce_loss)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            train_step(model, opt, batch, info_nce_loss)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    res = {"kernels": [], "plain": []}
    for kind in ("plain", "kernels", "kernels", "plain"):
        if kind == "plain":
            with plain_versions():
                res[kind].append(timed())
        else:
            res[kind].append(timed())
    return {k: min(v) for k, v in res.items()}


def moe_phase(index_dir: str, dual_dir: str, card: str) -> dict:
    """The MoE training path on the card: a MiniLM-L6 cross encoder (full
    width, the 30,522-piece vocab, mean readout) from
    make_train_state(num_experts=MOE_E), its shared trunk (embeddings,
    attention, LayerNorms) warm-started from the trained dual encoder as the
    smoke's cross recipe does, trained MOE_STEPS distilled steps of MOE_B
    pairs x TRAIN_T tokens from the smoke's triples with the dual teacher's
    scaled cosines as targets; launch counts reset just before and read just
    after. The same steps through the plain versions from the same start;
    one step timed in turns; K15a-d held against their plain versions at the
    step's shapes. → {"record", "rows" (as kernel_phase's), "launches",
    "library"}."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from stract_tpu_torch import optim
    from stract_tpu_torch.entrypoint.train_encoders import synthesize_triples
    from stract_tpu_torch.models.dual_encoder import DualEncoder
    from stract_tpu_torch.models.store import load_encoder
    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch.ops import losses as LO
    from stract_tpu_torch.ops import moe as MO
    from stract_tpu_torch.parallel.train import distill_loss, make_train_state, train_step

    t0 = time.perf_counter()
    triples = synthesize_triples(index_dir, 4096, seed=SEED)
    teacher = DualEncoder.load(dual_dir, device=DEVICE)
    tok = teacher.tokenizer
    rng = np.random.default_rng(SEED + 8)
    picks = [rng.integers(0, len(triples), MOE_B) for _ in range(MOE_STEPS)]
    used = sorted({int(j) for p in picks for j in p})
    qe, pe, ne = (np.asarray(teacher.embed([triples[j][i] for j in used])) for i in range(3))
    target = dict(zip(used, zip(TEACHER_SCALE * (qe * pe).sum(1), TEACHER_SCALE * (qe * ne).sum(1))))
    del teacher
    feeds = []
    for pick in picks:
        p = tok.encode_batch([(triples[j][0], triples[j][1]) for j in pick], TRAIN_T)
        n = tok.encode_batch([(triples[j][0], triples[j][2]) for j in pick], TRAIN_T)
        feed = {k: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE) for k, a in zip(
            ("pos_ids", "pos_mask", "pos_types", "neg_ids", "neg_mask", "neg_types"), (*p, *n))}
        for i, k in enumerate(("t_pos", "t_neg")):
            feed[k] = torch.tensor([target[int(j)][i] for j in pick], dtype=torch.float32,
                                   device=DEVICE)
        feeds.append(feed)
    d_cfg, masters, _, _ = load_encoder(dual_dir, "dual")
    cfg = dataclasses.replace(d_cfg, score_pool="mean")  # MiniLM-L6, the smoke's vocab
    trunk = {k: v for k, v in masters.items() if k.startswith("bert.")}

    def fresh():
        model, opt = make_train_state(cfg, MOE_LR, seed=SEED, num_experts=MOE_E, device=DEVICE)
        with torch.no_grad():  # into the optimizer's flat buffers, in place
            for name, prm in model.named_parameters():
                if name in trunk:
                    prm.copy_(trunk[name].to(prm.dtype))
        return model, opt

    def run():
        model, opt = fresh()
        torch.cuda.synchronize()
        kernels.reset_launches()
        losses = [float(train_step(model, opt, f, distill_loss, alpha=MOE_ALPHA)) for f in feeds]
        torch.cuda.synchronize()
        return losses, dict(kernels.LAUNCHES), model, opt

    losses_k, launches, model, opt = run()
    with plain_versions():
        losses_p, _, m_plain, _ = run()
    del m_plain
    if not np.isfinite(losses_k).all():
        raise AssertionError(f"the MoE steps gave a non-finite loss: {losses_k}")
    first, last = float(np.mean(losses_k[:5])), float(np.mean(losses_k[-5:]))
    if not last < first:
        raise AssertionError(f"the MoE loss did not fall: first 5 {first}, last 5 {last}")
    if any(launches[k] == 0 for k in MOE_KERNELS):
        raise AssertionError(f"a kernel was not launched by the MoE steps: {launches}")
    curve = max(abs(a - b) / abs(b) for a, b in zip(losses_k, losses_p))
    if curve > MOE_CURVE_RTOL:
        raise AssertionError(f"MoE loss curves differ by {curve:.3g} relative: {losses_k} vs "
                             f"{losses_p}")
    n_expert = sum(p.numel() for p in model.parameters() if p.dtype == torch.bfloat16)

    def timed():
        train_step(model, opt, feeds[0], distill_loss, alpha=MOE_ALPHA)  # warm-up
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for f in feeds[1:1 + MOE_TIMED]:
            train_step(model, opt, f, distill_loss, alpha=MOE_ALPHA)
        torch.cuda.synchronize()
        return (time.perf_counter() - t1) * 1e3 / MOE_TIMED
    step_ms = {"kernels": [], "plain": []}
    for kind in ("plain", "kernels", "kernels", "plain"):
        with plain_versions() if kind == "plain" else contextlib.nullcontext():
            step_ms[kind].append(timed())
    step_ms = {k: min(v) for k, v in step_ms.items()}

    # K15a-d against their plain versions at the step's shapes
    rows, library = [], {}
    g = torch.Generator().manual_seed(SEED + 9)
    N, H = MOE_B * TRAIN_T, cfg.hidden_size
    x = torch.randn((N, H), generator=g).to(DEVICE, torch.bfloat16)
    moe0 = model.bert.layer_0.moe
    w, b = moe0.router.weight.detach().contiguous(), moe0.router.bias.detach().contiguous()
    pk, tk, gk = MO.router_forward(x, w, b)
    pp, tp, gp = MO.router_plain(x, w, b)
    torch.testing.assert_close(pk, pp, rtol=1e-5, atol=1e-7)
    top2 = pp.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-5
    if not torch.equal(tk[clear], tp[clear]):
        raise AssertionError("the router kernel chose other experts")
    err = _step_close(gk, gp)
    dgate = torch.randn(N, generator=g).to(DEVICE, torch.bfloat16)
    (dlk, dxk), (dlp, dxp) = (MO.router_backward(pp, tp, dgate, w),
                              MO.router_backward_plain(pp, tp, dgate, w))
    torch.testing.assert_close(dlk, dlp, rtol=1e-5, atol=1e-6 * float(dlp.abs().max()))
    err = max(err, float((pk - pp).abs().max()), _step_close(dxk, dxp),
              float((dlk - dlp).abs().max()))
    Ex = MOE_E
    rows.append(("moe_router", True, err,
                 time_ms(lambda: (MO.router_forward(x, w, b), MO.router_backward(pp, tp, dgate, w))),
                 time_ms(lambda: (MO.router_plain(x, w, b),
                                  MO.router_backward_plain(pp, tp, dgate, w))),
                 (N, H, Ex),
                 2 * N * H + 4 * (Ex * H + Ex) + 4 * N * Ex + 4 * N + 2 * N  # forward
                 + 4 * N * Ex + 4 * N + 2 * N + 4 * Ex * H + 4 * N * Ex + 2 * N * H,  # backward
                 4 * N * H * Ex + 30 * N * Ex))
    out_e = torch.randn((Ex, N, H), generator=g).to(DEVICE, torch.bfloat16)
    gr = torch.randn((N, H), generator=g).to(DEVICE, torch.bfloat16)
    if not torch.equal(MO.select_scale_forward(out_e, tk, gk), MO.select_scale_plain(out_e, tk, gk)):
        raise AssertionError("select-and-scale differs from its plain version")
    (dk, dgk), (dp, dgp) = (MO.select_scale_backward(out_e, tk, gk, gr),
                            MO.select_scale_backward_plain(out_e, tk, gk, gr))
    if not torch.equal(dk, dp):
        raise AssertionError("the experts' cotangent differs from the plain version's")
    rows.append(("moe_select", True, _step_close(dgk, dgp),
                 time_ms(lambda: (MO.select_scale_forward(out_e, tk, gk),
                                  MO.select_scale_backward(out_e, tk, gk, gr))),
                 time_ms(lambda: (MO.select_scale_plain(out_e, tk, gk),
                                  MO.select_scale_backward_plain(out_e, tk, gk, gr))),
                 (Ex, N, H),
                 (2 * N * H + 6 * N + 2 * N * H)  # forward: the chosen rows, top, gate
                 + (4 * N * H + 6 * N + 2 * Ex * N * H + 2 * N),  # backward
                 N * H + 2 * N * H))
    sp_, sn_, tp_, tn_ = (torch.randn(MOE_B, generator=g).to(DEVICE) for _ in range(4))
    pair = (sp_, sn_, tp_, tn_, MOE_ALPHA)
    err = 0.0
    for a, c in zip(LO.pair_loss_forward(*pair), LO.pair_loss_plain(*pair)):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-7)
        err = max(err, float((a - c).abs().max()))
    logits = 20.0 * torch.randn((TRAIN_B, TRAIN_B), generator=g).to(DEVICE)
    for a, c in zip(LO.info_nce_forward(logits), LO.info_nce_plain(logits)):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-7)
        err = max(err, float((a - c).abs().max()))
    labels = torch.arange(TRAIN_B, device=DEVICE)
    library["loss_heads"] = time_ms(lambda: F.cross_entropy(logits, labels))
    rows.append(("loss_heads", True, err, time_ms(lambda: LO.info_nce_forward(logits)),
                 time_ms(lambda: LO.info_nce_plain(logits)), TRAIN_B,
                 4 * TRAIN_B * TRAIN_B * 2 + 4, 8 * TRAIN_B * TRAIN_B))
    pair_ms = time_ms(lambda: LO.pair_loss_forward(*pair))
    grp = opt.groups[torch.bfloat16]
    p0 = grp.flat.detach().clone()
    grads = [(0.01 * torch.randn(p0.numel(), generator=g)).to(DEVICE, torch.bfloat16)
             for _ in range(3)]

    def adamw(update):
        p, mo, ve = p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0)
        for i, gg in enumerate(grads, 1):
            update(p, gg, mo, ve, MOE_LR, 0.9, 0.999, 1e-8, 1e-4, 1 - 0.9 ** i, 1 - 0.999 ** i)
        return p, mo, ve
    err = 0.0
    for a, c in zip(adamw(optim.adamw_bf16_update), adamw(optim.adamw_bf16_update_plain)):
        torch.testing.assert_close(a.float(), c.float(), rtol=STEP, atol=1e-12)
        err = max(err, float((a.float() - c.float()).abs().max()))
    state = (p0.clone(), torch.zeros_like(p0), torch.zeros_like(p0))
    step_args = (MOE_LR, 0.9, 0.999, 1e-8, 1e-4, 0.1, 0.001)
    rows.append(("adamw_bf16", True, err,
                 time_ms(lambda: optim.adamw_bf16_update(state[0], grads[0], *state[1:],
                                                         *step_args)),
                 time_ms(lambda: optim.adamw_bf16_update_plain(state[0], grads[0], *state[1:],
                                                               *step_args)),
                 n_expert, 14 * n_expert, 25 * n_expert))
    steps_t = torch.ones((), device=DEVICE)
    library["adamw_bf16"] = time_ms(lambda: torch._fused_adamw_(
        [state[0]], [grads[0]], [state[1]], [state[2]], [], [steps_t], lr=MOE_LR, beta1=0.9,
        beta2=0.999, weight_decay=1e-4, eps=1e-8, amsgrad=False, maximize=False))
    rec = {"steps": MOE_STEPS, "pairs": MOE_B, "tokens": TRAIN_T, "experts": MOE_E,
           "expert_params": n_expert, "loss_first5": first, "loss_last5": last,
           "loss_kernels": losses_k, "loss_plain": losses_p, "curve_max_rel_diff": curve,
           "step_ms_kernels": step_ms["kernels"], "step_ms_plain": step_ms["plain"],
           "pair_head_ms": pair_ms, "seconds": time.perf_counter() - t0,
           "launches": {k: launches[k] for k in MOE_KERNELS}}
    log(f"[moe] {json.dumps(rec)} card={card}")
    log(f"[moe] K15c beside F.cross_entropy (the value only), K15d beside "
        f"torch._fused_adamw_ on the bf16 tensors (f32 math inside, one rounding per "
        f"tensor write: it rounds differently from optax's bf16 steps) card={card}")
    del model, opt
    return {"record": rec, "rows": rows, "launches": launches, "library": library}


def centrality_phase(data_dir: str) -> dict:
    """The webgraph centrality job: the benchmark graph (1M nodes, 20M
    Pareto edges, seed 0) written to disk, then `main.py centrality
    harmonic` and `approx-harmonic` (256 sources) on the card through the
    function the command line calls, launch counts reset just before each
    and read just after; each result checked (every node, finite, the kv
    store holds it) and, on a 2,000-node graph of the same recipe, held to
    the same job on the CPU. Then K6a, K6b and K7 against their plain
    versions at the job's shapes: registers and distances bit-equal round by
    round, sizes within rel 1e-6, and the whole HyperBall and the whole
    256-source BFS through the plain versions: the same round count,
    centrality within rtol 1e-6, distances equal. → {"jobs", "rows",
    "graph_s"}; rows (name, err, ms, plain ms, shape, bytes, ops)."""
    import numpy as np
    import torch

    from stract_tpu_torch.entrypoint import bench_centrality as BC
    from stract_tpu_torch.kv import Db
    from stract_tpu_torch.main import run_centrality
    from stract_tpu_torch.ops import hll_ops as HO
    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch.webgraph import centrality as WC
    from stract_tpu_torch.webgraph import shortest_path as SP
    from stract_tpu_torch.webgraph.csr import graph_in_csr

    def job_config(graph_dir: str, name: str) -> str:
        """A CentralityConfig TOML for the graph, its kv store cleared."""
        shutil.rmtree(os.path.join(data_dir, f"{name}-kv"), ignore_errors=True)
        path = os.path.join(data_dir, f"{name}.toml")
        with open(path, "w") as fh:
            fh.write(f'webgraph_path = "{graph_dir}"\noutput_path = "{data_dir}/{name}-kv"\n'
                     f"precision = 6\nnum_samples = {GRAPH_SAMPLES}\n")
        return path

    # a small graph of the same recipe: the card's job against the CPU's
    small = BC.write_bench_graph(os.path.join(data_dir, "graph-2000"), 2000, 40_000)
    for mode in ("harmonic", "approx-harmonic"):
        tc, tp = {}, {}
        on = run_centrality(mode, job_config(small.path, f"small-{mode}"), DEVICE, timings=tc)
        ref = run_centrality(mode, job_config(small.path, f"small-cpu-{mode}"), "cpu",
                             timings=tp)
        if tc["n_rounds"] != tp["n_rounds"] or list(on) != list(ref):
            raise AssertionError(f"{mode} on the card and the CPU differ: {tc} {tp}")
        np.testing.assert_allclose([on[k] for k in ref], list(ref.values()), rtol=1e-6,
                                   atol=1e-12)

    t0 = time.perf_counter()
    g = BC.write_bench_graph(os.path.join(data_dir, "graph"), GRAPH_NODES, GRAPH_EDGES)
    graph_s = time.perf_counter() - t0
    log(f"[centrality] graph of {g.num_nodes} nodes, {g.num_edges} edges on disk in "
        f"{graph_s:.1f}s")
    jobs = {}
    for mode, expect in (("harmonic", ("hll_merge", "hll_estimate")),
                         ("approx-harmonic", ("bfs_relax",))):
        cfg, timings = job_config(g.path, f"job-{mode}"), {}
        kernels.reset_launches()
        t0 = time.perf_counter()
        c = run_centrality(mode, cfg, DEVICE, timings=timings)
        seconds = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        vals = np.fromiter(c.values(), np.float64, len(c))
        if len(c) != g.num_nodes or not np.isfinite(vals).all() or vals.min() < 0 or \
                vals.max() <= 0:
            raise AssertionError(f"{mode}: {len(c)} values, range {vals.min()}..{vals.max()}")
        db = Db.open(os.path.join(data_dir, f"job-{mode}-kv"))
        name = g.name_of(int(np.argmax(vals)))
        if len(db) != g.num_nodes or db.get(name.encode())["centrality"] != c[name]:
            raise AssertionError(f"{mode}: the kv store does not hold the result")
        if any(launches[k] == 0 for k in expect):
            raise AssertionError(f"{mode}: a kernel was not launched by the job: {launches}")
        jobs[mode] = {"seconds": seconds, "timings": timings, "launches": launches,
                      "top": name, "top_value": float(vals.max())}
        log(f"[centrality] {mode}: {seconds:.2f}s {json.dumps(timings)} launches "
            f"{ {k: launches[k] for k in expect} } card={card_line()}")

    dev = torch.device(DEVICE)
    n, e = g.num_nodes, g.num_edges
    ef, et = SP.forward_edges(g)
    csr = graph_in_csr(g, dev)
    eft, ett = torch.from_numpy(ef).to(dev), torch.from_numpy(et).to(dev)
    rows = []

    # K6a (+K6b in its epilogue) over the first rounds, K6b alone
    regs = torch.from_numpy(HO.init_registers(n, 6)).to(dev)
    m = regs.shape[1]
    sizes_err = 0.0
    for _ in range(3):
        new, sizes, changed = HO.merge_csr(regs, csr)
        plain = HO.merge_iteration_plain(regs, eft, ett)
        ref = HO.estimate_sizes_plain(plain)
        if not torch.equal(new, plain) or int(changed.item()) != int(not torch.equal(plain, regs)):
            raise AssertionError("K6a registers differ from the plain merge")
        torch.testing.assert_close(sizes, ref, rtol=1e-6, atol=0)
        sizes_err = max(sizes_err, float(((sizes - ref).abs() / ref.abs()).max()))
        regs = new
    spare = torch.empty_like(regs)
    rows.append(("hll_merge", sizes_err, time_ms(lambda: HO.merge_csr(regs, csr, out=spare)),
                 time_ms(lambda: HO.merge_iteration_plain(regs, eft, ett), iters=3), (n, m, e),
                 2 * n * m + 4 * (n + 1) + 4 * e + 4 * csr.long_rows.numel() + 4 * n + 4,
                 e * m + 3 * n * m))
    est, ref = HO.estimate_sizes(regs), HO.estimate_sizes_plain(regs)
    torch.testing.assert_close(est, ref, rtol=1e-6, atol=0)
    rows.append(("hll_estimate", float(((est - ref).abs() / ref.abs()).max()),
                 time_ms(lambda: HO.estimate_sizes(regs)),
                 time_ms(lambda: HO.estimate_sizes_plain(regs)), (n, m), n * m + 4 * n,
                 3 * n * m))

    # the whole HyperBall through the kernels and through the plain versions
    hb = {}
    for plain_run in (False, True):
        t = {}
        with plain_versions() if plain_run else contextlib.nullcontext():
            hb[plain_run] = (WC._hyperball(n, ef, et, 6, 64, DEVICE, timings=t, csr=csr), t)
    (acc_k, t_k), (acc_p, t_p) = hb[False], hb[True]
    if t_k["n_rounds"] != t_p["n_rounds"]:
        raise AssertionError(f"HyperBall rounds differ: {t_k['n_rounds']} vs {t_p['n_rounds']}")
    np.testing.assert_allclose(acc_k, acc_p, rtol=1e-6, atol=1e-12)
    log(f"[centrality] whole HyperBall, kernels vs plain: {t_k['n_rounds']} rounds each, "
        f"rounds {t_k['rounds']:.3f}s vs {t_p['rounds']:.3f}s, max rel diff "
        f"{float(np.max(np.abs(acc_k - acc_p) / np.maximum(np.abs(acc_p), 1e-300))):.3g}")

    # K7 at S = GRAPH_SAMPLES and S = 1, round by round from the sampled sources
    sources = np.random.default_rng(0).choice(n, size=GRAPH_SAMPLES, replace=False)
    for S in (GRAPH_SAMPLES, 1):
        dist = torch.full((S, n), int(SP.UNREACHABLE), dtype=torch.int32, device=dev)
        dist[torch.arange(S, device=dev), torch.from_numpy(sources[:S]).to(dev)] = 0
        for _ in range(3):
            new, changed = SP.relax(dist.t().contiguous(), csr)
            plain = SP.relax_plain(dist, eft, ett)
            if not torch.equal(new.t(), plain) or \
                    int(changed.item()) != int(not torch.equal(plain, dist)):
                raise AssertionError(f"K7 distances differ from the plain relaxation at S={S}")
            dist = plain
        dns = dist.t().contiguous()
        out = torch.empty_like(dns)
        rows.append(("bfs_relax", 0.0, time_ms(lambda: SP.relax(dns, csr, out=out)),
                     time_ms(lambda: SP.relax_plain(dist, eft, ett), iters=3), (n, S, e),
                     8 * n * S + 4 * (n + 1) + 4 * e + 4 * csr.long_rows.numel() + 4,
                     2 * e * S))
    t_k, t_p = {}, {}
    d_k = SP.bfs(n, ef, et, sources, device=DEVICE, csr=csr, timings=t_k)
    with plain_versions():
        d_p = SP.bfs(n, ef, et, sources, device=DEVICE, csr=csr, timings=t_p)
    if t_k["n_rounds"] != t_p["n_rounds"] or not np.array_equal(d_k, d_p):
        raise AssertionError("the 256-source BFS through K7 and through the plain version differ")
    log(f"[centrality] whole {GRAPH_SAMPLES}-source BFS, kernels vs plain: {t_k['n_rounds']} "
        f"rounds each, {t_k['rounds']:.3f}s vs {t_p['rounds']:.3f}s, distances equal")
    return {"jobs": jobs, "rows": rows, "graph_s": graph_s}


# the card's published peaks (NVIDIA H100 SXM data sheet, dense): HBM bytes/s,
# bf16 tensor-core FLOP/s, f32 (and integer) FLOP/s outside the tensor cores
PEAK_BYTES, PEAK_BF16, PEAK_F32 = 3.35e12, 989e12, 67e12


def bound(nbytes: float, ops: float, peak: float = PEAK_F32) -> tuple:
    """The least time the card could take: bytes moved once over the memory
    rate, or the operations over their peak, whichever is larger → (ms, "bytes"
    or "operations")."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak
    return (1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def library_phase() -> dict:
    """The time of one PyTorch call that computes the function of a kernel,
    where one exists, at the kernel's main shape (used nowhere in the port):
    K5a scaled_dot_product_attention with the additive mask, K14a its
    backward through autograd, K5b layer_norm over the sum, K5c the tanh GELU
    over the sum, K14d torch._fused_adamw_ (what AdamW(fused=True) calls). →
    {kernel: ms}."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(SEED + 7)
    bf = lambda *shape: torch.randn(shape, generator=g).to(DEVICE, torch.bfloat16)  # noqa: E731
    out = {}

    def sdpa(B, T):
        q, k, v = (bf(B, 12, T, 32) for _ in range(3))
        mask = torch.zeros((B, 1, 1, T), dtype=torch.bfloat16, device=DEVICE)
        mask[1, ..., T // 2:] = torch.finfo(torch.float32).min
        return q, k, v, mask
    q, k, v, mask = sdpa(ENC_B, ENC_T)
    out["attention"] = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
    q, k, v, mask = sdpa(TRAIN_B, TRAIN_T)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    do = torch.randn(o.shape, generator=g).to(DEVICE, torch.bfloat16)
    out["attention_backward"] = time_ms(
        lambda: torch.autograd.grad(o, (q, k, v), do, retain_graph=True))
    m = ENC_B * ENC_T
    x, r = bf(m, 384), bf(m, 384)
    w, b = torch.ones(384, device=DEVICE), torch.zeros(384, device=DEVICE)
    out["add_layernorm"] = time_ms(lambda: F.layer_norm(x + r, (384,), w.to(x.dtype),
                                                        b.to(x.dtype), 1e-12))
    y, yb = bf(m, 1536), bf(1536)
    out["bias_gelu"] = time_ms(lambda: F.gelu(y + yb, approximate="tanh"))
    n = 22_565_376
    p, gr, mo, ve = (torch.randn(n, generator=g).to(DEVICE) for _ in range(4))
    ve.abs_()
    steps = torch.ones((), device=DEVICE)
    out["adamw"] = time_ms(lambda: torch._fused_adamw_(
        [p], [gr], [mo], [ve], [], [steps], lr=3e-4, beta1=0.9, beta2=0.999,
        weight_decay=1e-4, eps=1e-8, amsgrad=False, maximize=False))
    return out


def kernel_records(rows, rows_m, cent, library, serve_launches, train_launches, forest,
                   card, config_launches, moe_launches) -> list:
    """Every kernel's entry of the `kernels` line: its largest error against
    the plain version; its time, the plain version's, the bound and the
    library call's at the main shape; its launches in the run of its own
    path, named under "path" (training for the training kernels and the pool,
    the centrality jobs for the graph kernels, its configuration's HTTP round
    for the configurations' kernels, one direct call for the DIRECT three,
    the MoE steps for K15a-d, the pipeline-on traffic for the rest). Each
    measured row is logged too."""
    all_rows = [(name, err, ms, pms, shape, *bound(nb, ops), ds)
                for name, ds, err, ms, pms, shape, nb, ops in rows]
    all_rows += [(name, err, ms, pms, shape, *bound(*work(name, shape, forest)), True)
                 for name, err, ms, pms, shape in rows_m]
    all_rows += [(name, err, ms, pms, shape, *bound(nb, ops), True)
                 for name, err, ms, pms, shape, nb, ops in cent["rows"]]
    for name, err, ms, pms, shape, bms, by, ds in all_rows:
        log(f"[kernel] {name:13s} default_static={ds!s:5s} shape={shape} max_abs_err={err:.3g} "
            f"tolerance=({TOL_TEXT[name]}) kernel={ms:.3f} ms plain={pms:.3f} ms "
            f"bound={bms:.4f} ms ({by}) library={library.get(name)} card={card}")

    src, enc = "stract_tpu_torch/csrc/", "stract_tpu_torch/ops/encoder.py"
    step = "stract_tpu/entrypoint/train_encoders.py:244"
    meta = {"stage_a": ("cuda", src + "scoring.cu", "stract_tpu/ops/scoring.py:807", C),
            "stage_b": ("cuda", src + "scoring.cu", "stract_tpu/ops/scoring.py:660", KD),
            "signals_q16": ("cuda", src + "scoring.cu", "stract_tpu/ops/scoring.py:886", 512),
            "stage_a_q8": ("cuda", src + "scoring.cu", "stract_tpu/ops/scoring.py:162", None),
            "stage_a_ub": ("cuda", src + "scoring.cu", "stract_tpu/ops/scoring.py:837",
                           (C, "12B rows")),
            "factors_join": ("cuda", src + "scoring.cu", "stract_tpu/ops/scoring.py:749", KD),
            "stage_b_joined": ("cuda", src + "scoring.cu", "stract_tpu/ops/scoring.py:770", KD),
            "signals_joined": ("cuda", src + "scoring.cu", "stract_tpu/ops/scoring.py:894", 512),
            "signals_prefix": ("cuda", src + "scoring.cu", "stract_tpu/ops/scoring.py:859", 512),
            "dense_rerank": ("cuda", src + "scoring.cu", "stract_tpu/ops/dense_rerank.py:31",
                             RERANK_K),
            "forest": ("cuda", src + "forest.cu",
                       "stract_tpu/ranking/models/lambdamart.py:195", FOREST_K[-1]),
            "attention": ("cuda", src + "encoder.cu", "stract_tpu/models/bert.py:97", ENC_T),
            "add_layernorm": ("triton", enc, "stract_tpu/models/bert.py:164", ENC_B * ENC_T),
            "bias_gelu": ("triton", enc, "stract_tpu/models/bert.py:170", ENC_B * ENC_T),
            "mean_pool": ("triton", enc, "stract_tpu/models/bert.py:222", TRAIN_B * TRAIN_T),
            "attention_backward": ("cuda", src + "encoder.cu", step, TRAIN_T),
            "add_layernorm_backward": ("triton", enc, step, TRAIN_B * TRAIN_T),
            "bias_gelu_backward": ("triton", enc, step, TRAIN_B * TRAIN_T),
            "adamw": ("triton", "stract_tpu_torch/optim.py", step, None),
            "hll_merge": ("cuda", src + "graph.cu", "stract_tpu/ops/hll_ops.py:50", None),
            "hll_estimate": ("cuda", src + "graph.cu", "stract_tpu/ops/hll_ops.py:64", None),
            "bfs_relax": ("cuda", src + "graph.cu", "stract_tpu/webgraph/shortest_path.py:21",
                          (GRAPH_NODES, GRAPH_SAMPLES)),
            "stage_a_merge": ("cuda", src + "scoring.cu", "stract_tpu/ops/scoring.py:286",
                              (MERGE_P, L, C)),
            "moe_router": ("cuda", src + "moe.cu", "stract_tpu/models/bert.py:124", None),
            "moe_select": ("triton", "stract_tpu_torch/ops/moe.py",
                           "stract_tpu/models/bert.py:151", None),
            "loss_heads": ("triton", "stract_tpu_torch/ops/losses.py",
                           "stract_tpu/entrypoint/train_encoders.py:249", None),
            "adamw_bf16": ("triton", "stract_tpu_torch/optim.py",
                           "stract_tpu/parallel/train.py:36", None)}
    out = []
    for name, (route, source, replaces, main_shape) in meta.items():
        mine = [r for r in all_rows if r[0] == name]
        main_row = next(r for r in mine if r[7] and main_shape in (
            None, r[4], r[4][:2] if isinstance(r[4], tuple) else None))
        if name in DIRECT:
            launches, path = config_launches[name], "direct call: no entry point reaches it"
        elif name in MOE_KERNELS[:4]:
            launches, path = moe_launches[name], "training: the MoE cross encoder's steps"
        elif name in config_launches:
            launches, path = config_launches[name], "http, pipeline off, its configuration"
        elif name in TRAINING[3:]:
            launches, path = train_launches[name], "training"
        elif name == "bfs_relax":
            launches = cent["jobs"]["approx-harmonic"]["launches"][name]
            path = "centrality approx-harmonic"
        elif name.startswith("hll"):
            launches, path = cent["jobs"]["harmonic"]["launches"][name], "centrality harmonic"
        else:
            launches, path = serve_launches[name], "http, pipeline on"
        out.append({"name": name, "route": route, "source": source, "replaces": replaces,
                    "launches": launches, "path": path, "max_abs_err": max(r[1] for r in mine),
                    "ms": main_row[2], "plain_ms": main_row[3], "bound_ms": main_row[5],
                    "bound_by": main_row[6], "library_ms": library.get(name)})
    return out


def work(name: str, shape, forest=None) -> tuple:
    """(bytes, operations, peak) of one call of a kernel of the ranking
    pipeline or the training step at its main-path shape: each input read
    once, each output written once; bf16 products at the tensor-core peak."""
    H, F_ = 384, 1536
    if name == "forest":  # K = shape rows of 46 features; the forest's arrays once
        T, N = forest.feature.shape
        return 4 * shape * 47 + 16 * T * N + 4 * forest.leaf_value.numel(), \
            2 * shape * T * forest.max_depth, PEAK_F32
    if name == "attention":  # B=ENC_B, T=shape, 12 heads x 32
        return 4 * ENC_B * shape * H * 2 + 4 * ENC_B * shape, \
            4 * ENC_B * 12 * shape * shape * 32, PEAK_BF16
    if name == "attention_backward":  # B=TRAIN_B, T=shape; ~7 T^2 d multiply-adds per head
        return 7 * TRAIN_B * shape * H * 2 + 4 * TRAIN_B * shape, \
            14 * TRAIN_B * 12 * shape * shape * 32, PEAK_BF16
    if name == "add_layernorm":
        return 3 * shape * H * 2 + 8 * H, 8 * shape * H, PEAK_F32
    if name == "add_layernorm_backward":
        return 4 * shape * H * 2 + 12 * H, 12 * shape * H, PEAK_F32
    if name == "bias_gelu":
        return 2 * shape * F_ * 2 + 2 * F_, 20 * shape * F_, PEAK_F32
    if name == "bias_gelu_backward":
        return 3 * shape * F_ * 2 + 4 * F_, 40 * shape * F_, PEAK_F32
    if name == "mean_pool":  # forward + backward over TRAIN_B rows of TRAIN_T tokens
        return 2 * shape * H * 2 + 8 * shape + 4 * TRAIN_B * H * 4, 4 * shape * H, PEAK_F32
    if name == "adamw":  # p, g, m, v in; p, m, v out
        return 28 * shape, 15 * shape, PEAK_F32
    raise KeyError(name)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from stract_tpu_torch import bench_corpus as bc
    from stract_tpu_torch import native
    from stract_tpu_torch.index.embeddings import write_embedding_columns
    from stract_tpu_torch.main import build_searcher
    from stract_tpu_torch.models.dual_encoder import DualEncoder
    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch.ranking.models.lambdamart import LambdaMART

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    t_start = t = time.perf_counter()
    kernels.build(verbose=True)
    if not native.available():  # else the host factor join drops to Python
        raise RuntimeError("the native host library (native/) did not build or load")
    log(f"[setup] kernels and the native host library built in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    data_dir = os.path.join(ROOT, "data", "torch_smoke")
    index_dir = bc.ensure_corpus(data_dir, DOCS, seed=SEED, log=log)
    log(f"[setup] corpus ready in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    searcher = build_searcher(index_dir, DEVICE)
    index = searcher.searcher.searchers[0].index
    torch.cuda.synchronize()
    log(f"[setup] index on the card in {time.perf_counter() - t:.1f}s; "
        f"{torch.cuda.memory_allocated() / 2**20:.0f} MiB held")

    # ---- pipeline off: K1-K3 --------------------------------------------------------
    rows = kernel_phase(index, DEVICE)
    torch.cuda.reset_peak_memory_stats()
    with join_timer() as join_off:
        served_off = serve_phase(searcher, SCORING)
    log(f"[serve off] {json.dumps(served_off)}")
    log(f"[serve off] host factor join: {join_off['calls']} calls, {join_off['seconds']:.3f} s "
        f"of the round's {served_off['wall_s']:.3f} s")
    default_pages = top10_pages(searcher)
    cmp = compare_phase(searcher)
    log(f"[compare off] top-10 kernels vs plain versions: {json.dumps(cmp)}")
    log(f"[result off] docs={DOCS} qps={served_off['qps']:.2f} "
        f"p50_ms={served_off['p50_ms']:.1f} p99_ms={served_off['p99_ms']:.1f} "
        f"device_mem_peak_MiB={torch.cuda.max_memory_allocated() / 2**20:.0f} card={card}")

    # ---- training, then pipeline on: models, embedding columns, K4 + K5a-d, K14a-d ---
    models = models_phase(searcher, index_dir, os.path.join(data_dir, "models"))
    dual = DualEncoder.load(models["dual"], device=DEVICE)
    emb = write_embedding_columns(index_dir, dual, batch=EMB_BATCH, log=log)
    torch.cuda.synchronize()
    log(f"[embeddings] {emb['docs']} docs x {emb['dim']} in {emb['seconds']:.1f}s: "
        f"{emb['docs'] / emb['seconds']:.0f} docs/s card={card}")
    tok = dual.tokenizer
    del dual
    forest = LambdaMART.load(models["forest"], device=DEVICE)
    rows_m = model_kernel_phase(forest, models["rows"]) + training_kernel_phase(models["dual"])
    library = library_phase()
    step_ms = train_step_timing(tok)
    log(f"[train step] dual InfoNCE step B={TRAIN_B} T={TRAIN_T}: kernels "
        f"{step_ms['kernels']:.2f} ms, plain versions {step_ms['plain']:.2f} ms card={card}")
    del searcher
    torch.cuda.empty_cache()
    on = build_searcher(index_dir, DEVICE, dual_encoder=models["dual"],
                        cross_encoder=models["cross"], lambdamart=models["forest"])
    torch.cuda.reset_peak_memory_stats()
    served = serve_phase(on, SERVING, rounds=SERVE_ON_ROUNDS)
    log(f"[serve on] {json.dumps(served)}")
    cmp_on = compare_phase(on, forest=on.pipeline.recall.lambdamart)
    log(f"[compare on] top-10 kernels vs plain versions: {json.dumps(cmp_on)}")
    log(f"[result on] docs={DOCS} rounds={served['rounds']} qps={served['qps']:.2f} "
        f"p50_ms={served['p50_ms']:.1f} p99_ms={served['p99_ms']:.1f} device_mem_peak_MiB="
        f"{torch.cuda.max_memory_allocated() / 2**20:.0f} device_mem_held_MiB="
        f"{torch.cuda.memory_allocated() / 2**20:.0f} embed_docs_per_s="
        f"{emb['docs'] / emb['seconds']:.0f} card={card}")
    del on
    torch.cuda.empty_cache()

    # ---- the other configurations: q8 rows, device join, UB; K11, K12, K10 ------------
    t = time.perf_counter()
    configs = config_phase(index_dir, default_pages, card)
    for name, rec in configs.items():
        log(f"[result config {name}] qps={rec['qps']:.2f} (default {served_off['qps']:.2f}) "
            f"p50_ms={rec['p50_ms']:.1f} p99_ms={rec['p99_ms']:.1f} failed={rec['failed']} "
            f"postings_MB={rec['postings_bytes'] / 1e6:.0f} host_join_s={rec['host_join_s']:.3f} "
            f"(default {join_off['seconds']:.3f}) top10_equal_default="
            f"{rec['top10_equal_default']}/{rec['compared']} card={card}")
    t_cfg = time.perf_counter() - t
    t = time.perf_counter()
    rows_c, ops_launches, lib_c = config_kernel_phase(index_dir, models["dual"])
    torch.cuda.empty_cache()
    config_launches = {"stage_a_q8": configs["q8"]["launches"]["stage_a_q8"],
                       "stage_a_ub": configs["ub"]["launches"]["stage_a_ub"],
                       "stage_b_joined": configs["join"]["launches"]["stage_b_joined"],
                       "signals_joined": configs["join"]["launches"]["signals_joined"],
                       "stage_a_merge": configs["merge"]["launches"]["stage_a_merge"],
                       **ops_launches}
    log(f"[configs] {len(CONFIGS)} configurations served in {t_cfg:.1f}s, their kernels held "
        f"against the plain versions in {time.perf_counter() - t:.1f}s")

    # ---- the MoE training path: K15a-d ------------------------------------------------
    moe = moe_phase(index_dir, models["dual"], card)
    torch.cuda.empty_cache()
    rec = moe["record"]
    log(f"[result moe] experts={MOE_E} steps={MOE_STEPS} pairs={MOE_B} tokens={TRAIN_T} "
        f"loss_first5={rec['loss_first5']:.4f} loss_last5={rec['loss_last5']:.4f} "
        f"curve_max_rel_diff_vs_plain={rec['curve_max_rel_diff']:.3g} step_ms_kernels="
        f"{rec['step_ms_kernels']:.2f} step_ms_plain={rec['step_ms_plain']:.2f} "
        f"seconds={rec['seconds']:.1f} card={card}")
    library.update(lib_c)
    library.update(moe["library"])

    # ---- the webgraph centrality job: K6a-b, K7 --------------------------------------
    cent = centrality_phase(os.path.join(data_dir, "centrality"))
    log(f"[result centrality] nodes={GRAPH_NODES} edges={GRAPH_EDGES} graph_s="
        f"{cent['graph_s']:.1f} harmonic_s={cent['jobs']['harmonic']['seconds']:.2f} "
        f"hyperball_rounds={cent['jobs']['harmonic']['timings']['n_rounds']} "
        f"approx_harmonic_s={cent['jobs']['approx-harmonic']['seconds']:.2f} "
        f"bfs_rounds={cent['jobs']['approx-harmonic']['timings']['n_rounds']} "
        f"total_s={time.perf_counter() - t_start:.1f} card={card}")

    kernels_out = kernel_records(rows + rows_c + moe["rows"], rows_m, cent, library,
                                 served["launches"], models["launches"], forest, card,
                                 config_launches, moe["launches"])
    print(card, flush=True)
    print(json.dumps({"kernels": kernels_out}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
