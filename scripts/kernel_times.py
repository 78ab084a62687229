#!/usr/bin/env python3
"""Times kernels of the PyTorch port on one NVIDIA card, each beside the
PyTorch call that computes the same function, and whole train steps, in
fresh processes over one or more checkouts:

    python3 scripts/kernel_times.py --runs parent,change,change,parent \
        [--tree parent=DIR] [--calls 50] [--readings attention_backward,bias_gelu]

Each entry of --runs names a checkout (`change` is this one; others come
from --tree NAME=DIR, e.g. a `git archive` of the parent commit unpacked
under data/). --readings picks groups (default all):
  attention           K5a at B = 32, 12 heads of 32, T in (16, 65, 128,
                      200, 256), row 1 half masked and row 2 fully masked,
                      beside scaled_dot_product_attention with an additive
                      bf16 mask;
  attention_backward  K14a at B = 64 (the training batch), the same heads,
                      T and masks, beside SDPA's backward through autograd
                      (torch.autograd.grad of its output, graph retained);
  attention_wide      K5a and K14a at B = 8, 12 heads of d, (d, T) in
                      ATTN_WIDE (BERT-base's head dim at 256 and 512
                      tokens, BertConfig.tiny's at 512), the masks above,
                      beside SDPA and its backward (a tree whose kernels
                      refuse the shape records the refusal);
  attention_long      K5a and K14a past 512 tokens at (B, T, heads, d) in
                      ATTN_LONG (B = 1: MiniLM's 12 heads of 32 at 2,048
                      tokens, 2 heads of 64 at 16,384), the row's last fifth
                      masked, beside SDPA and its backward (a tree whose
                      kernels refuse the shape records the refusal);
  mean_pool_long      K5d forward + backward at 8 x T x 384 for T in
                      POOL_LONG (lengths from a seed, the last row fully
                      masked; normalised), the refusal recorded as above;
  stage_attention     K16a at mb = 8 (the pipelined step's microbatch on
                      one dp shard), (T, H) in STAGE_SHAPES (the step's, the
                      one-tile form's old ends, past 1,024 keys and past
                      H = 1,024), beside
                      scaled_dot_product_attention in f32 over one head of
                      width H (matmuls in full f32: allow_tf32 off);
  stage_attention_backward
                      K16b at the same shapes, beside SDPA's f32 backward
                      (torch.autograd.grad of its output over q, k, v, one
                      head of width H, graph retained; allow_tf32 off);
  layernorm_backward  K14b at 8192 x N (the dual step's rows), N in
                      LN_WIDTHS (BertConfig.tiny's, MiniLM's, BERT-base's
                      width), beside the backward of F.layer_norm over the
                      f32 widened sum through autograd
                      (native_layer_norm_backward; chip_smoke.py's
                      layernorm_backward_library);
  loss_heads          K15c's InfoNCE head at B in INFO_NCE_B (the
                      train-encoders default 32, the dual step's 64, 128,
                      256; value and B x B gradient), beside F.cross_entropy
                      and its gradient (torch.autograd.grad; chip_smoke.py's
                      cross_entropy_library), and, on a tree that has both,
                      its one-block and grid forms (kernels.info_nce's
                      `blocks`: the crossover); its pair head at 32 pairs (the
                      cross encoder's and the MoE steps' batch), plain and
                      distilled, beside F.soft_margin_loss(s+ - s-, ones)
                      and its gradients (the plain head; chip_smoke.py's
                      soft_margin_library);
  bias_gelu_backward  K14c at (M, N) in GELU_BWD_SHAPES (the dual step's
                      8,192 x 1,536, BERT-base's 4 x 512 tokens x 3,072),
                      beside aten.gelu_backward (tanh) of y + b and the f32
                      column sum cast to bf16 (the bias add inside the timed
                      call; chip_smoke.py's bias_gelu_backward_library);
  bias_gelu           K5c at 4096 x 1536 (chip_smoke.py's shape), beside
                      F.gelu(y + b, approximate="tanh");
  layernorm           K5b at M x N, M in LN_ROWS (chip_smoke.py's 4,096
                      rows and the dual step's 8,192), N in LN_WIDTHS,
                      beside F.layer_norm of the sum widened to f32 with the
                      kernel's f32 weight and bias, cast to bf16 (the same
                      function; chip_smoke.py's layernorm_library: PyTorch's
                      CUDA layer_norm refuses a bf16 input with an f32
                      weight) and F.layer_norm(x + r) with the weight and
                      bias rounded to bf16 (fewer launches, another
                      function);
  mean_pool           K5d forward + backward at 64 x 128 x 384 (the dual
                      step's; normalised, row 1 half and row 2 fully
                      masked), and the forward alone at POOL_SERVE (32
                      queries of 32 tokens, normalised; lengths 8..32 from
                      a seed); no one PyTorch call computes either;
  gelu_tanh           K16c forward + backward at 8 x 128 x 1536 (the
                      pipelined step's FFN activation on one dp shard),
                      beside F.gelu(approximate="tanh") + its gradient
                      through autograd (chip_smoke.py's library call);
  bfs                 the whole SP.bfs from 256 sources (seed 0) on
                      bench_centrality.write_bench_graph's 1M-node, 20M-edge
                      graph (written once under data/kernel_times_graph),
                      the same arguments in both trees, with its round count
                      and its "rounds" seconds; and one round at
                      chip_smoke.py's row, the fourth (256 sources, after
                      three rounds): K7's relaxation in a tree that has
                      `SP.relax`, else the frontier step with seen put back
                      before each call (a copy, in the call's event time;
                      its device time by kernel apart);
  hyperball           on the same 1M / 20M graph: the whole WC._hyperball
                      (precision 6, to its fixpoint) and the whole 4-shard
                      WC._hyperball_sharded on Mesh([cuda:0] * 4), each with
                      its round count, its "rounds" seconds (two runs after
                      a warm-up) and the summed device time of its merge
                      launches (hll_merge_kernel: K6a's, or K8's on the
                      mesh) in a third, profiled run; then K6a from round
                      3's registers and K8 on the ring bucket (0, 1) from
                      round 3's shards, called without change bytes (the
                      same call in every tree) and, in a tree that has the
                      systolic round, with every byte set, with round 3's
                      bytes (the fourth round) and with none (all but the
                      gather);
  sgd                 K16d over the 25 f32 tensors of the pipelined train
                      step (6 stages of attn_qkv, attn_out, ffn_in, ffn_out
                      at H = 384, FFN = 1536, and the head), 10,617,216
                      entries, beside torch._foreach_add_;
  pipeline_step       that whole train step on a (pp=6, dp=2) mesh of the
                      card, 8 microbatches of 16 rows of 128 tokens (3 steps);
  moe                 the MoE FFN's router K15a, its whole VJP as the train
                      step takes it (ops/moe.py router forward, then
                      torch.autograd.grad of the gate over x, the router's
                      weight and bias: the backward kernel and, in a tree that
                      computes them in PyTorch, the parameter gradients), and
                      K15b select-and-scale forward + backward the same way
                      (over the experts' rows and the gate), at (N, H, E) in
                      MOE_SHAPES (the MoE step's 32 pairs x 128 tokens at
                      MiniLM's width and 4 experts; BERT-base's width with
                      16 experts);
  moe_step            one distilled step of make_train_state(MiniLM-L6, the
                      30,522-piece vocab, mean readout, num_experts=4) at 32
                      pairs x 128 tokens (random ids and lengths 8..128 from
                      a seed, random targets; 10 steps);
  dual_step           one dual-encoder InfoNCE train step (MiniLM-L6, the
                      full 30,522-piece vocab, B = 64 + 64, T = 128, random
                      ids and lengths 8..128 from a seed; chip_smoke.py's
                      train_step_timing shape; 10 steps);
  scoring             the shard search's kernels at chip_smoke.py's shapes on
                      its 1M-doc corpus (bench_corpus seed 0, built once under
                      data/kernel_times_corpus by this checkout and opened by
                      every tree) and its 32 sampled queries (default static
                      scores, soft required groups): K1 on q16 rows, on q8 rows
                      and with UB (ub_lambda 0.5) at L = 1,024, C = 4,096; K13
                      (stage A under the merge, the slots padded to P = 64;
                      in a tree whose plan takes another form there, also
                      through the global form, `K13_global`), its network
                      alone (the K = 0 launch, `K13_network`) on the
                      doc-ordered slots beside torch.sort of the same keys
                      and the gathers of their payloads, and K13 over 256
                      full-length slots a query (`K13_wide`, N = 262,144:
                      the select's keys past 2 blocks' shared memory); K2
                      at Kd = 4,096, k = 1,024, 64 fused signal columns over
                      the compacted slots (Pc = 16) and stage A's candidates
                      (the plain version's, the same in every tree); K3 at K =
                      512 and 128 over stage B's top K, with its inputs on the
                      card (`K3`) and with numpy slots, aggregates, factors
                      and candidates as index/inverted.py calls it
                      (`K3_main_path`); K9 at (n, K) = (4, 512), (4,
                      1,024), (8, 1,024), 16 queries. K1 and K2 are read
                      twice: with their inputs on the card (the kernel's call,
                      `K1`, `K2`) and with numpy slots, candidates and factors,
                      as index/inverted.py calls them (`K1_main_path`,
                      `K2_main_path`: the uploads in the call); each reading
                      names the entries of its largest query (`E_max`). K1
                      also over 64 full-length slots a query (`K1_full`, E =
                      P*L: the global table) and with one such query among
                      the 32 sampled (`K1_mixed`). In a tree that plans K1's
                      table and K2's clusters, K1 also over 2 and 8 blocks a
                      query and K2 over one block;
  join                K11, the device factor join, in its three forms on the
                      scoring group's corpus and queries: alone over the
                      compacted slots (Pc = 16) and stage A's candidates (the
                      plain version's, Kd = 4,096: `K11`); joined stage B at
                      Kd = 4,096, k = 1,024 (`K11_stage_b`); joined pass 2
                      in q16 rows over the plain joined stage B's top K = 512
                      and 128 (`K11_pass2`) and in f32 rows at K = 512
                      (`K11_pass2_f32`); each with its inputs on the card and
                      with numpy slots and candidates as index/inverted.py
                      calls it (`..._main_path`; the single-query f32 form
                      `K11_pass2_f32_single` at K = 128 so only); the slots'
                      lengths (`K11_slots`: quantiles, and how many are no
                      longer than 1, 2, 4, 8 and 16 x the candidates). In a
                      tree with a join plan (`kernels.join_plan`), also each
                      form at the sample sizes in JOIN_SAMPLES
                      (`..._plan_sample...`);
  forest              K4 at K = 256, 4,096 and 16,384 rows of 46 features
                      (seeded normal rows) through a 40-tree depth-3 forest
                      (LambdaMART.train on seeded rows, tests' _forest's
                      recipe), with x on the card (`K4`) and through
                      LambdaMART.predict on numpy rows (`K4_predict`: the
                      pad to a power of two and the copies in the call); in
                      a tree with a forest plan (`kernels.forest_plan`), K4
                      also over the row tiles in FOREST_TILES;
  mesh_merge          K9 at (n, K) = (4, 512), (4, 1,024), (8, 1,024), 16
                      queries, on chip_smoke.py's gathered lists (seed 0):
                      stacked (`K9`), per shard where the tree has
                      mesh_topk_lists (`K9_lists`), and through
                      parallel/search.py _merge as the mesh's serving path
                      calls it, the shards' [B, K] lists on one card
                      (`K9_merge`: the parent's stacks them first);
  prefix              K12 at chip_smoke.py's shape on the scoring group's
                      corpus and queries (compacted slots, Pc = 16, L =
                      1,024, K = 512 candidates from the plain joined stage
                      B), and over 64 full-length slots a query
                      (`K12_wide`), and in a tree with kernels.prefix_plan
                      under caps of 64, 256 and 512 candidates a block
                      (`K12_cands{c}`) and with the prefixes left in L2
                      (`K12_unstaged`);
  rerank              K10 at RERANK_SHAPES (B, K, H, k): chip_smoke.py's
                      32 x 1,024 x 384 f16, k = 20, and past 4,096
                      candidates, 4 x 5,000 x 384 f16, k = K (L2-normalised
                      seeded rows, a tenth zero; the parent refuses past
                      4,096 and records the refusal), beside the three
                      PyTorch calls that compute it (F.normalize, einsum,
                      torch.topk: `rerank_three_calls`, not one call);
  hll_estimate        K6b at 1M x 64 registers: on init_registers(1M, 6)
                      (`K6b`, linear counting's branch) and on seeded ranks
                      1..8 with no zero (`K6b_ranks`, the estimate's);
  forest_lightgbm     K4 at K = 16,384 rows of 46 features through LightGBM
                      dumps of (trees, leaves) in LGBM_FORESTS
                      (bench_corpus.synthetic_lightgbm, seeded; past a block's
                      shared memory: walked in chunks), at forest_plan's
                      plan and at the plans of rows in LGBM_ROWS and chunk
                      budgets in LGBM_BUDGETS (the most trees a chunk that
                      fit), `K4_rows{r}_smem{b}`; a tree without the
                      dump writer or whose kernel refuses the forest
                      records the refusal.
For each: `event_ms`, CUDA events around --calls calls (steps for the two
train steps) after 5 warm-ups (what the host can issue and the card finish:
the smoke's measure), and `device_ms`, the card's own time for one call,
the sum of the kernels' device time in a torch.profiler window over the
same number of calls ("not measured", null, when the profiler saw no
device time), with each kernel's part where a call runs two to four (and
for the BFS's and the HyperBall's readings always).
Prints the card's name and power limit, a JSON line a reading, and a JSON
summary last. Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATTN_B, ATTN_H, ATTN_T = 32, 12, (16, 65, 128, 200, 256)
TRAIN_B, TRAIN_T, VOCAB = 64, 128, 30522
GELU_M, GELU_N = 4096, 1536
ATTN_WIDE = ((64, 256), (64, 512), (16, 512))
STAGE_MB, STAGE_SHAPES = 8, ((128, 384), (512, 384), (128, 1024), (2048, 384), (128, 2048))
ATTN_LONG, POOL_LONG = ((1, 2048, 12, 32), (1, 16384, 2, 64)), (1024, 4096)
LN_WIDTHS = (64, 384, 768)
LN_ROWS = (4096, TRAIN_B * TRAIN_T)
POOL_SERVE = (32, 32, 384)
INFO_NCE_B, PAIR_B = (32, 64, 128, 256), 32
GELU_BWD_SHAPES = ((TRAIN_B * TRAIN_T, 1536), (4 * 512, 3072))
MOE_PAIRS, MOE_SHAPES = 32, ((32 * 128, 384, 4), (32 * 128, 768, 16))
READINGS = ("attention", "attention_backward", "attention_wide", "attention_long",
            "mean_pool_long", "forest_lightgbm", "stage_attention",
            "stage_attention_backward", "layernorm_backward", "loss_heads", "bias_gelu",
            "bias_gelu_backward", "layernorm", "mean_pool", "gelu_tanh", "bfs", "hyperball",
            "sgd", "pipeline_step", "dual_step", "moe", "moe_step", "scoring", "join",
            "forest", "mesh_merge", "prefix", "rerank", "hll_estimate")
GRAPH_NODES, GRAPH_EDGES, GRAPH_SAMPLES = 1_000_000, 20_000_000, 256
MESH_SHARDS = 4
PIPE_SIZES = [384 * 1152, 384 * 384, 384 * 1536, 1536 * 384] * 6 + [384]
LR = 5e-2
# the scoring reading: chip_smoke.py's corpus and shapes
CORPUS_DOCS, SCORE_B, SCORE_L, SCORE_C, SCORE_KD, SCORE_K, SCORE_SIG = (
    1_000_000, 32, 1024, 4096, 4096, 1024, 64)
PAGE_K, MERGE_P, MESH_B, MESH_SHAPES = 512, 64, 16, ((4, 512), (4, 1024), (8, 1024))
MERGE_WIDE_P = 256
# the prefix group's caps of candidates a block (K12's plan under each) and
# its wide case's slots a query
PREFIX_CANDS, PREFIX_WIDE_P = (64, 256, 512), 64
# the join group's plans: sample sizes of a slot; the forest group's rows,
# trees, depth and row tiles
JOIN_SAMPLES = (64, 256, 1024, 4096)
FOREST_ROWS, FOREST_TREES, FOREST_DEPTH, FOREST_TILES = (256, 4096, 16384), 40, 3, (8, 16, 32, 64)
LGBM_FORESTS, LGBM_K, LGBM_ROWS = ((500, 31), (1000, 255)), 16384, (16, 32, 64, 128)
LGBM_BUDGETS = (227 * 1024 // 4, 227 * 1024 // 2, 227 * 1024)
RERANK_SHAPES = ((32, 1024, 384, 20), (4, 5000, 384, 5000))


def corpus_dir() -> str:
    return os.path.join(ROOT, "data", "kernel_times_corpus")


def measure(fn, calls: int) -> tuple:
    """(event ms, device ms or None, {kernel name: device ms}) a call of fn."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    torch.cuda.synchronize()
    event_ms = a.elapsed_time(b) / calls
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_kernel = {e.key: e.self_device_time_total / 1e3 / calls for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA}  # the kernels' own events
    device_ms = sum(by_kernel.values())
    return event_ms, (device_ms or None), by_kernel


def whole_job(fn, runs: int = 2) -> dict:
    """A whole HyperBall job fn(timings) after one warm-up: its round count
    and "rounds" seconds in `runs` runs, then the device time of one
    profiled run, summed over all kernels and over the merge body's launches
    (hll_merge_kernel, K6a's and K8's)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn({})
    rounds_s, n_rounds = [], None
    for _ in range(runs):
        t = {}
        fn(t)
        rounds_s.append(t["rounds"])
        n_rounds = t["n_rounds"]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn({})
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    merge = [e for e in events if "hll_merge_kernel" in e.key]
    return {"n_rounds": n_rounds, "rounds_s": rounds_s, "event_ms": None,
            "device_ms": sum(e.self_device_time_total for e in events) / 1e3 or None,
            "merge_device_ms": sum(e.self_device_time_total for e in merge) / 1e3 or None,
            "merge_launches": sum(e.count for e in merge)}


def _masked(B: int, T: int):
    """Row 1 half masked, row 2 fully masked: the kernel's int32 mask and
    SDPA's additive bf16 mask [B, 1, 1, T]."""
    import torch

    mask = torch.ones((B, T), dtype=torch.int32)
    mask[1, T // 2:] = 0
    mask[2] = 0
    mask = mask.cuda()
    add = torch.zeros((B, 1, 1, T), dtype=torch.bfloat16, device="cuda")
    add.masked_fill_(mask[:, None, None, :] == 0, torch.finfo(torch.bfloat16).min)
    return mask, add


def _smoke():
    """chip_smoke.py of this checkout, whichever tree the kernels come from:
    the library calls it times for K14b, K14c and K15c are timed here from
    the same code."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(root: str, calls: int, readings: list) -> list:
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    from stract_tpu_torch.ops import encoder as E
    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch.ops import stage as ST

    kernels.build()
    smoke = _smoke()
    out = []
    g = torch.Generator().manual_seed(0)

    def bf(*shape):
        return torch.randn(shape, generator=g).to("cuda", torch.bfloat16)

    def read(pairs, n=calls, parts=False, **key):  # pairs: (name, fn), kernel first
        for name, fn in pairs:
            ev, dev, by_kernel = measure(fn, n)
            rec = {"name": name, **key, "event_ms": ev, "device_ms": dev}
            if 1 < len(by_kernel) <= 4 or parts:  # a few kernels: each one's share
                rec["device_ms_by_kernel"] = by_kernel
            out.append(rec)

    if "attention" in readings:
        for T in ATTN_T:
            q, k, v = (bf(ATTN_B, T, ATTN_H, 32) for _ in range(3))
            mask, add = _masked(ATTN_B, T)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            read((("K5a", lambda: E.attention_forward(q, k, v, mask)),
                  ("sdpa", lambda: F.scaled_dot_product_attention(qt, kt, vt, add))), T=T)
    if "attention_backward" in readings:
        for T in ATTN_T:
            q, k, v = (bf(TRAIN_B, T, ATTN_H, 32) for _ in range(3))
            dout = bf(TRAIN_B, T, ATTN_H * 32)
            mask, add = _masked(TRAIN_B, T)
            leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
            o = F.scaled_dot_product_attention(*leaves, add)
            do = dout.view(TRAIN_B, T, ATTN_H, 32).transpose(1, 2)
            read((("K14a", lambda: E.attention_backward(q, k, v, mask, dout)),
                  ("sdpa_backward", lambda: torch.autograd.grad(o, leaves, do,
                                                                retain_graph=True))), T=T)
            del o, leaves
    if "attention_wide" in readings:
        for d, T in ATTN_WIDE:
            q, k, v = (bf(8, T, ATTN_H, d) for _ in range(3))
            dout = bf(8, T, ATTN_H * d)
            mask, add = _masked(8, T)
            try:
                E.attention_forward(q, k, v, mask)
                E.attention_backward(q, k, v, mask, dout)
            except ValueError as exc:  # a tree whose kernels do not take the shape
                out.append({"name": "K5a+K14a", "d": d, "T": T, "refused": str(exc),
                            "event_ms": None, "device_ms": None})
                continue
            leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
            o = F.scaled_dot_product_attention(*leaves, add)
            do = dout.view(8, T, ATTN_H, d).transpose(1, 2)
            qt, kt, vt = (t.detach() for t in leaves)
            read((("K5a", lambda: E.attention_forward(q, k, v, mask)),
                  ("sdpa", lambda: F.scaled_dot_product_attention(qt, kt, vt, add)),
                  ("K14a", lambda: E.attention_backward(q, k, v, mask, dout)),
                  ("sdpa_backward", lambda: torch.autograd.grad(o, leaves, do,
                                                                retain_graph=True))), d=d, T=T)
            del o, leaves
    if "attention_long" in readings:
        for B, T, H, d in ATTN_LONG:
            q, k, v = (bf(B, T, H, d) for _ in range(3))
            dout = bf(B, T, H * d)
            mask = torch.ones((B, T), dtype=torch.int32)
            mask[:, T - T // 5:] = 0
            mask = mask.cuda()
            add = torch.zeros((B, 1, 1, T), dtype=torch.bfloat16, device="cuda")
            add.masked_fill_(mask[:, None, None, :] == 0, torch.finfo(torch.bfloat16).min)
            try:
                E.attention_forward(q, k, v, mask)
                E.attention_backward(q, k, v, mask, dout)
            except ValueError as exc:
                out.append({"name": "K5a+K14a", "B": B, "T": T, "H": H, "d": d,
                            "refused": str(exc), "event_ms": None, "device_ms": None})
                continue
            leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
            o = F.scaled_dot_product_attention(*leaves, add)
            do = dout.view(B, T, H, d).transpose(1, 2)
            qt, kt, vt = (t.detach() for t in leaves)
            read((("K5a", lambda: E.attention_forward(q, k, v, mask)),
                  ("sdpa", lambda: F.scaled_dot_product_attention(qt, kt, vt, add)),
                  ("K14a", lambda: E.attention_backward(q, k, v, mask, dout)),
                  ("sdpa_backward", lambda: torch.autograd.grad(o, leaves, do,
                                                                retain_graph=True))),
                 n=min(calls, 10), B=B, T=T, H=H, d=d)
            del o, leaves
    if "mean_pool_long" in readings:
        for T in POOL_LONG:
            lens = torch.randint(1, T + 1, (8, 1), generator=g)
            lens[0], lens[-1] = T, 0
            mask = (torch.arange(T) < lens).to(torch.int32).cuda()
            h, cot = bf(8, T, 384), torch.randn((8, 384), generator=g).cuda()

            def pool():
                pooled, raw = E.mean_pool_forward(h, mask, True)
                return E.mean_pool_backward(mask, raw, cot, True, torch.bfloat16)
            try:
                pool()
            except ValueError as exc:
                out.append({"name": "K5d", "B": 8, "T": T, "refused": str(exc),
                            "event_ms": None, "device_ms": None})
                continue
            read((("K5d", pool),), parts=True, B=8, T=T)
    if "forest_lightgbm" in readings:
        forest_lightgbm_readings(read, out)
    if "stage_attention" in readings:
        torch.backends.cuda.matmul.allow_tf32 = False
        for T, H in STAGE_SHAPES:
            qkv = torch.randn((STAGE_MB, T, 3 * H), generator=g).cuda()
            try:
                ST.stage_attention_forward(qkv)
            except ValueError as exc:
                out.append({"name": "K16a", "T": T, "H": H, "refused": str(exc),
                            "event_ms": None, "device_ms": None})
                continue
            q, k, v = (qkv[..., i * H:(i + 1) * H].unsqueeze(1).contiguous() for i in range(3))
            read((("K16a", lambda: ST.stage_attention_forward(qkv)),
                  ("sdpa_f32", lambda: F.scaled_dot_product_attention(q, k, v))), T=T, H=H)
    if "stage_attention_backward" in readings:
        torch.backends.cuda.matmul.allow_tf32 = False
        for T, H in STAGE_SHAPES:
            qkv = torch.randn((STAGE_MB, T, 3 * H), generator=g).cuda()
            dout = torch.randn((STAGE_MB, T, H), generator=g).cuda()
            try:
                ST.stage_attention_backward(qkv, dout)
            except ValueError as exc:
                out.append({"name": "K16b", "T": T, "H": H, "refused": str(exc),
                            "event_ms": None, "device_ms": None})
                continue
            leaves = [qkv[..., i * H:(i + 1) * H].unsqueeze(1).contiguous().requires_grad_()
                      for i in range(3)]
            o = F.scaled_dot_product_attention(*leaves)
            do = dout.unsqueeze(1)
            read((("K16b", lambda: ST.stage_attention_backward(qkv, dout)),
                  ("sdpa_f32_backward", lambda: torch.autograd.grad(o, leaves, do,
                                                                    retain_graph=True))),
                 T=T, H=H)
            del o, leaves
    if "layernorm_backward" in readings:
        for N in LN_WIDTHS:
            M = TRAIN_B * TRAIN_T
            x, r, dy = bf(M, N), bf(M, N), bf(M, N)
            w = (1 + 0.1 * torch.randn(N, generator=g)).cuda()
            read((("K14b", lambda: E.add_layernorm_backward(x, r, w, 1e-12, dy)),
                  ("layer_norm_backward", smoke.layernorm_backward_library(x, r, w, dy))),
                 M=M, N=N)
    if "loss_heads" in readings:
        from stract_tpu_torch.ops import losses as LO

        for B in INFO_NCE_B:
            logits = 20.0 * torch.randn((B, B), generator=g).cuda()
            labels = torch.arange(B, device="cuda")
            read((("K15c_info_nce", lambda: LO.info_nce_forward(logits)),
                  ("cross_entropy", smoke.cross_entropy_library(logits, labels))), B=B)
            if hasattr(kernels, "INFO_NCE_GRID_ROWS"):  # both forms, for the crossover
                loss, d = torch.empty((), device="cuda"), torch.empty_like(logits)
                grid = -(-B // kernels.INFO_NCE_GRID_ROWS)
                read((("K15c_info_nce_one_block",
                       lambda: kernels.info_nce(logits, loss, d, blocks=1)),
                      ("K15c_info_nce_grid",
                       lambda: kernels.info_nce(logits, loss, d, blocks=grid))), B=B)
        sp, sn, tp, tn = (torch.randn(PAIR_B, generator=g).cuda() for _ in range(4))
        read((("K15c_pair", lambda: LO.pair_loss_forward(sp, sn)),
              ("K15c_pair_distilled", lambda: LO.pair_loss_forward(sp, sn, tp, tn, 2.0)),
              ("soft_margin", smoke.soft_margin_library(sp, sn))), B=PAIR_B)
    if "bias_gelu" in readings:
        y, b = bf(GELU_M, GELU_N), bf(GELU_N)
        read((("K5c", lambda: E.bias_gelu_forward(y, b)),
              ("gelu", lambda: F.gelu(y + b, approximate="tanh"))), M=GELU_M)
    if "bias_gelu_backward" in readings:
        for M, N in GELU_BWD_SHAPES:
            y, dout = bf(M, N), bf(M, N)
            b = (0.5 * torch.randn(N, generator=g)).to("cuda", torch.bfloat16)
            read((("K14c", lambda: E.bias_gelu_backward(y, b, dout)),
                  ("gelu_backward", smoke.bias_gelu_backward_library(y, b, dout))), M=M, N=N)
    if "layernorm" in readings:
        for M in LN_ROWS:
            for N in LN_WIDTHS:
                x, r = bf(M, N), bf(M, N)
                w = (1 + 0.1 * torch.randn(N, generator=g)).cuda()
                b = (0.1 * torch.randn(N, generator=g)).cuda()
                wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
                read((("K5b", lambda: E.add_layernorm_forward(x, r, w, b, 1e-12)),
                      ("layer_norm_f32", smoke.layernorm_library(x, r, w, b)),
                      ("layer_norm_bf16", lambda: F.layer_norm(x + r, (N,), wb, bb, 1e-12))),
                     M=M, N=N)
    if "mean_pool" in readings:
        B, T, H = TRAIN_B, TRAIN_T, 384
        h, cot = bf(B, T, H), torch.randn((B, H), generator=g).cuda()
        mask, _ = _masked(B, T)

        def pool():
            pooled, raw = E.mean_pool_forward(h, mask, True)
            return E.mean_pool_backward(mask, raw, cot, True, torch.bfloat16)
        read((("K5d", pool),), B=B, T=T)
        B, T, H = POOL_SERVE
        hq = bf(B, T, H)
        lens = torch.randint(8, T + 1, (B, 1), generator=g)
        qmask = (torch.arange(T) < lens).to(torch.int32).cuda()
        read((("K5d_forward", lambda: E.mean_pool_forward(hq, qmask, True)),), B=B, T=T)
    if "gelu_tanh" in readings:
        x = (3 * torch.randn((STAGE_MB, 128, 1536), generator=g)).cuda()
        dx = torch.randn(x.shape, generator=g).cuda()
        xl = x.clone().requires_grad_(True)
        y = F.gelu(xl, approximate="tanh")
        read((("K16c", lambda: (ST.gelu_tanh_forward(x), ST.gelu_tanh_backward(x, dx))),
              ("gelu_tanh_library", lambda: (F.gelu(x, approximate="tanh"),
                                             torch.autograd.grad(y, xl, dx, retain_graph=True)))),
             M=STAGE_MB * 128, N=1536)
        del x, dx, xl, y
    if "bfs" in readings:
        import numpy as np

        from stract_tpu_torch.entrypoint import bench_centrality as BC
        from stract_tpu_torch.webgraph import shortest_path as SP
        from stract_tpu_torch.webgraph.csr import graph_in_csr

        gr = BC.write_bench_graph(os.path.join(ROOT, "data", "kernel_times_graph"),
                                  GRAPH_NODES, GRAPH_EDGES)
        n = gr.num_nodes
        ef, et = SP.forward_edges(gr)
        csr = graph_in_csr(gr, "cuda")
        sources = np.random.default_rng(0).choice(n, size=GRAPH_SAMPLES, replace=False)
        t = {}
        read((("bfs", lambda: SP.bfs(n, ef, et, sources, device="cuda", csr=csr, timings=t)),),
             n=3, parts=True, S=GRAPH_SAMPLES)
        out[-1].update(n_rounds=t["n_rounds"], rounds_s=t["rounds"])
        if hasattr(SP, "relax"):  # a tree from before the frontier step
            dist = torch.full((GRAPH_SAMPLES, n), int(SP.UNREACHABLE), dtype=torch.int32,
                              device="cuda")
            dist[torch.arange(GRAPH_SAMPLES), torch.from_numpy(sources).cuda()] = 0
            dns = dist.t().contiguous()
            for _ in range(3):
                dns, _ = SP.relax(dns, csr)
            spare = torch.empty_like(dns)
            step = lambda: SP.relax(dns, csr, out=spare)  # noqa: E731
        else:
            state = SP.bfs_start(n, sources, "cuda")
            for level in range(3):
                state, _ = SP.frontier_step(state, csr, level)
            seen0, spare = state.seen.clone(), torch.empty_like(state.frontier)
            step = lambda: (state.seen.copy_(seen0),  # noqa: E731
                            SP.frontier_step(state, csr, 3, out=spare))
        read((("bfs_round_3", step),), parts=True, S=GRAPH_SAMPLES)
        del csr, spare
    if "hyperball" in readings:
        import numpy as np

        from stract_tpu_torch.entrypoint import bench_centrality as BC
        from stract_tpu_torch.ops import hll_ops as HO
        from stract_tpu_torch.parallel.mesh import Mesh
        from stract_tpu_torch.webgraph import centrality as WC
        from stract_tpu_torch.webgraph import shortest_path as SP
        from stract_tpu_torch.webgraph.csr import graph_in_csr

        gr = BC.write_bench_graph(os.path.join(ROOT, "data", "kernel_times_graph"),
                                  GRAPH_NODES, GRAPH_EDGES)
        n = gr.num_nodes
        ef, et = SP.forward_edges(gr)
        csr = graph_in_csr(gr, "cuda")
        mesh = Mesh([torch.device("cuda", 0)] * MESH_SHARDS, axis_names=("x",))
        out.append({"name": "hyperball", "N": n, **whole_job(
            lambda t: WC._hyperball(n, ef, et, 6, 64, "cuda", timings=t, csr=csr))})
        out.append({"name": "hyperball_sharded", "N": n, "shards": MESH_SHARDS, **whole_job(
            lambda t: WC._hyperball_sharded(n, ef, et, mesh, 6, 64, timings=t))})
        systolic = hasattr(HO, "merge_systolic_plain")
        regs = torch.from_numpy(HO.init_registers(n, 6)).cuda()
        flags = torch.ones(n, dtype=torch.uint8, device="cuda")
        for _ in range(3):
            rows = torch.empty_like(flags)
            extra = {"flags": flags, "flags_out": rows} if systolic else {}
            regs = HO.merge_csr(regs, csr, **extra)[0]
            flags = rows
        spare, spare_rows = torch.empty_like(regs), torch.empty_like(flags)
        calls = [("K6a", lambda: HO.merge_csr(regs, csr, out=spare))]
        if systolic:
            every, none = torch.ones_like(flags), torch.zeros_like(flags)
            calls += [("K6a_every_byte", lambda: HO.merge_csr(regs, csr, out=spare, flags=every,
                                                              flags_out=spare_rows)),
                      ("K6a_round_4", lambda: HO.merge_csr(regs, csr, out=spare, flags=flags,
                                                           flags_out=spare_rows)),
                      ("K6a_no_byte", lambda: HO.merge_csr(regs, csr, out=spare, flags=none,
                                                           flags_out=spare_rows))]
        read(calls, parts=True, N=n)
        S = -(-n // MESH_SHARDS)
        buckets = WC.ring_buckets(n, ef, et, [torch.device("cuda", 0)] * MESH_SHARDS)
        regs0 = np.zeros((S * MESH_SHARDS, 64), np.uint8)
        regs0[:n] = HO.init_registers(n, 6)
        shards = [torch.from_numpy(regs0[d * S:(d + 1) * S]).cuda() for d in range(MESH_SHARDS)]
        shard_flags = [torch.ones(S, dtype=torch.uint8, device="cuda") for _ in shards]
        for _ in range(3):
            res = WC.ring_round(shards, buckets, sizes=False,
                                **({"flags": shard_flags} if systolic else {}))
            shards = res[0]
            shard_flags = res[3] if systolic else shard_flags
        bucket, out_t = buckets[0][1], shards[0].clone()
        calls = [("K8", lambda: HO.ring_step(out_t, shards[1], bucket))]
        if systolic:
            every = torch.ones(S, dtype=torch.uint8, device="cuda")
            none = torch.zeros_like(every)
            calls += [("K8_every_byte",
                       lambda: HO.ring_step(out_t, shards[1], bucket, flags=every)),
                      ("K8_round_4", lambda: HO.ring_step(out_t, shards[1], bucket,
                                                          flags=shard_flags[1])),
                      ("K8_no_byte", lambda: HO.ring_step(out_t, shards[1], bucket, flags=none))]
        read(calls, parts=True, N=S)
        del csr, buckets, shards, regs, spare
    if "sgd" in readings:
        ps = [torch.randn(n, generator=g).cuda() for n in PIPE_SIZES]
        gs = [0.01 * torch.randn(n, generator=g).cuda() for n in PIPE_SIZES]
        if hasattr(ST, "sgd_update_many"):
            sgd = lambda: ST.sgd_update_many(ps, gs, LR)  # noqa: E731
        else:  # a checkout from before the one-launch update: one launch a tensor
            sgd = lambda: [ST.sgd_update(p, gg, LR) for p, gg in zip(ps, gs)]  # noqa: E731
        read((("K16d", sgd), ("foreach_add", lambda: torch._foreach_add_(ps, gs, alpha=-LR))),
             tensors=len(ps))
        del ps, gs
    if "pipeline_step" in readings:  # the whole pipelined train step that K16d ends
        from stract_tpu_torch.parallel import pipeline as PL
        from stract_tpu_torch.parallel.mesh import Mesh

        dev0 = torch.device("cuda", 0)
        mesh = Mesh([[dev0] * 2] * 6, axis_names=("pp", "dp"))
        init_fn, step_fn = PL.make_pipeline_train_step(mesh, hidden=384, ffn=1536,
                                                       learning_rate=LR)
        params = init_fn(0)
        mbs = torch.randn((8, 16, 128, 384), generator=g).to(dev0)
        targets = torch.randn((8, 16), generator=g).to(dev0)
        read((("pipeline_step", lambda: step_fn(params, mbs, targets)),), n=3, steps=3)
        del params, mbs
    if "moe" in readings:
        moe_readings(bf, g, read)
    if "moe_step" in readings:
        moe_step_reading(g, read)
    if "scoring" in readings:
        scoring_readings(smoke, read)
    if "join" in readings:
        join_readings(smoke, read, out)
    if "mesh_merge" in readings:
        mesh_merge_readings(smoke, read)
    if "prefix" in readings:
        prefix_readings(smoke, read)
    if "forest" in readings:
        forest_readings(read)
    if "rerank" in readings:
        rerank_readings(read, out)
    if "hll_estimate" in readings:
        from stract_tpu_torch.ops import hll_ops as HO

        n = GRAPH_NODES
        regs = torch.from_numpy(HO.init_registers(n, 6)).cuda()
        ranks = torch.randint(1, 9, (n, 64), generator=g, dtype=torch.uint8).cuda()
        read((("K6b", lambda: HO.estimate_sizes(regs)),), N=n)
        read((("K6b_ranks", lambda: HO.estimate_sizes(ranks)),), N=n)
        del regs, ranks
    if "dual_step" in readings:  # one dual-encoder InfoNCE step: K14a runs 12 times
        from stract_tpu_torch.models.bert import BertConfig, BertForEmbedding, random_init
        from stract_tpu_torch.optim import AdamW
        from stract_tpu_torch.parallel.train import info_nce_loss, train_step

        model = random_init(BertForEmbedding(BertConfig.mini_lm(vocab_size=VOCAB),
                                             param_dtype=torch.float32), 0).cuda()
        opt = AdamW(model.parameters(), 3e-4)
        ids = torch.randint(5, VOCAB, (2, TRAIN_B, TRAIN_T), generator=g, dtype=torch.int32)
        lens = torch.randint(8, TRAIN_T + 1, (2, TRAIN_B, 1), generator=g)
        masks = (torch.arange(TRAIN_T) < lens).to(torch.int32)
        batch = {"q_ids": ids[0].cuda(), "q_mask": masks[0].cuda(), "d_ids": ids[1].cuda(),
                 "d_mask": masks[1].cuda()}
        read((("dual_step", lambda: train_step(model, opt, batch, info_nce_loss)),), n=10,
             steps=10)
    return out


def moe_readings(bf, g, read) -> None:
    """The moe group (the module docstring): through the autograd Functions,
    so that a tree's backward is read with whatever it runs besides the
    kernel."""
    import torch

    from stract_tpu_torch.ops import moe as MO

    for N, H, E in MOE_SHAPES:
        x = bf(N, H).requires_grad_()
        w = (0.05 * torch.randn((E, H), generator=g)).cuda().requires_grad_()
        b = (0.05 * torch.randn(E, generator=g)).cuda().requires_grad_()
        dgate = bf(N)
        out_e = bf(E, N, H).requires_grad_()
        gr = bf(N, H)
        top, gate = MO.router(x, w, b)
        gate = gate.detach().requires_grad_()

        def router_vjp():
            return torch.autograd.grad(MO.router(x, w, b)[1], (x, w, b), dgate)

        def select_vjp():
            return torch.autograd.grad(MO.select_scale(out_e, top, gate), (out_e, gate), gr)
        read((("K15a", router_vjp), ("K15b", select_vjp)), N=N, H=H, E=E, parts=True)
        del x, out_e


def moe_step_reading(g, read) -> None:
    """The moe_step reading (the module docstring)."""
    import dataclasses

    import torch

    from stract_tpu_torch.models.bert import BertConfig
    from stract_tpu_torch.parallel.train import distill_loss, make_train_state, train_step

    cfg = dataclasses.replace(BertConfig.mini_lm(vocab_size=VOCAB), score_pool="mean")
    model, opt = make_train_state(cfg, 3e-4, seed=0, num_experts=4, device="cuda")
    batch = {}
    for side in ("pos", "neg"):
        ids = torch.randint(5, VOCAB, (MOE_PAIRS, TRAIN_T), generator=g, dtype=torch.int32)
        lens = torch.randint(8, TRAIN_T + 1, (MOE_PAIRS, 1), generator=g)
        batch[f"{side}_ids"] = ids.cuda()
        batch[f"{side}_mask"] = (torch.arange(TRAIN_T) < lens).to(torch.int32).cuda()
        batch[f"{side}_types"] = torch.zeros((MOE_PAIRS, TRAIN_T), dtype=torch.int32).cuda()
    for k in ("t_pos", "t_neg"):
        batch[k] = (5 * torch.rand(MOE_PAIRS, generator=g)).cuda()
    read((("moe_step", lambda: train_step(model, opt, batch, distill_loss, alpha=2.0)),),
         n=10, steps=10)
    del model, opt


def _shard() -> tuple:
    """The scoring and join groups' shard: chip_smoke.py's 1M-doc corpus
    (opened from data/kernel_times_corpus) with its q16 and q8 rows on the
    card, and its 32 sampled queries' (slots, aggregates) → (index, segment,
    q16 device segment, q8 device segment, slots)."""
    import numpy as np

    from stract_tpu_torch import bench_corpus as bc
    from stract_tpu_torch.index.device import DeviceSegment
    from stract_tpu_torch.index.inverted import InvertedIndex
    from stract_tpu_torch.ranking.computer import QueryContext, build_slots

    index = InvertedIndex(os.path.join(corpus_dir(), f"bench-{CORPUS_DOCS}"), "cuda")
    seg = index.segments[0]
    dev, dev8 = index.device_segment_for(seg), DeviceSegment(seg, "cuda", "q8")
    queries = bc.sample_queries(np.random.default_rng(0), SCORE_B)
    ctxs = [QueryContext(raw=q, simple_terms=q.split(), current_ts=1.7e9) for q in queries]
    slots = [build_slots(c, seg, index.num_docs, index.region_scores()) for c in ctxs]
    return index, seg, dev, dev8, slots


def scoring_readings(smoke, read) -> None:
    """The scoring group (the module docstring); the inputs are made with this
    worker's tree, the helpers (slot padding, compaction, K9's gathered
    lists) come from this checkout's chip_smoke.py."""
    import numpy as np
    import torch

    from stract_tpu_torch.index.inverted import InvertedIndex
    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch.ops import scoring as O

    B, L, C = SCORE_B, SCORE_L, SCORE_C
    index, seg, dev, dev8, slots = _shard()

    def augmented(d):
        aug = [InvertedIndex._augment_with_impact(seg, d, q, L, 0.5) for q, _ in slots]
        return (O.stack([a[0] for a in aug]), np.stack([a[1] for a in aug]).astype(np.float32),
                np.array([a[2] for a in aug], dtype=np.float32))
    (qa, ub, ubt), (qa8, _, _) = augmented(dev), augmented(dev8)
    on_card = lambda tup: O.to_tensors(tup, "cuda")  # noqa: E731
    t = lambda x, dt=torch.int32: torch.as_tensor(x, dtype=dt).cuda()  # noqa: E731
    qa_c, qa8_c = on_card(qa), on_card(qa8)
    ub_c, ubt_c = t(ub, torch.float32), t(ubt, torch.float32)
    e_max = int(np.minimum(qa.lens, L).sum(axis=1).max())
    read((("K1", lambda: O.score_candidates_batch(dev.arrays, qa_c, L, C, True, True)),
          ("K1_main_path", lambda: O.score_candidates_batch(dev.arrays, qa, L, C, True, True)),
          ("K1_q8", lambda: O.score_candidates_batch(dev8.arrays, qa8_c, L, C, True, True)),
          ("K1_ub", lambda: O.score_candidates_batch(dev.arrays, qa_c, L, C, True, True, ub_c,
                                                     ubt_c))),
         parts=True, B=B, L=L, C=C, E_max=e_max)
    # 64 full-length slots a query (E = P*L: K1's global table), and one such
    # query among the sampled ones
    full = smoke.full_slots(seg, qa, np.random.default_rng(0))
    mixed = O.QuerySlots(*[np.concatenate([np.asarray(f)[:1], np.asarray(a)[1:]])
                           for f, a in zip(full, qa)])
    full_c, mixed_c = on_card(full), on_card(mixed)
    for name, q_c in (("K1_full", full_c), ("K1_mixed", mixed_c)):
        read(((name, lambda q_c=q_c: O.score_candidates_batch(dev.arrays, q_c, L, C, True,
                                                               True)),),
             parts=True, B=B, L=L, C=C, E_max=int(np.minimum(full.lens, L).sum(axis=1).max()))
    if hasattr(kernels, "stage_a_plan"):  # a tree with K1's table plan: other cluster sizes
        plan_of = kernels.stage_a_plan
        for c in (2, 8):
            kernels.stage_a_plan = lambda *a, c=c: plan_of(*a)._replace(cluster=c)
            read(((f"K1_cluster_{c}", lambda: O.score_candidates_batch(dev.arrays, qa_c, L, C,
                                                                      True, True)),),
                 parts=True, B=B, L=L, C=C, E_max=e_max)
        kernels.stage_a_plan = plan_of
    qm = on_card(O.stack([smoke.pad_slots(InvertedIndex._augment_with_impact(seg, dev, q)[0],
                                          MERGE_P) for q, _ in slots]))
    read((("K13", lambda: O.score_candidates_batch(dev.arrays, qm, L, C, True, True,
                                                  merge=True)),), parts=True, B=B, P=MERGE_P)
    if hasattr(kernels, "merge_plan") and kernels.merge_plan(MERGE_P * L).form != "global":
        # a tree whose plan takes another form here: the same call, global form
        plan_of = kernels.merge_plan
        kernels.merge_plan = lambda N: kernels.MergePlan("global", 0)
        read((("K13_global", lambda: O.score_candidates_batch(dev.arrays, qm, L, C, True, True,
                                                             merge=True)),),
             parts=True, B=B, P=MERGE_P)
        kernels.merge_plan = plan_of
    # the network alone (the K = 0 launch) on the queries' doc-ordered slots,
    # beside torch.sort of the same keys and the gathers of their payloads
    qd = on_card(O.stack([smoke.pad_slots(q, MERGE_P) for q, _ in slots]))
    keys, contrib, aux, _ = O._stage_a_entries(dev.arrays, qd, L)
    kf, cf, af = (x.reshape(B, -1) for x in (keys, contrib, aux))

    def sort_gather():
        sk, perm = torch.sort(kf, dim=-1)
        return sk, cf.gather(1, perm), af.gather(1, perm)
    read((("K13_network", lambda: O.stage_a_network(dev.arrays, qd, L)),
          ("K13_network_torch_sort", sort_gather)), parts=True, B=B, P=MERGE_P)
    del keys, contrib, aux, kf, cf, af
    # MERGE_WIDE_P full-length slots a query (the select over 8 blocks)
    wide = smoke.full_slots(seg, O.stack([smoke.pad_slots(q, MERGE_WIDE_P) for q, _ in slots]),
                            np.random.default_rng(0))
    qw = on_card(wide)
    read((("K13_wide", lambda: O.score_candidates_batch(dev.arrays, qw, L, C, True, True,
                                                       merge=True)),),
         parts=True, B=B, P=MERGE_WIDE_P)
    del qw

    # stage B over the plain stage A's candidates (the same inputs in every tree)
    cand = O.score_candidates_batch_plain(dev.arrays, qa_c, L, C, True, True)[0].cpu().numpy()
    comp, Pc = smoke.compacted_slots(slots)
    facs = np.zeros((B, Pc, SCORE_KD), np.int32)
    for j, (q, _) in enumerate(comp):
        InvertedIndex._slot_factors_for(seg, q, cand[j], out=facs[j])
    qc, ac = O.stack([q for q, _ in comp]), O.stack([a for _, a in comp])
    qc_c, ac_c, f_c, c_c = on_card(qc), on_card(ac), t(facs), t(cand)
    read((("K2", lambda: O.score_driver_batch_with_signals(dev.arrays, qc_c, f_c, c_c, ac_c, True,
                                                           SCORE_K, SCORE_SIG)),
          ("K2_main_path", lambda: O.score_driver_batch_with_signals(
              dev.arrays, qc, facs, cand, ac, True, SCORE_K, SCORE_SIG))),
         parts=True, B=B, P=Pc, Kd=SCORE_KD, k=SCORE_K, ks=SCORE_SIG)
    if hasattr(kernels, "stage_b_cluster"):  # a tree with K2's clusters: one block a query
        cluster_of = kernels.stage_b_cluster
        kernels.stage_b_cluster = lambda Kd: 1
        read((("K2_one_block", lambda: O.score_driver_batch_with_signals(
            dev.arrays, qc_c, f_c, c_c, ac_c, True, SCORE_K, SCORE_SIG)),),
             parts=True, B=B, P=Pc, Kd=SCORE_KD, k=SCORE_K, ks=SCORE_SIG)
        kernels.stage_b_cluster = cluster_of
    page = O.score_driver_batch_plain(dev.arrays, qc_c, f_c, c_c, True, SCORE_K)[0][:, :PAGE_K]
    page = page.cpu().numpy().astype(np.int32)
    pf = np.zeros((B, Pc, PAGE_K), np.int32)
    for j, (q, _) in enumerate(comp):
        InvertedIndex._slot_factors_for(seg, q, page[j], out=pf[j])
    # K3 at the recall bucket (512) and the page bucket (128) of
    # index/inverted.py, with its inputs on the card and as the index calls it
    # (numpy slots, aggregates, factors and candidates)
    for K in (PAGE_K, 128):
        pf_k, pg_k = np.ascontiguousarray(pf[:, :, :K]), np.ascontiguousarray(page[:, :K])
        pf_c, pg_c = t(pf_k), t(pg_k)
        read((("K3", lambda: O.compute_signals_from_factors_batch_q16(dev.arrays, qc_c, ac_c,
                                                                      pf_c, pg_c)),
              ("K3_main_path", lambda: O.compute_signals_from_factors_batch_q16(
                  dev.arrays, qc, ac, pf_k, pg_k))),
             parts=True, B=B, P=Pc, K=K)
    for n, K in MESH_SHAPES:
        scores, docs = smoke.gathered(MESH_B, n, K, 0)
        read((("K9", lambda: O.mesh_topk(scores, docs, K)),), parts=True, B=MESH_B, shards=n,
             K=K)
    del index, dev, dev8


def join_readings(smoke, read, out) -> None:
    """The join group (the module docstring): the inputs are made with this
    worker's tree; stage A's candidates and pass 2's pages come from plain
    versions, the same in every tree."""
    import numpy as np
    import torch

    from stract_tpu_torch.index.inverted import InvertedIndex
    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch.ops import scoring as O

    B, L, C, Kd = SCORE_B, SCORE_L, SCORE_C, SCORE_KD
    index, seg, dev, dev8, slots = _shard()
    on_card = lambda tup: O.to_tensors(tup, "cuda")  # noqa: E731
    aug = [InvertedIndex._augment_with_impact(seg, dev, q, L, 0.5)[0] for q, _ in slots]
    qa_c = on_card(O.stack(aug))
    cand = O.score_candidates_batch_plain(dev.arrays, qa_c, L, C, True, True)[0][:, :Kd]
    comp, Pc = smoke.compacted_slots(slots)
    qc, ac = O.stack([q for q, _ in comp]), O.stack([a for _, a in comp])
    qc_c, ac_c, c_c = on_card(qc), on_card(ac), cand.contiguous()
    c_np = c_c.cpu().numpy()
    page = O.score_driver_joined_batch_plain(dev.arrays, qc_c, c_c, True, SCORE_K)[0]
    lens = np.asarray(qc.lens, dtype=np.int64)
    out.append({"name": "K11_slots", "event_ms": None, "device_ms": None, "B": B, "P": Pc,
                "lens_quantiles": {str(q): float(np.quantile(lens, q))
                                   for q in (0, 0.25, 0.5, 0.75, 0.9, 1)},
                "empty": int((lens == 0).sum()),
                "at_most_x_candidates": {f"{m} x {K}": int((lens <= m * K).sum())
                                         for K in (Kd, PAGE_K, 128) for m in (1, 2, 4, 8, 16)}})

    def forms(suffix=""):
        read(((f"K11{suffix}", lambda: O.factors_join(dev.arrays, qc_c.starts, qc_c.lens, c_c)),
              (f"K11_main_path{suffix}", lambda: O.factors_join(dev.arrays, qc.starts, qc.lens,
                                                                c_np))),
             parts=True, B=B, P=Pc, K=Kd)
        read(((f"K11_stage_b{suffix}", lambda: O.score_driver_joined_batch(
                  dev.arrays, qc_c, c_c, True, SCORE_K)),
              (f"K11_stage_b_main_path{suffix}", lambda: O.score_driver_joined_batch(
                  dev.arrays, qc, c_np, True, SCORE_K))),
             parts=True, B=B, P=Pc, K=Kd)
        for K in (PAGE_K, 128):
            pg = page[:, :K].contiguous()
            pg_np = pg.cpu().numpy()
            read(((f"K11_pass2{suffix}", lambda: O.compute_signals_joined_batch_q16(
                      dev.arrays, qc_c, ac_c, pg)),
                  (f"K11_pass2_main_path{suffix}", lambda: O.compute_signals_joined_batch_q16(
                      dev.arrays, qc, ac, pg_np))),
                 parts=True, B=B, P=Pc, K=K)
        pg = page[:, :PAGE_K].contiguous()
        read(((f"K11_pass2_f32{suffix}", lambda: O.compute_signals_joined_batch(
                  dev.arrays, qc_c, ac_c, pg)),), parts=True, B=B, P=Pc, K=PAGE_K)
    forms()
    q1, a1 = comp[0]
    pg1 = page[0, :128].cpu().numpy()
    read((("K11_pass2_f32_single", lambda: O.compute_signals_joined(dev.arrays, q1, a1, pg1)),),
         parts=True, B=1, P=Pc, K=128)
    if hasattr(kernels, "join_plan"):  # a tree with a join plan: the others it could take
        plan_of = kernels.join_plan
        for sample in JOIN_SAMPLES:
            kernels.join_plan = lambda *a, f=sample: plan_of(*a)._replace(sample=f)
            forms(f"_plan_sample{sample}")
        kernels.join_plan = plan_of
    del index, dev, dev8


def mesh_merge_readings(smoke, read) -> None:
    """The mesh_merge group (the module docstring): K9 at MESH_SHAPES over
    chip_smoke.py's gathered lists (descending, -inf tails, seed 0, the same
    in every tree), stacked, per shard where the tree has the call, and
    through parallel/search.py _merge as the mesh's serving path calls it
    (the shards' [B, K] lists on one card)."""
    import torch

    from stract_tpu_torch.ops import scoring as O
    from stract_tpu_torch.parallel import search as PS

    dev = torch.device("cuda", 0)
    for n, K in MESH_SHAPES:
        scores, docs = smoke.gathered(MESH_B, n, K, 0)
        s_l = [scores[:, i].contiguous() for i in range(n)]
        d_l = [docs[:, i].contiguous() for i in range(n)]
        parts = list(zip(d_l, s_l))
        pairs = [("K9", lambda: O.mesh_topk(scores, docs, K))]
        if hasattr(O, "mesh_topk_lists"):
            pairs.append(("K9_lists", lambda: O.mesh_topk_lists(s_l, d_l, K)))
        pairs.append(("K9_merge", lambda: PS._merge(parts, dev, K)))
        read(pairs, parts=True, B=MESH_B, shards=n, K=K)


def prefix_readings(smoke, read) -> None:
    """The prefix group (the module docstring): K12 at chip_smoke.py's shape
    (its 32 sampled queries' compacted slots, Pc = 16, L = 1,024, the plain
    joined stage B's top 512 as candidates: the same inputs in every tree),
    with its inputs on the card; over PREFIX_WIDE_P full-length slots a query
    (`K12_wide`: chip_smoke.py's full_slots, seed 12, the aggregates' columns
    repeated); in a tree with kernels.prefix_plan, also under its plan with
    each cap of candidates a block in PREFIX_CANDS (`K12_cands{c}`), and
    with the prefixes left in L2 (`K12_unstaged`: group 0)."""
    import numpy as np

    from stract_tpu_torch.index.inverted import InvertedIndex
    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch.ops import scoring as O

    B, L, C, Kd = SCORE_B, SCORE_L, SCORE_C, SCORE_KD
    index, seg, dev, dev8, slots = _shard()
    on_card = lambda tup: O.to_tensors(tup, "cuda")  # noqa: E731
    aug = [InvertedIndex._augment_with_impact(seg, dev, q, L, 0.5)[0] for q, _ in slots]
    cand = O.score_candidates_batch_plain(dev.arrays, on_card(O.stack(aug)), L, C, True,
                                          True)[0][:, :Kd].contiguous()
    comp, Pc = smoke.compacted_slots(slots)
    qc, ac = O.stack([q for q, _ in comp]), O.stack([a for _, a in comp])
    qc_c, ac_c = on_card(qc), on_card(ac)
    page = O.score_driver_joined_batch_plain(dev.arrays, qc_c, cand, True, SCORE_K)[0]
    page = page[:, :PAGE_K].contiguous()
    rng = np.random.default_rng(12)
    qw = smoke.full_slots(seg, O.stack([smoke.pad_slots(q, PREFIX_WIDE_P) for q, _ in comp]),
                          rng)
    cyc = np.arange(PREFIX_WIDE_P) % Pc
    aw_c = on_card(ac._replace(**{f: np.asarray(getattr(ac, f))[..., cyc] for f in ac._fields}))
    qw_c = on_card(qw)

    def run(suffix=""):
        read(((f"K12{suffix}", lambda: O.compute_signals_batch(dev.arrays, qc_c, ac_c, page, L)),),
             parts=True, B=B, P=Pc, K=PAGE_K)
        read(((f"K12_wide{suffix}", lambda: O.compute_signals_batch(dev.arrays, qw_c, aw_c, page,
                                                                    L)),),
             parts=True, B=B, P=PREFIX_WIDE_P, K=PAGE_K)
    run()
    if hasattr(kernels, "prefix_plan"):  # a tree with K12's plan: other tiles of candidates
        cap, plan_of = kernels.PREFIX_CANDS, kernels.prefix_plan
        for c in PREFIX_CANDS:
            kernels.PREFIX_CANDS = c
            run(f"_cands{c}")
        kernels.PREFIX_CANDS = cap
        kernels.prefix_plan = lambda *a: plan_of(*a)._replace(group=0)
        run("_unstaged")
        kernels.prefix_plan = plan_of
    del index, dev, dev8


def rerank_readings(read, out) -> None:
    """The rerank group (the module docstring)."""
    import torch
    import torch.nn.functional as F

    from stract_tpu_torch.ops import dense_rerank as R

    g = torch.Generator().manual_seed(3)
    for B, K, H, k in RERANK_SHAPES:
        emb = F.normalize(torch.randn((B, K, H), generator=g), dim=2)
        emb[:, ::10] = 0
        emb = emb.to("cuda", torch.float16)
        q = torch.randn((B, H), generator=g).cuda()
        base = (0.1 * torch.randn((B, K), generator=g)).cuda()
        try:
            R.rerank_topk_batch(emb, q, base, 0.01, k)
        except ValueError as exc:  # a tree whose kernel does not take the shape
            out.append({"name": "K10", "B": B, "K": K, "H": H, "refused": str(exc),
                        "event_ms": None, "device_ms": None})
            continue
        e32 = emb.float()
        read((("K10", lambda: R.rerank_topk_batch(emb, q, base, 0.01, k)),
              ("rerank_three_calls", lambda: torch.topk(base + 0.01 * torch.einsum(
                  "bkh,bh->bk", F.normalize(e32, dim=2, eps=1e-6), q), k))), B=B, K=K, H=H)


def forest_readings(read) -> None:
    """The forest group (the module docstring)."""
    import numpy as np
    import torch

    from stract_tpu_torch.ops import forest as FO
    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch.ranking.models.lambdamart import LambdaMART

    rng = np.random.default_rng(3)
    x = rng.normal(size=(400, 46)).astype(np.float32)
    y = 2 * x[:, 0] + x[:, 5] * x[:, 7] + (x[:, 11] > 0.3)
    pm = LambdaMART.train(x, y, num_trees=FOREST_TREES, max_depth=FOREST_DEPTH, device="cpu")
    pm = pm.to("cuda")
    for K in FOREST_ROWS:
        rows = rng.normal(size=(K, 46)).astype(np.float32)
        xc = torch.from_numpy(rows).cuda()
        read((("K4", lambda: FO.gbdt_forward(*pm._arrays(), xc, pm.max_depth)),
              ("K4_predict", lambda: pm.predict(rows))), parts=True, K=K)
        if hasattr(kernels, "forest_plan"):  # a tree with a forest plan: other row tiles
            plan_of = kernels.forest_plan
            for tile in FOREST_TILES:
                kernels.forest_plan = lambda *a, t=tile: plan_of(*a)._replace(rows=t)
                read(((f"K4_tile{tile}", lambda: FO.gbdt_forward(*pm._arrays(), xc,
                                                                 pm.max_depth)),),
                     parts=True, K=K)
            kernels.forest_plan = plan_of


def forest_lightgbm_readings(read, out) -> None:
    """The forest_lightgbm group (the module docstring)."""
    import numpy as np
    import torch

    from stract_tpu_torch.ops import forest as FO
    from stract_tpu_torch.ops import kernels
    from stract_tpu_torch import bench_corpus as bc
    from stract_tpu_torch.ranking.models import lambdamart as LM

    rng = np.random.default_rng(5)
    xc = torch.from_numpy(rng.normal(size=(LGBM_K, 46)).astype(np.float32)).cuda()
    for trees, leaves in LGBM_FORESTS:
        key = {"K": LGBM_K, "S": f"{trees}x{leaves}"}
        try:
            pm = LM.LambdaMART.parse_lightgbm(bc.synthetic_lightgbm(trees, leaves, 46, trees),
                                              device="cuda")
            FO.gbdt_forward(*pm._arrays(), xc, pm.max_depth)
        except (AttributeError, ValueError) as exc:
            out.append({"name": "K4", **key, "refused": str(exc), "event_ms": None,
                        "device_ms": None})
            continue
        read((("K4", lambda: FO.gbdt_forward(*pm._arrays(), xc, pm.max_depth)),), parts=True,
             **key)
        T, N = pm.feature.shape
        L = pm.leaf_value.shape[1]
        plan_of = kernels.forest_plan
        for rows in LGBM_ROWS:
            for budget in LGBM_BUDGETS:
                per = kernels._forest_smem(2, N, L, 46, rows) - kernels._forest_smem(1, N, L, 46,
                                                                                      rows)
                first = kernels._forest_smem(1, N, L, 46, rows)
                if first > budget:
                    continue
                plan = kernels.ForestPlan(rows, min(T, 1 + (budget - first) // per), True)
                kernels.forest_plan = lambda *a, p=plan: p
                read(((f"K4_rows{rows}_smem{budget}",
                       lambda: FO.gbdt_forward(*pm._arrays(), xc, pm.max_depth)),),
                     parts=True, **key)
        kernels.forest_plan = plan_of
        del pm


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", default="change")
    ap.add_argument("--tree", action="append", default=[], help="NAME=DIR")
    ap.add_argument("--calls", type=int, default=50)
    ap.add_argument("--readings", default=",".join(READINGS), help="groups, comma-separated")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, args.calls, args.readings.split(","))), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_times.py needs an NVIDIA card", file=sys.stderr)
        return 1
    trees = {"change": ROOT, **dict(t.split("=", 1) for t in args.tree)}
    if {"scoring", "join", "prefix"} & set(args.readings.split(",")):  # the corpus every worker opens
        sys.path.insert(0, ROOT)
        from stract_tpu_torch import bench_corpus as bc

        bc.ensure_corpus(corpus_dir(), CORPUS_DOCS, seed=0, log=lambda *a: None)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    summary = {}
    for n, tree in enumerate(args.runs.split(",")):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                               os.path.abspath(trees[tree]), "--calls", str(args.calls),
                               "--readings", args.readings],
                              capture_output=True, text=True, cwd=trees[tree])
        if proc.returncode:
            print(f"[run {n} {tree}] failed:\n{proc.stderr[-3000:]}", flush=True)
            return proc.returncode
        for rec in json.loads(proc.stdout.strip().splitlines()[-1]):
            rec = {"run": n, "tree": tree, **rec}
            print(json.dumps(rec), flush=True)
            shape = " ".join(f"{f}={rec[f]}" for f in ("d", "T", "H", "E", "M", "N", "B", "S",
                                                       "tensors", "shards", "K", "P")
                             if f in rec)
            key = f"{tree} {rec['name']} {shape}"
            summary.setdefault(key, []).append(
                (rec["event_ms"], rec["device_ms"]) if "rounds_s" not in rec else
                (rec["rounds_s"], rec["device_ms"], rec["merge_device_ms"]))
    print(json.dumps({"card": card.strip().splitlines()[0], "readings": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
