"""Build and ctypes binding of the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled with nvcc for sm_90a at first use into its own
library under stract_tpu_torch/build/ (plain C interfaces, so each build
takes seconds; all sources build in parallel) and loaded with ctypes. A
library is rebuilt when its source is newer. Nothing here runs at import
time: the CPU tests import this module on machines without nvcc or a card.

  csrc/scoring.cu   K1 stage A (q16 or q8 rows, with or without block-max UB), K13
                    stage A through the P-way bitonic merge, K2 stage B, K3 pass-2
                    signals, K11 the device factor join (alone, and before K2 and
                    K3 in the joined stage B and pass 2), K12 pass 2 from the
                    slots' L-row prefixes, K10 the dense rerank, K9 the global
                    top-k of the mesh's search
  csrc/forest.cu    K4 LambdaMART forest walk
  csrc/encoder.cu   K5a masked attention of the BERT encoder, K14a its backward, K5c
                    bias + tanh GELU, K5b the residual + LayerNorm, K14b its backward,
                    K14c the bias + GELU backward, K5d the masked mean pool and its
                    backward
  csrc/graph.cu     K6a HyperBall register merge (+ K6b in its epilogue), K6b HLL
                    size estimate, K7 the BFS's bitset frontier step, K8 the
                    sharded HyperBall's ring step
  csrc/moe.cu       K15a the MoE router (logits, softmax, argmax, gate) and its
                    whole VJP (dx and the parameter gradients), K15b the MoE
                    select-and-scale and its backward
  csrc/losses.cu    K15c the loss heads: the pairwise logistic head (plain and
                    distilled) and the in-batch InfoNCE head, value and gradient
  csrc/stage.cu     K16a the pipeline stage's f32 single-head attention, K16b its
                    backward, K16c its f32 tanh GELU and the GELU's backward, K16d
                    the SGD update of a card's parameters in one launch

(K14d and K15d, the fused AdamW updates of f32 masters and of bf16
parameters, are Triton kernels in optim.py; they count their launches here
too, and launch on their tensors' card as well: `card_of`.)

csrc/col_sum.cuh, the fixed-order column sum of K14b, K14c and K15a's
backward, is included by encoder.cu and moe.cu: a library is rebuilt when
its source or a header under csrc/ is newer.

Each launch function takes tensors already on the card, allocated by its
caller (ops/*.py), launches under `on_card` (the card its tensors lie on
made current, that card's current stream; tensors on two cards raise),
raises on a non-zero CUDA status, and adds one to its entry in LAUNCHES.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
from typing import NamedTuple

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
# library name -> source file under csrc/
SOURCES = {"scoring": "scoring.cu", "forest": "forest.cu", "encoder": "encoder.cu",
           "graph": "graph.cu", "moe": "moe.cu", "stage": "stage.cu", "losses": "losses.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

# limits of csrc/scoring.cu (MAX_SORT, MAX_SIG_K): the largest top-C, Kd or
# page one block sorts in shared memory, and the most fused signal columns
MAX_SORT = 4096
MAX_SIG_K = 64
# limits of K12 (MAX_NSIG, the most slots it takes)
MAX_NSIG = 64
MAX_SEARCH_P = 8192
# K10 (csrc/scoring.cu): candidates a tile block, the most winners its last
# block sorts in shared memory
RERANK_TILE, RERANK_STAGE = 128, 8192
# K12 (csrc/scoring.cu): the most candidates a block takes, the most words of
# its [P, candidates] factor tile, the most shared memory its staged
# coefficients and row lists take
PREFIX_CANDS, PREFIX_FAC_WORDS, PREFIX_COEF_SMEM = 128, 8192, 96 * 1024
# K11 (csrc/scoring.cu): the most docs of a slot's sample a join block
# stages
JOIN_CAP = 16384
# K3: the signal rows a block takes; its dynamic shared memory (MAX_DYN_SMEM)
SIG_ROWS = 2
SIG_DYN_SMEM = 224 * 1024
# limits of csrc/encoder.cu: the head widths (any T); a grid's y and z
# dimensions (K5a's and K14a's heads and batch rows, K5d's spans, K16a-b's
# batch rows)
ATTN_HEAD_DIMS = (16, 32, 64)
GRID_YZ = 65535
# limits of K5b and K14b (csrc/encoder.cu): the widest row; K14b's rows a
# block and most blocks of its fixed grid
LN_MAX_N = 1024
LN_BWD_WARPS, LN_BWD_BLOCKS = 8, 264
# K14c (csrc/encoder.cu): the rows a block takes a step, the columns of a
# block, and the most blocks of its fixed grid
GELU_BWD_ROWS, GELU_BWD_COLS, GELU_BWD_BLOCKS = 32, 256, 264
# limits of K5d (csrc/encoder.cu): the backward's tokens a block (its
# grid's y: at most GRID_YZ spans) and the widest hidden state (a multiple
# of 8: 16-byte pieces)
POOL_SPAN, POOL_MAX_H = 32, 1024
# K15c's InfoNCE head (csrc/losses.cu): the most rows that one block takes
# (more go to the grid of INFO_NCE_GRID_ROWS rows a block and a second,
# ordered pass: the same result; the crossover is in csrc/losses.cu's note)
INFO_NCE_ONE_BLOCK, INFO_NCE_GRID_ROWS = 64, 8
# a block's shared memory on the card
MAX_SMEM = 227 * 1024
# K4 (csrc/forest.cu): threads a block, and the most blocks before its
# tile grows (4 an SM on 132 SMs: half a wave of its 256-thread blocks);
# a forest staged in chunks: the most blocks before its tile grows (one an
# SM), a chunk's shared memory (the first of FOREST_CHUNK_SMEM whose chunk
# holds FOREST_CHUNK_TREES trees: 3, 2 or 1 blocks an SM)
FOREST_THREADS, FOREST_BLOCKS = 256, 4 * 132
FOREST_SMS, FOREST_CHUNK_TREES = 132, 16
FOREST_CHUNK_SMEM = (MAX_SMEM // 4, MAX_SMEM // 2, MAX_SMEM)
# K1 and K2 (csrc/scoring.cu): the most blocks a query's cluster takes, the
# dynamic shared memory a block may take (MAX_DYN_SMEM), the bytes of a K1
# table slot (doc, text sum, mask word, aux word), the least slots a K1
# block takes while the cluster grows to fill the card
MAX_CLUSTER = 8
STAGE_A_DYN_SMEM = 224 * 1024
STAGE_A_SLOT_BYTES = 20
STAGE_A_MIN_PART = 1024
# K13 (csrc/scoring.cu): the entries a block of the merge holds in shared
# memory (a query of the one-block form, a tile of the global form)
MERGE_TILE = 8192


class PrefixPlan(NamedTuple):
    """K12's launch: `cands` candidates a block (a grid of ceil(K / cands) x B
    blocks), the live slots' L-row prefixes staged `group` at a time (0: the
    searches read the rows where they lie), the coefficients in shared memory
    where `staged`."""

    cands: int
    group: int
    staged: bool


def prefix_plan(P: int, L: int, K: int, nsig: int) -> PrefixPlan:
    """K12's blocks for P slots, L-row prefixes, K candidates and nsig signal
    rows, within a block's dynamic shared memory (STAGE_A_DYN_SMEM): the
    factor tile, the live slots' (slot, start, length), the coefficients with
    each row's 16-bit slot list where they fit PREFIX_COEF_SMEM, and as many
    prefixes as the rest holds."""
    cands = max(1, min(PREFIX_CANDS, K, PREFIX_FAC_WORDS // P))
    coef = 4 * (3 * nsig + 2) * P + 2 * nsig * P
    staged = coef <= PREFIX_COEF_SMEM
    fixed = 4 * (P * cands + 3 * P) + (coef if staged else 0)
    return PrefixPlan(cands, min(P, (STAGE_A_DYN_SMEM - fixed) // (4 * L)), staged)


class StageAPlan(NamedTuple):
    """K1's table for the queries of one launch: `entries` is the largest
    query's E = sum_p min(len_p, L), `slots` the power of two >= 3E/2 (at
    least 64) a query holds, `cluster` the blocks a query takes, `form` where
    the table lies: "block" or "cluster" (shared memory, slots / cluster a
    block) or "global" (an [n, slots] table in device memory)."""

    entries: int
    slots: int
    cluster: int
    form: str


def _pow2_at_least(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


@functools.lru_cache(maxsize=None)
def _stage_a_part_max(K: int) -> int:
    """The most table slots (a power of two) a K1 block holds in shared
    memory beside the sort buffers of K."""
    part = 1
    while 2 * part * STAGE_A_SLOT_BYTES + 8 * _pow2_at_least(K) <= STAGE_A_DYN_SMEM:
        part *= 2
    return part


def stage_a_plan(entries: int, B: int, K: int, sms: int) -> StageAPlan:
    """K1's table for B queries from the largest one's entries, on a card of
    `sms` SMs: T = the power of two >= 3E/2 slots (load at most 2/3). The
    blocks a query needs are those whose shared memory holds T slots beside
    the sort buffers; more are taken, in powers of two up to MAX_CLUSTER,
    while the launch still fits the card's SMs and each block keeps
    STAGE_A_MIN_PART slots. A table that needs more than MAX_CLUSTER blocks
    goes to global memory, its select over MAX_CLUSTER blocks a query (each
    block's keys, 4 B a slot, then fit its shared memory up to T = 262,144
    at K = 4,096)."""
    T = max(_pow2_at_least(-(-3 * max(int(entries), 0) // 2)), 64)
    part_max = _stage_a_part_max(K)
    fill = 1
    while 2 * fill <= MAX_CLUSTER and B * 2 * fill <= sms:
        fill *= 2
    need = max(1, T // part_max)
    if need > MAX_CLUSTER:
        return StageAPlan(int(entries), T, MAX_CLUSTER, "global")
    cluster = max(need, min(fill, max(1, T // STAGE_A_MIN_PART)))
    return StageAPlan(int(entries), T, cluster, "block" if cluster == 1 else "cluster")


def stage_a_launches(entries, K: int, sms: int) -> list:
    """K1's launches for a batch whose queries have `entries` (E_b, one a
    query): one over the batch where every table takes the same kind of
    memory, else one over the queries whose tables fit shared memory and one
    over the rest, each planned from its own queries, so a long query never
    moves the short ones' tables to global memory. → [(rows, plan)], rows
    the batch's query indices (int32 numpy) or None for the whole batch."""
    e = np.asarray(entries, dtype=np.int64).reshape(-1)
    # past 2/3 of MAX_CLUSTER blocks' slots, a table is global (stage_a_plan)
    glob = 3 * e > 2 * MAX_CLUSTER * _stage_a_part_max(K)
    if glob.all() or not glob.any():
        return [(None, stage_a_plan(int(e.max(initial=0)), len(e), K, sms))]
    out = []
    for part in (~glob, glob):
        rows = np.nonzero(part)[0].astype(np.int32)
        out.append((rows, stage_a_plan(int(e[rows].max()), len(rows), K, sms)))
    return out


_SMS: dict = {}


def card_sms(device) -> int:
    """The SM count of a card (read once a device)."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


class MergePlan(NamedTuple):
    """K13's form for queries of N = P*L entries: "block" (one block's shared
    memory holds the query; cluster 1) or "global" (the network in [B, N]
    rows in device memory, tiles of MERGE_TILE; cluster 0)."""

    form: str
    cluster: int


def merge_plan(N: int) -> MergePlan:
    """K13's form from a query's entries: one block up to MERGE_TILE = 8,192
    entries (12 B each, 96 KB beside the select's sort buffer, 32 KB at C =
    4,096), past that the global form (the main path's P = 64, L = 1,024)."""
    return MergePlan("block", 1) if N <= MERGE_TILE else MergePlan("global", 0)


class JoinPlan(NamedTuple):
    """K11's sample of each slot: at most `sample` docs (within JOIN_CAP) in
    a block's shared memory; a range no longer is staged whole."""

    sample: int


def join_plan(Kd: int) -> JoinPlan:
    """K11's plan for Kd candidates a query (PERF.md §6 has the readings it
    rests on)."""
    return JoinPlan(256)


def join_steps(n_rows: int) -> int:
    """The reference's fixed step count of the search over n_rows rows (the
    bit length of n_rows - 1, at least 1)."""
    return max(int(n_rows - 1).bit_length(), 1)


def join_regime(length: int, n_rows: int, plan: JoinPlan) -> str:
    """How K11 joins a slot of `length` rows: "empty", "whole" (staged whole,
    searched in shared memory), "sample" (searched from a sample), or
    "reference" (a range of 2^steps rows or more, where the reference's
    fixed step count stops short: bisected whole for those steps alone)."""
    if length <= 0:
        return "empty"
    if length >> join_steps(n_rows):
        return "reference"
    return "whole" if length <= plan.sample else "sample"


class SignalsPlan(NamedTuple):
    """K3's shared memory: `staged`, the rows' coefficients there (else read
    where they lie); `rows_on_chip`, a q16 call's values there (else in an
    f32 [B, nsig, K] matrix in device memory; f32 rows go there always)."""

    staged: bool
    rows_on_chip: bool


def signals_plan(P: int, K: int, q16: bool) -> SignalsPlan:
    """K3's plan for P slots and K columns: everything in shared memory where
    it fits (the main path's P = 16, K <= 4,096), else the values, then the
    coefficients, in device memory."""
    coef, rows = (3 * SIG_ROWS + 3) * P * 4, SIG_ROWS * K * 4
    if q16 and coef + rows <= SIG_DYN_SMEM:
        return SignalsPlan(True, True)
    return SignalsPlan(coef <= SIG_DYN_SMEM, False)


def stage_b_cluster(Kd: int) -> int:
    """K2's blocks a query: one for each 1,024 candidates, in powers of two up
    to 4 (Kd = 4,096, the main path's: 4)."""
    c = 1
    while 2 * c <= 4 and 2 * c * 1024 <= Kd:
        c *= 2
    return c

# launches per kernel since the last reset_launches(): the proof that a run of
# the main path went through the kernels
# (a stage-A launch counts once: under "stage_a_merge" through the merge
# network, else "stage_a_ub" when it folds UB bounds, else "stage_a_q8" on q8
# rows, else "stage_a"; K11's launches count under the entry point they
# serve: "factors_join" alone, "stage_b_joined" and "signals_joined" before
# K2 ("stage_b") and K3 ("signals_q16") in the joined stage B and pass 2;
# "signals_prefix" is K12; "moe_router" and "moe_select" count forward and
# backward calls alike (the router's backward call, its kernel and the column
# sum, once), and "gelu_tanh", K16c, its two launches; "pair_loss" and
# "info_nce" are K15c's two heads; "mean_pool" counts K5d's forward and
# backward launches alike; "bfs_relax" counts K7's frontier steps)
LAUNCHES = {"stage_a": 0, "stage_a_q8": 0, "stage_a_ub": 0, "stage_a_merge": 0, "stage_b": 0,
            "signals_q16": 0, "factors_join": 0, "stage_b_joined": 0, "signals_joined": 0,
            "signals_prefix": 0, "dense_rerank": 0, "forest": 0, "attention": 0,
            "add_layernorm": 0, "bias_gelu": 0, "mean_pool": 0, "attention_backward": 0,
            "add_layernorm_backward": 0, "bias_gelu_backward": 0, "adamw": 0,
            "moe_router": 0, "moe_select": 0, "pair_loss": 0, "info_nce": 0, "adamw_bf16": 0,
            "hll_merge": 0, "hll_estimate": 0, "bfs_relax": 0, "mesh_topk": 0,
            "hll_ring_step": 0, "stage_attention": 0, "stage_attention_backward": 0,
            "gelu_tanh": 0, "sgd": 0}

_lock = threading.Lock()
_count_lock = threading.Lock()  # the server launches from two worker threads
_libs: dict = {}


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        for k in MESH_TOPK_CALLS:
            MESH_TOPK_CALLS[k] = 0


def counted(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def on_device(x, dev, dtype=None):
    """A kernel argument of any origin (tensor, array, list) as a contiguous
    tensor on `dev` (None stays None)."""
    if x is None:
        return None
    if (isinstance(x, torch.Tensor) and x.device == torch.device(dev)
            and (dtype is None or x.dtype == dtype) and x.is_contiguous()):
        return x  # already in place: no call into the dispatcher
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    return t.to(device=dev, dtype=dtype).contiguous()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _library(name: str) -> str:
    return os.path.join(BUILD_DIR, f"libstract_{name}.so")


def build(verbose: bool = False) -> dict:
    """Compile every library that is missing or older than its source, one
    nvcc process per source, all started together; → {name: library path}.
    Raises with the compiler's output on any failure."""
    with _lock:
        stale = {}
        headers = max((os.path.getmtime(os.path.join(CSRC, f)) for f in os.listdir(CSRC)
                       if f.endswith(".cuh")), default=0.0)
        for name, src in SOURCES.items():
            lib, src = _library(name), os.path.join(CSRC, src)
            if not os.path.exists(lib) or os.path.getmtime(lib) < max(os.path.getmtime(src),
                                                                      headers):
                stale[name] = (src, lib)
        if stale:
            os.makedirs(BUILD_DIR, exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            for name, (src, lib) in stale.items():
                tmp = f"{lib}.{os.getpid()}.tmp"
                cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-o", tmp, src]
                procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                                text=True), tmp, lib)
            failed = []
            for name, (proc, tmp, lib) in procs.items():
                out, err = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"nvcc {SOURCES[name]} failed ({proc.returncode}):\n{out}\n{err}")
                    continue
                if verbose:
                    print(f"[nvcc {SOURCES[name]}]\n{err}", flush=True)
                os.replace(tmp, lib)
            if failed:
                raise RuntimeError("\n".join(failed))
        return {name: _library(name) for name in SOURCES}


class SegArgs(ctypes.Structure):
    _fields_ = [("static_cols", ctypes.c_void_p), ("static_default", ctypes.c_void_p),
                ("region_ids", ctypes.c_void_p), ("last_updated", ctypes.c_void_p),
                ("db", ctypes.c_longlong), ("static_scale", ctypes.c_float),
                ("num_docs", ctypes.c_int)]


class QueryArgs(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "starts", "lens", "group", "n_required", "idf", "w_bm25", "w_bm25f", "w_presence",
        "static_coeffs", "region_lut", "coeff_region", "coeff_update", "current_ts",
        "soft_bonus")] + [("B", ctypes.c_int), ("P", ctypes.c_int)]


class AggArgs(ctypes.Structure):
    _fields_ = [("bm25", ctypes.c_void_p), ("bm25f", ctypes.c_void_p), ("idf", ctypes.c_void_p),
                ("cov", ctypes.c_void_p), ("static_of_sig", ctypes.c_void_p),
                ("nsig", ctypes.c_int), ("bm25f_row", ctypes.c_int),
                ("region_row", ctypes.c_int), ("update_row", ctypes.c_int)]


class SignalArgs(ctypes.Structure):
    """K3's per-query rows: each array's query b at its address + b x its
    stride (floats)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "idf", "region_lut", "current_ts", "bm25", "bm25f", "aidf", "cov", "static_of_sig")] + [
        ("stride", ctypes.c_longlong * 7), ("P", ctypes.c_int), ("nsig", ctypes.c_int),
        ("bm25f_row", ctypes.c_int), ("region_row", ctypes.c_int), ("update_row", ctypes.c_int)]


# K16d (csrc/stage.cu): tensors a launch, elements a block
SGD_MAX_TENSORS, SGD_TILE = 64, 4096


class SgdArgs(ctypes.Structure):
    _fields_ = [("p", ctypes.c_void_p * SGD_MAX_TENSORS), ("g", ctypes.c_void_p * SGD_MAX_TENSORS),
                ("n", ctypes.c_longlong * SGD_MAX_TENSORS),
                ("first_block", ctypes.c_longlong * (SGD_MAX_TENSORS + 1)),
                ("count", ctypes.c_int), ("lr", ctypes.c_float)]


def _load(name: str):
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = build()[name]
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(path)
            P, I, F, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
            if name == "scoring":
                seg, qry = ctypes.POINTER(SegArgs), ctypes.POINTER(QueryArgs)
                agg = ctypes.POINTER(AggArgs)
                lib.stract_stage_a.argtypes = [seg, qry, P, LL, I, P, I, P, P, I, I, I, I, I, I,
                                               F, P, P, P, P, P, P, P]
                lib.stract_stage_a_merge.argtypes = [seg, qry, P, LL, I, P, P, I, I, I, I, I,
                                                     F, P, P, P, P, P, P, P]
                lib.stract_stage_b.argtypes = [seg, qry, agg, P, P, I, I, F, I, I, I, P, P, P, P,
                                               P]
                lib.stract_signals_q16.argtypes = [seg, ctypes.POINTER(SignalArgs), P, P, I, I,
                                                   F, I, P, P, P, P]
                lib.stract_factors_join.argtypes = [P, LL, I, P, P, P, I, I, I, I, I, P, P]
                lib.stract_signals_prefix.argtypes = [seg, qry, agg, P, LL, I, P, I, I, I, I,
                                                      I, I, F, P, P]
                lib.stract_dense_rerank.argtypes = [P, I, P, P, I, I, I, F, I, P, P, P, P, P]
                lib.stract_mesh_topk.argtypes = [ctypes.POINTER(MeshLists), I, I, I, I, P, P, P,
                                                 P, P]
                fns = (lib.stract_stage_a, lib.stract_stage_a_merge, lib.stract_stage_b,
                       lib.stract_signals_q16,
                       lib.stract_factors_join, lib.stract_signals_prefix,
                       lib.stract_dense_rerank,
                       lib.stract_mesh_topk)
            elif name == "forest":
                lib.stract_forest.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, P]
                fns = (lib.stract_forest,)
            elif name == "graph":
                lib.stract_hll_merge.argtypes = [P, P, P, P, P, I, I, I, I, F, P, P, P, P, P]
                lib.stract_hll_estimate.argtypes = [P, I, I, F, P, P]
                lib.stract_bfs_step.argtypes = [P, P, P, P, I, I, I, I, I, P, P, P, P, P]
                lib.stract_hll_ring_step.argtypes = [P, P, P, P, P, P, I, I, I, I, F, P, P, P, P,
                                                     P]
                fns = (lib.stract_hll_merge, lib.stract_hll_estimate, lib.stract_bfs_step,
                       lib.stract_hll_ring_step)
            elif name == "moe":
                lib.stract_moe_router.argtypes = [P, P, P, I, I, I, P, P, P, P]
                lib.stract_moe_router_backward.argtypes = [P, P, P, P, P, I, I, I, I, P, P, P]
                lib.stract_moe_select.argtypes = [P, P, P, I, I, P, P]
                lib.stract_moe_select_backward.argtypes = [P, P, P, P, I, I, I, P, P, P]
                fns = (lib.stract_moe_router, lib.stract_moe_router_backward,
                       lib.stract_moe_select, lib.stract_moe_select_backward)
            elif name == "stage":
                lib.stract_stage_attention.argtypes = [P, P, I, I, I, P]
                lib.stract_stage_attention_backward.argtypes = [P, P, P, P, P, I, I, I, P]
                lib.stract_sgd_multi.argtypes = [ctypes.POINTER(SgdArgs), LL, P]
                lib.stract_gelu_tanh.argtypes = [P, P, LL, P]
                lib.stract_gelu_tanh_backward.argtypes = [P, P, P, LL, P]
                fns = (lib.stract_stage_attention, lib.stract_stage_attention_backward,
                       lib.stract_sgd_multi, lib.stract_gelu_tanh,
                       lib.stract_gelu_tanh_backward)
            elif name == "losses":
                lib.stract_info_nce.argtypes = [P, P, P, P, I, I, P]
                lib.stract_pair_loss.argtypes = [P, P, P, P, P, P, P, I, F, I, P]
                fns = (lib.stract_info_nce, lib.stract_pair_loss)
            else:
                lib.stract_attention.argtypes = [P, P, P, P, P, I, I, I, I, P]
                lib.stract_attention_backward.argtypes = [P, P, P, P, P, P, P, P, P, I, I, I, I,
                                                          P]
                lib.stract_bias_gelu.argtypes = [P, P, P, LL, I, F, F, P]
                lib.stract_add_layernorm_backward.argtypes = [P, P, P, P, P, P, P, P, LL, I, I, F,
                                                              P]
                lib.stract_bias_gelu_backward.argtypes = [P, P, P, P, P, P, LL, I, I, F, F, P]
                lib.stract_add_layernorm.argtypes = [P, P, P, P, P, LL, I, F, P]
                lib.stract_mean_pool.argtypes = [P, P, P, P, I, I, I, I, P]
                lib.stract_mean_pool_backward.argtypes = [P, P, P, P, I, I, I, I, P]
                fns = (lib.stract_attention, lib.stract_attention_backward, lib.stract_bias_gelu,
                       lib.stract_add_layernorm_backward, lib.stract_bias_gelu_backward,
                       lib.stract_add_layernorm, lib.stract_mean_pool,
                       lib.stract_mean_pool_backward)
            for fn in fns:
                fn.restype = ctypes.c_int
            _libs[name] = lib
    return _libs[name]


def _ptr(t: torch.Tensor | None, dtype: torch.dtype, shape: tuple | None = None) -> int | None:
    """Device pointer of a kernel argument, after checking that it is a
    contiguous CUDA tensor of the dtype (and shape) the kernel reads."""
    if t is None:
        return None
    if not t.is_cuda or not t.is_contiguous() or t.dtype != dtype:
        raise ValueError(f"kernel argument must be a contiguous CUDA {dtype} tensor, "
                         f"got {t.dtype} on {t.device}")
    if shape is not None and t.shape != tuple(shape):
        raise ValueError(f"kernel argument has shape {tuple(t.shape)}, expected {tuple(shape)}")
    return t.data_ptr()


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def card_of(*tensors) -> torch.device:
    """The one device that a launch's tensors (None skipped) lie on; raises
    ValueError when they lie on more than one."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"a launch takes tensors on one card, not on {sorted(map(str, devs))}")
    return devs.pop()


class on_card:
    """The context of every launch of a csrc/ kernel: the card that the
    launch's tensors lie on (ValueError when more than one) made current
    for the launch, and its current stream's handle yielded for the launch
    to take. So a shard on cuda:1 launches in cuda:1's context on cuda:1's
    stream, whatever card is current. (The raw handle, not
    torch.cuda.current_stream(dev): that builds a Stream object under a
    second device switch, 9 of the 14 us this context took on the H100.)"""

    __slots__ = ("_idx", "_prev")

    def __init__(self, *tensors):
        self._idx = card_of(*tensors).index

    def __enter__(self) -> int:
        self._prev = torch.cuda._exchange_device(self._idx)
        return torch._C._cuda_getCurrentRawStream(self._idx)

    def __exit__(self, *exc) -> bool:
        torch.cuda._maybe_exchange_device(self._prev)
        return False


def _seg_tensors(seg) -> tuple:
    return (seg.postings, seg.static_cols, seg.static_default, seg.region_ids, seg.last_updated)


def _query_tensors(q) -> tuple:
    return tuple(getattr(q, name) for name, _ in QueryArgs._fields_[:14])


# the argument blocks of the segments launched last: id of the arrays tuple →
# (the tuple, held so that its tensors and its id stay put, its SegArgs)
_SEG_ARGS: dict = {}
_SEG_ARGS_KEPT = 8
_SEG_ARGS_LOCK = threading.Lock()


def seg_args(seg) -> SegArgs:
    """A segment's argument block, built once a segment (an index's
    DeviceSegment keeps one arrays tuple): the last _SEG_ARGS_KEPT tuples
    are held beside their blocks, so every address in a block stays a live
    tensor's."""
    with _SEG_ARGS_LOCK:
        hit = _SEG_ARGS.get(id(seg))
    if hit is not None and hit[0] is seg:
        return hit[1]
    f32, db = torch.float32, seg.static_default.shape[0]
    s = SegArgs(_ptr(seg.static_cols, f32, (_NUM_STATIC, db)), _ptr(seg.static_default, f32),
                _ptr(seg.region_ids, torch.int32, (db,)), _ptr(seg.last_updated, f32, (db,)),
                db, float(seg.static_scale), int(seg.num_docs))
    with _SEG_ARGS_LOCK:
        while len(_SEG_ARGS) >= _SEG_ARGS_KEPT:
            _SEG_ARGS.pop(next(iter(_SEG_ARGS)))
        _SEG_ARGS[id(seg)] = (seg, s)
    return s


def forget_seg_args(seg) -> None:
    """Drop the argument block of the arrays tuple `seg`, releasing its
    tensors; the owner calls it when it lets the tuple go (a DeviceSegment
    the live index dropped frees its card memory then, not after
    _SEG_ARGS_KEPT later launches). A launch under way holds `seg` itself."""
    with _SEG_ARGS_LOCK:
        hit = _SEG_ARGS.get(id(seg))
        if hit is not None and hit[0] is seg:
            del _SEG_ARGS[id(seg)]


_QUERY_SHAPES = {"starts": "BP", "lens": "BP", "group": "BP", "n_required": "B", "idf": "BP",
                 "w_bm25": "BP", "w_bm25f": "BP", "w_presence": "BP", "static_coeffs": "BS",
                 "region_lut": "BR", "coeff_region": "B", "coeff_update": "B",
                 "current_ts": "B", "soft_bonus": "B"}
_INT_QUERY_FIELDS = ("starts", "lens", "group", "n_required")
_NUM_STATIC, _NUM_REGIONS = 11, 16


# each slot field's dtype and shape, in QueryArgs order
_QUERY_FIELDS = tuple((name, torch.int32 if name in _INT_QUERY_FIELDS else torch.float32,
                       _QUERY_SHAPES[name]) for name, _ in QueryArgs._fields_[:14])


def query_args(q) -> QueryArgs:
    B, P = q.starts.shape
    shapes = {"BP": (B, P), "B": (B,), "BS": (B, _NUM_STATIC), "BR": (B, _NUM_REGIONS)}
    return QueryArgs(*[_ptr(t, dtype, shapes[dims])
                       for t, (_, dtype, dims) in zip(q, _QUERY_FIELDS)], B, P)


def agg_args(a, static_of_sig: torch.Tensor, bm25f_row: int, region_row: int,
             update_row: int) -> AggArgs:
    f32 = torch.float32
    B, nsig, P = a.agg_bm25.shape
    return AggArgs(_ptr(a.agg_bm25, f32), _ptr(a.agg_bm25f, f32, (B, 1, P)),
                   _ptr(a.agg_idf, f32, (B, nsig, P)), _ptr(a.agg_cov, f32, (B, nsig, P)),
                   _ptr(static_of_sig, torch.int32, (nsig,)), nsig, bm25f_row, region_row,
                   update_row)


def _postings(seg) -> tuple:
    """(address, rows, row width) of a segment's posting rows: [Ptot, 3] q16
    rows or [Ptot, 2] q8 rows."""
    n_rows, w = seg.postings.shape
    if w not in (2, 3) or n_rows < 1:
        raise ValueError(f"posting rows are [Ptot, 3] (q16) or [Ptot, 2] (q8), not "
                         f"{tuple(seg.postings.shape)}")
    return _ptr(seg.postings, torch.int32, (n_rows, w)), int(n_rows), int(w)


def stage_a(seg, q, L: int, K: int, plan: StageAPlan, table, default_static: bool,
            soft_required: bool, inv_fs: float, out_docs, out_scores, ub_entry=None,
            ub_total=None, rows=None) -> None:
    """K1 over q16 or q8 rows for the queries `rows` (i32[n] on the card; None:
    the whole batch) with the table of `plan` (stage_a_plan of their largest
    query: plan.slots must exceed it); table: for the global form (keys i32,
    fixed-point sums i64, masks i64, aux i32), each [n, plan.slots], else
    None. ub_entry f32[B, P] with ub_total f32[B] turn block-max UB scoring
    on. The outputs' rows of the queries named are written."""
    if not 1 <= K <= MAX_SORT:
        raise ValueError(f"stage A keeps 1..{MAX_SORT} candidates per query, not {K}")
    if (ub_entry is None) != (ub_total is None):
        raise ValueError("UB scoring takes ub_entry and ub_total together")
    T, cluster = plan.slots, plan.cluster
    if not (cluster in (1, 2, 4, 8) and T >= cluster and T & (T - 1) == 0):
        raise ValueError(f"K1 takes a power-of-two table over 1, 2, 4 or 8 blocks, not {T} "
                         f"slots over {cluster}")
    if (table is None) != (plan.form != "global"):
        raise ValueError(f"the {plan.form} form takes {'a' if plan.form == 'global' else 'no'} "
                         "global table")
    if table is None and (T // cluster * STAGE_A_SLOT_BYTES + 8 * _pow2_at_least(K)
                          > STAGE_A_DYN_SMEM):
        raise ValueError(f"{T // cluster} slots a block and the sort of {K} do not fit a "
                         "block's shared memory")
    B, P = q.starts.shape
    n = B if rows is None else rows.shape[0]
    if rows is not None and (rows.dim() != 1 or not 1 <= n <= B):
        raise ValueError(f"K1 takes 1..{B} query rows, not {tuple(rows.shape)}")
    i32, i64, f32 = torch.int32, torch.int64, torch.float32
    post, n_rows, w = _postings(seg)
    ub_e, ub_t = _ptr(ub_entry, f32, (B, P)), _ptr(ub_total, f32, (B,))
    glob = ((None,) * 4 if table is None else
            tuple(_ptr(t, dt, (n, T)) for t, dt in zip(table, (i32, i64, i64, i32))))
    outs = (_ptr(out_docs, i32, (B, K)), _ptr(out_scores, f32, (B, K)))
    rows_p = _ptr(rows, i32, (n,))
    lib = _load("scoring")
    s, qa = seg_args(seg), query_args(q)
    with on_card(*_seg_tensors(seg), *_query_tensors(q), rows, ub_entry, *(table or ()),
                 out_scores) as stream:
        rc = lib.stract_stage_a(
            ctypes.byref(s), ctypes.byref(qa), post, n_rows, w, rows_p, n, ub_e, ub_t, L, K, T,
            cluster, int(default_static), int(soft_required), inv_fs, *glob, *outs, stream)
    _check(rc, "stract_stage_a")
    counted("stage_a_ub" if ub_entry is not None else "stage_a_q8" if w == 2 else "stage_a")


def stage_a_merge(seg, q, L: int, K: int, default_static: bool, soft_required: bool,
                  inv_fs: float, net, out_docs, out_scores, ub_entry=None,
                  ub_total=None) -> None:
    """K13: stage A through the P-way bitonic merge of the [P, L] tiles, in
    the form merge_plan(P*L) gives. net: for K = 0 (the network alone)
    its output rows (mkey i32[B, N], mcon f32[B, N], maux i32[B, N] or None:
    the aux words not carried); for K > 0 None in shared memory, or the
    global form's scratch (mkey, mcon, maux (None unless default_static),
    tsum i32[B, N / MERGE_TILE, 5])."""
    B, P = q.starts.shape
    N = P * L
    if not (P >= 2 and P & (P - 1) == 0 and L >= 1 and L & (L - 1) == 0 and N <= 1 << 24):
        raise ValueError(f"the merge takes [P, L] tiles of powers of two, P >= 2, not {P} x {L}")
    if not 0 <= K <= MAX_SORT:
        raise ValueError(f"stage A keeps 0..{MAX_SORT} candidates per query, not {K}")
    if K and (ub_entry is None) != (ub_total is None):
        raise ValueError("UB scoring takes ub_entry and ub_total together")
    plan = merge_plan(N)
    glob = plan.form == "global"
    if (K == 0 or glob) != (net is not None):
        raise ValueError("the network alone and the global form take their [B, N] rows; "
                         "the merge in shared memory takes none")
    i32, f32 = torch.int32, torch.float32
    rows = (None,) * 4
    if net is not None:
        mkey, mcon, maux, *tsum = net
        if K and glob and default_static and maux is None:
            raise ValueError("the default static score reads the aux words: maux is needed")
        rows = (_ptr(mkey, i32, (B, N)), _ptr(mcon, f32, (B, N)), _ptr(maux, i32, (B, N)),
                _ptr(tsum[0], i32, (B, N // MERGE_TILE, 5)) if K and glob else None)
    outs = ((_ptr(out_docs, i32, (B, K)), _ptr(out_scores, f32, (B, K))) if K else (None, None))
    ub_e, ub_t = _ptr(ub_entry, f32, (B, P)), _ptr(ub_total, f32, (B,))
    post, n_rows, w = _postings(seg)
    lib = _load("scoring")
    s, qa = seg_args(seg), query_args(q)
    with on_card(*_seg_tensors(seg), *_query_tensors(q), ub_entry, *(net or ()),
                 out_scores) as stream:
        rc = lib.stract_stage_a_merge(ctypes.byref(s), ctypes.byref(qa), post, n_rows, w, ub_e,
                                      ub_t, L, K, plan.cluster, int(default_static),
                                      int(soft_required), inv_fs, *rows, *outs, stream)
    _check(rc, "stract_stage_a_merge")
    counted("stage_a_merge")


def check_stage_b(Kd: int, k: int, ks: int = 0) -> None:
    """K2's shape limits (ValueError): 1..MAX_SORT candidates, 1..Kd kept,
    0..MAX_SIG_K signal columns. The joined stage B checks them before its
    join."""
    if not 1 <= Kd <= MAX_SORT or not 1 <= k <= Kd or not 0 <= ks <= min(MAX_SIG_K, k):
        raise ValueError(f"stage B takes 1..{MAX_SORT} candidates, keeps 1..Kd and fuses "
                         f"0..{MAX_SIG_K} signal columns, not {Kd}, {k} and {ks}")


def stage_b(seg, q, aggs: AggArgs, factors, cand, default_static: bool, inv_fs: float,
            k: int, ks: int, out_docs, out_scores, out_sq, out_scale) -> None:
    """K2 over stage_b_cluster(Kd) blocks a query."""
    Kd = cand.shape[1]
    check_stage_b(Kd, k, ks)
    B, P = q.starts.shape
    cluster = stage_b_cluster(Kd)
    if cluster not in (1, 2, 4, 8) or cluster > Kd:
        raise ValueError(f"stage B takes 1, 2, 4 or 8 blocks a query, at most Kd = {Kd}, not "
                         f"{cluster}")
    lib = _load("scoring")
    s, qa = seg_args(seg), query_args(q)
    i32, f32 = torch.int32, torch.float32
    with on_card(*_seg_tensors(seg), *_query_tensors(q), factors, cand, out_scores) as stream:
        rc = lib.stract_stage_b(
            ctypes.byref(s), ctypes.byref(qa), ctypes.byref(aggs), _ptr(factors, i32, (B, P, Kd)),
            _ptr(cand, i32, (B, Kd)), Kd, int(default_static), inv_fs, k, ks, cluster,
            _ptr(out_docs, i32, (B, k)), _ptr(out_scores, f32, (B, k)),
            _ptr(out_sq, torch.int16, (B, aggs.nsig, ks)), _ptr(out_scale, f32, (B, aggs.nsig)),
            stream)
    _check(rc, "stract_stage_b")
    counted("stage_b")


def _query_contiguous(t: torch.Tensor) -> bool:
    """Whether each index of t's first dimension is a contiguous block."""
    step = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != step:
            return False
        step *= size
    return True


def signal_args(rows, static_of_sig: torch.Tensor, bm25f_row: int, region_row: int,
                update_row: int) -> SignalArgs:
    """K3's argument block over its per-query rows (idf [B, P], region_lut
    [B, 16], current_ts [B], bm25 [B, nsig, P], bm25f [B, 1, P], idf rows
    [B, nsig, P], cov [B, nsig, P], f32 on one card): each query's part of
    each contiguous, the queries at any stride (views of one packed upload,
    or the tensors themselves)."""
    idf, region_lut, current_ts, bm25, bm25f, aidf, cov = rows
    B, P = idf.shape
    nsig = bm25.shape[1]
    shapes = ((P,), (_NUM_REGIONS,), (), (nsig, P), (1, P), (nsig, P), (nsig, P))
    card_of(*rows, static_of_sig)
    ptrs, strides = [], []
    for t, shape in zip(rows, shapes):
        if (not t.is_cuda or t.dtype != torch.float32 or tuple(t.shape) != (B, *shape)
                or not _query_contiguous(t)):
            raise ValueError(f"a pass-2 row is a CUDA f32 [B, {shape}] with each query's part "
                             f"contiguous, not {t.dtype} {tuple(t.shape)} on {t.device}")
        ptrs.append(t.data_ptr())
        strides.append(t.stride(0))
    return SignalArgs(*ptrs, _ptr(static_of_sig, torch.int32, (nsig,)),
                      (ctypes.c_longlong * 7)(*strides), P, nsig, bm25f_row, region_row,
                      update_row)


def signals_q16(seg, a: SignalArgs, factors, cand, inv_fs: float, out_q, out_scale,
                rows=None) -> None:
    """K3 (2 signal rows a block): factors i32[B, P, K], cand i32[B, K] and
    the rows of `a` (signal_args) → out_q i16[B, nsig, K], out_scale f32[B,
    nsig]; or, with out_q and out_scale None, the f32 rows `rows` [B, nsig,
    K] (as signal_entry sums them: the values the q16 rows quantise). Any K
    and P: signals_plan keeps in shared memory what fits."""
    B, K = cand.shape
    if K < 1 or not 1 <= B <= 65535 or a.nsig < 1 or a.P < 1:
        raise ValueError(f"pass 2 takes candidates of 1..65535 queries, signal rows and slots, "
                         f"not {K} of {B}, {a.nsig} x {a.P}")
    if (out_q is None) != (out_scale is None) or (out_q is None) == (rows is None):
        raise ValueError("pass 2 writes q16 rows with their scales, or f32 rows")
    P, f32 = a.P, torch.float32
    plan = signals_plan(P, K, out_q is not None)
    if out_q is not None and not plan.rows_on_chip:  # the values wait in device memory
        rows = torch.empty((B, a.nsig, K), dtype=f32, device=cand.device)
    ptrs = (_ptr(factors, torch.int32, (B, P, K)), _ptr(cand, torch.int32, (B, K)))
    outs = (_ptr(rows, f32, (B, a.nsig, K)), _ptr(out_q, torch.int16, (B, a.nsig, K)),
            _ptr(out_scale, f32, (B, a.nsig)))
    lib = _load("scoring")
    s = seg_args(seg)
    with on_card(*_seg_tensors(seg), factors, cand, rows, out_q, out_scale) as stream:
        rc = lib.stract_signals_q16(ctypes.byref(s), ctypes.byref(a), *ptrs, B, K, inv_fs,
                                    int(plan.staged), *outs, stream)
    _check(rc, "stract_signals_q16")
    counted("signals_q16")


def factors_join(seg, starts, lens, cand, out, count: str = "factors_join") -> None:
    """K11: starts, lens i32[B, P], cand i32[B, Kd] → out i32[B, P, Kd], the
    packed factors of each candidate in each slot's full posting range
    (ops/scoring.py allocates), each slot as join_plan picks. The ranges must
    be doc-ascending, as the index's stage-B and pass-2 slots are (their
    compacted slots carry no impact prefix): there the output equals the
    reference's lockstep search bit for bit. `count` names the entry point
    whose launch this is (factors_join, stage_b_joined, signals_joined)."""
    (B, P), Kd = starts.shape, cand.shape[1]
    if not (1 <= B <= 65535 and 1 <= P <= 65535 and Kd >= 1):
        raise ValueError(f"the join takes 1..65535 queries and slots, not {B} x {P} x {Kd}")
    i32 = torch.int32
    post, n_rows, w = _postings(seg)
    ptrs = (_ptr(starts, i32, (B, P)), _ptr(lens, i32, (B, P)), _ptr(cand, i32, (B, Kd)))
    o = _ptr(out, i32, (B, P, Kd))
    plan = join_plan(Kd)
    if not 1 <= plan.sample <= JOIN_CAP:
        raise ValueError(f"the join samples 1..{JOIN_CAP} docs of a slot, not {plan}")
    lib = _load("scoring")
    with on_card(seg.postings, starts, lens, cand, out) as stream:
        rc = lib.stract_factors_join(post, n_rows, w, *ptrs, B, P, Kd, join_steps(n_rows),
                                     plan.sample, o, stream)
    _check(rc, "stract_factors_join")
    counted(count)


def signals_prefix(seg, q, aggs: AggArgs, cand, inv_fs: float, L: int, steps: int,
                   out) -> None:
    """K12: pass 2 from the first L >= 1 rows of each slot, searched in
    `steps` steps, over prefix_plan's blocks. cand i32[B, K] → out f32[B,
    nsig, K]."""
    (B, P), K = q.starts.shape, cand.shape[1]
    if K < 1 or not 1 <= P <= MAX_SEARCH_P or not 1 <= aggs.nsig <= MAX_NSIG or L < 1 or \
            steps < 1:
        raise ValueError(f"pass 2 takes 1..{MAX_SEARCH_P} slots, 1..{MAX_NSIG} signal rows and "
                         f"a prefix of L >= 1 rows in steps >= 1, not {P}, {aggs.nsig}, {L}, "
                         f"{steps}")
    plan = prefix_plan(P, L, K, aggs.nsig)
    post, n_rows, w = _postings(seg)
    c = _ptr(cand, torch.int32, (B, K))
    o = _ptr(out, torch.float32, (B, aggs.nsig, K))
    lib = _load("scoring")
    s, qa = seg_args(seg), query_args(q)
    with on_card(*_seg_tensors(seg), *_query_tensors(q), cand, out) as stream:
        rc = lib.stract_signals_prefix(ctypes.byref(s), ctypes.byref(qa), ctypes.byref(aggs), post,
                                       n_rows, w, c, K, L, steps, plan.cands, plan.group,
                                       int(plan.staged), inv_fs, o, stream)
    _check(rc, "stract_signals_prefix")
    counted("signals_prefix")


_RERANK_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# K10's tickets a query: u32 zeros on each (card, stream), left at zero by
# every launch, grown when a batch is larger
_RERANK_TICKETS: dict = {}


def order_keys(x: torch.Tensor) -> torch.Tensor:
    """csrc/scoring.cu's order_key of f32 x, as int64: a monotone map under
    which +0 sorts above -0, as lax.top_k ranks them on the CPU."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 2 ** 31, u ^ 0xFFFFFFFF, u | 2 ** 31)


def top_order(x: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest of f32 x along its last dim in
    lax.top_k's order: descending, +0 above -0, ties to the lower index."""
    return torch.sort(order_keys(x), dim=-1, descending=True, stable=True).indices[..., :k]


def rerank_scratch_bytes(B: int, K: int, k: int) -> int:
    """K10's scratch: the keys u32[B, K], then, past RERANK_STAGE winners,
    their sort buffer u64[B, next_pow2(k)] at the next 8-byte boundary."""
    s = 1 << (k - 1).bit_length()
    return (4 * B * K + 7) // 8 * 8 + (8 * B * s if s > RERANK_STAGE else 0)


def dense_rerank(cand_emb, query_emb, base, weight: float, k: int, out_idx, out_scores) -> None:
    """K10: cand_emb f32/f16/bf16[B, K, H], query_emb f32[B, H], base f32[B, K]
    → out_idx i32[B, k], out_scores f32[B, k] (ops/dense_rerank.py allocates)."""
    B, K, H = cand_emb.shape
    if cand_emb.dtype not in _RERANK_DTYPES:
        raise ValueError(f"the rerank reads f32, f16 or bf16 rows, not {cand_emb.dtype}")
    if not (1 <= B <= GRID_YZ and 1 <= K < 2 ** 31 and H >= 1 and 1 <= k <= K):
        raise ValueError(f"the rerank's grid takes 1..{GRID_YZ} queries of 1..2^31 - 1 "
                         f"candidates and keeps 1..K, not B = {B}, K = {K}, k = {k}")
    f32 = torch.float32
    ptrs = (_ptr(cand_emb, cand_emb.dtype), _RERANK_DTYPES[cand_emb.dtype],
            _ptr(query_emb, f32, (B, H)), _ptr(base, f32, (B, K)))
    outs = (_ptr(out_idx, torch.int32, (B, k)), _ptr(out_scores, f32, (B, k)))
    lib = _load("scoring")
    with on_card(cand_emb, query_emb, base, out_idx, out_scores) as stream:
        dev = cand_emb.device
        scratch = torch.empty(rerank_scratch_bytes(B, K, k), dtype=torch.uint8, device=dev)
        tickets = _RERANK_TICKETS.get((dev.index, stream))
        if tickets is None or tickets.numel() < B:
            tickets = _RERANK_TICKETS[(dev.index, stream)] = torch.zeros(
                max(B, 64), dtype=torch.int32, device=dev)
        rc = lib.stract_dense_rerank(*ptrs, B, K, H, float(weight), k, scratch.data_ptr(),
                                     tickets.data_ptr(), *outs, stream)
    _check(rc, "stract_dense_rerank")
    counted("dense_rerank")


# limits of the mesh merge in csrc/scoring.cu: gathered entries per query,
# kept, lists a table names one by one
MESH_MAX_N = 8192
MESH_MAX_K = 1024
MESH_MAX_LISTS = 64


class MeshLists(ctypes.Structure):
    """K9's table: list j of query b at scores[t] + (j - t) x K + b x qstride,
    t = min(j, ntab - 1) (elements)."""

    _fields_ = [("scores", ctypes.c_void_p * MESH_MAX_LISTS),
                ("docs", ctypes.c_void_p * MESH_MAX_LISTS), ("qstride", ctypes.c_longlong),
                ("ntab", ctypes.c_int)]


# K9's calls since the last reset_launches() by how they named the lists:
# "stacked" ([B, n, K] tensors), "lists" (each shard's [B, K] where it lies)
MESH_TOPK_CALLS = {"stacked": 0, "lists": 0}


def _mesh_dims(B: int, n: int, K: int, k: int) -> None:
    if not (1 <= B <= 65535 and n * K <= MESH_MAX_N and 1 <= k <= min(K, MESH_MAX_K)):
        raise ValueError(f"the mesh merge takes 1..65535 queries of n*K <= {MESH_MAX_N} entries "
                         f"and keeps 1..min(K, {MESH_MAX_K}), not {(B, n, K)} and {k}")


def _mesh_launch(table: MeshLists, ins: list, B: int, n: int, K: int, k: int, out_docs,
                 out_shards, out_scores, forms, how: str) -> None:
    i32 = torch.int32
    outs = (_ptr(out_docs, i32, (B, k)), _ptr(out_shards, i32, (B, k)),
            _ptr(out_scores, torch.float32, (B, k)), _ptr(forms, i32, (B,)))
    lib = _load("scoring")
    with on_card(*ins, out_docs, out_shards, out_scores, forms) as stream:
        rc = lib.stract_mesh_topk(ctypes.byref(table), B, n, K, k, *outs, stream)
    _check(rc, "stract_mesh_topk")
    counted("mesh_topk")
    with _count_lock:
        MESH_TOPK_CALLS[how] += 1


def mesh_topk(scores, docs, k: int, out_docs, out_shards, out_scores, forms=None) -> None:
    """K9: scores f32[B, n, K], docs i32[B, n, K] → out_docs, out_shards
    i32[B, k], out_scores f32[B, k], lax.top_k over each query's n*K entries
    (ops/scoring.py allocates); forms i32[B] (None: not written) 0 where a
    query's lists were all descending (the merge), 1 where not (the
    select)."""
    B, n, K = scores.shape
    _mesh_dims(B, n, K, k)
    table = MeshLists(qstride=n * K, ntab=1)
    table.scores[0] = _ptr(scores, torch.float32, (B, n, K))
    table.docs[0] = _ptr(docs, torch.int32, (B, n, K))
    _mesh_launch(table, [scores, docs], B, n, K, k, out_docs, out_shards, out_scores, forms,
                 "stacked")


def mesh_topk_lists(scores: list, docs: list, k: int, out_docs, out_shards, out_scores,
                    forms=None) -> None:
    """K9 over n <= MESH_MAX_LISTS lists read where they lie: scores[i]
    f32[B, K] and docs[i] i32[B, K], shard i's, all on one card; the outputs
    as mesh_topk's."""
    n = len(scores)
    if not 1 <= n <= MESH_MAX_LISTS or len(docs) != n:
        raise ValueError(f"the mesh merge names 1..{MESH_MAX_LISTS} lists of scores and as many "
                         f"of docs, not {n} and {len(docs)}")
    B, K = scores[0].shape
    _mesh_dims(B, n, K, k)
    table = MeshLists(qstride=K, ntab=n)
    for i, (s, d) in enumerate(zip(scores, docs)):
        table.scores[i] = _ptr(s, torch.float32, (B, K))
        table.docs[i] = _ptr(d, torch.int32, (B, K))
    _mesh_launch(table, [*scores, *docs], B, n, K, k, out_docs, out_shards, out_scores, forms,
                 "lists")


class ForestPlan(NamedTuple):
    """K4's launch: `rows` rows a block (FOREST_THREADS threads walking its
    (row, tree) pairs), the forest in chunks of `trees` trees, staged in
    shared memory when `staged`, else read where it lies (a tree too large
    for a block's shared memory, or rows too wide)."""

    rows: int
    trees: int
    staged: bool


def _forest_smem(T: int, N: int, L: int, F: int, rows: int) -> int:
    """csrc/forest.cu's shared memory for a chunk of T trees: 16-byte nodes,
    the leaves, the tile's features at a stride of F + 1 floats (F even) and
    its leaf values."""
    stride = F + 1 if F % 2 == 0 else F
    return 16 * T * N + 4 * T * L + 4 * rows * stride + 4 * T * rows


def _forest_tile(K: int, blocks: int) -> int:
    """8 rows a block, doubled, up to 64, while the blocks outnumber
    `blocks`."""
    rows = 8
    while rows < 64 and -(-K // rows) > blocks:
        rows *= 2
    return rows


def forest_plan(T: int, N: int, L: int, F: int, K: int) -> ForestPlan:
    """K4's tile and chunks. A forest that fits a block's shared memory
    beside a tile of 8 rows (K = 256 over 32 SMs, K = 4,096 in 512 blocks),
    doubled, up to 64, while the blocks outnumber FOREST_BLOCKS (K = 16,384:
    32 rows, 512 blocks, one wave), is one chunk. A larger forest is walked
    in chunks, the tile doubled while the blocks outnumber the card's SMs
    (every block stages the whole forest), a chunk as many trees as the
    first budget of FOREST_CHUNK_SMEM holds beside the tile that holds
    FOREST_CHUNK_TREES (500 trees of 31 leaves: 53 trees in a quarter of
    the shared memory, 3 blocks an SM; 1,000 of 255: 19 in half), else the
    largest budget's; a forest whose single tree, or whose one row, does not
    fit takes the global form, chunks of leaf values alone in shared memory.
    The readings it rests on are in PERF.md §6. ValueError only for a
    malformed forest (no trees, nodes, leaves or features, or K < 0), never
    for a large one."""
    if min(T, N, L, F) < 1 or K < 0:
        raise ValueError(f"a forest takes trees, nodes, leaves and features, not {T}, {N}, {L}, "
                         f"{F} over {K} rows")
    rows = _forest_tile(K, FOREST_BLOCKS)
    if _forest_smem(T, N, L, F, rows) <= MAX_SMEM:
        return ForestPlan(rows, T, True)
    rows = _forest_tile(K, FOREST_SMS)
    plan = None
    for budget in FOREST_CHUNK_SMEM:
        r = rows
        while r > 1 and _forest_smem(1, N, L, F, r) > budget:
            r //= 2
        first = _forest_smem(1, N, L, F, r)
        if first > budget:
            continue
        per_tree = _forest_smem(2, N, L, F, r) - first
        plan = ForestPlan(r, min(T, 1 + (budget - first) // per_tree), True)
        if plan.trees >= min(T, FOREST_CHUNK_TREES):
            return plan
    return plan or ForestPlan(rows, min(T, MAX_SMEM // 2 // (4 * rows)), False)


def forest(feature, threshold, left, right, leaf_value, x, out, max_depth: int) -> None:
    """K4 over x f32[K, F] into out f32[K] (ops/forest.py allocates), in
    forest_plan's tiles and chunks, a forest of any size."""
    T, N = feature.shape
    L = leaf_value.shape[1]
    K, F = x.shape
    i32, f32 = torch.int32, torch.float32
    plan = forest_plan(T, N, L, F, K)
    lib = _load("forest")
    with on_card(feature, threshold, left, right, leaf_value, x, out) as stream:
        rc = lib.stract_forest(
            _ptr(feature, i32, (T, N)), _ptr(threshold, f32, (T, N)), _ptr(left, i32, (T, N)),
            _ptr(right, i32, (T, N)), _ptr(leaf_value, f32, (T, L)), _ptr(x, f32, (K, F)),
            _ptr(out, f32, (K,)), T, N, L, K, F, int(max_depth), plan.rows, plan.trees,
            int(plan.staged), stream)
    _check(rc, "stract_forest")
    counted("forest")


def _attention_ptrs(tensors, shape, align: int = 4) -> list:
    B, T, H, D = shape
    if D not in ATTN_HEAD_DIMS or T < 1 or B > GRID_YZ or H > GRID_YZ:
        raise ValueError(f"attention takes head dims {ATTN_HEAD_DIMS}, at least one token and "
                         f"up to {GRID_YZ} batch rows and heads, not q of shape {tuple(shape)}")
    ptrs = [_ptr(t, torch.bfloat16, (B, T, H, D)) for t in tensors]
    if any(p % align for p in ptrs):
        raise ValueError(f"attention reads its rows in {align}-byte pieces: pointers must be "
                         f"{align}-byte aligned")
    return ptrs


def attention(q, k, v, mask, out) -> None:
    """K5a: q, k, v bf16[B, T, H, D] (16-byte aligned; D in ATTN_HEAD_DIMS,
    any T), mask i32[B, T] → out bf16[B, T, H*D]
    (ops/encoder.py allocates)."""
    B, T, H, D = q.shape
    ptrs = _attention_ptrs((q, k, v), q.shape, align=16)  # 16-byte cp.async copies
    bf16 = torch.bfloat16
    lib = _load("encoder")
    with on_card(q, k, v, mask, out) as stream:
        rc = lib.stract_attention(*ptrs, _ptr(mask, torch.int32, (B, T)),
                                  _ptr(out, bf16, (B, T, H * D)), B, T, H, D, stream)
    _check(rc, "stract_attention")
    counted("attention")


def attention_backward(q, k, v, mask, dout, dq, dk, dv, stats=None) -> None:
    """K14a: q, k, v bf16[B, T, H, D], mask i32[B, T], dout bf16[B, T, H*D]
    (all 16-byte aligned; D and T as K5a's) → dq, dk, dv bf16[B, T, H, D] (ops/encoder.py
    allocates); stats f32[B, H, T, 3] is the scratch of each query row's
    max, sum and D that the dQ kernel writes and the dK / dV kernel reads
    (allocated here when None)."""
    B, T, H, D = q.shape
    _ptr(dout, torch.bfloat16, (B, T, H * D))
    ptrs = _attention_ptrs((q, k, v, dout.view(B, T, H, D), dq, dk, dv), q.shape, align=16)
    if stats is None:
        stats = torch.empty((B, H, T, 3), dtype=torch.float32, device=q.device)
    st = _ptr(stats, torch.float32, (B, H, T, 3))
    lib = _load("encoder")
    with on_card(q, k, v, mask, dout, dq, dk, dv, stats) as stream:
        rc = lib.stract_attention_backward(*ptrs[:3], _ptr(mask, torch.int32, (B, T)), *ptrs[3:],
                                           st, B, T, H, D, stream)
    _check(rc, "stract_attention_backward")
    counted("attention_backward")


def bias_gelu(y, b, out, c1: float, c2: float) -> None:
    """K5c: y bf16[M, N], b bf16[N] → out bf16[M, N], the tanh GELU of
    bf16(y + b) at the constants c1, c2 (ops/encoder.py allocates). N must
    be a multiple of 8 and every pointer 16-byte aligned (16-byte loads)."""
    M, N = y.shape
    bf16 = torch.bfloat16
    ptrs = (_ptr(y, bf16, (M, N)), _ptr(b, bf16, (N,)), _ptr(out, bf16, (M, N)))
    if N % 8 or any(p % 16 for p in ptrs):
        raise ValueError(f"bias + GELU reads rows of 8-column groups by 16 bytes: N must be a "
                         f"multiple of 8 (not {N}) and pointers 16-byte aligned")
    lib = _load("encoder")
    with on_card(y, b, out) as stream:
        rc = lib.stract_bias_gelu(*ptrs, M, N, c1, c2, stream)
    _check(rc, "stract_bias_gelu")
    counted("bias_gelu")


def ln_width(N: int, what: str = "LayerNorm") -> None:
    """Raise ValueError unless K5b and K14b take rows of N columns."""
    if not 1 <= N <= LN_MAX_N:
        raise ValueError(f"the {what} takes rows of 1..{LN_MAX_N} columns, not {N}")


def add_layernorm(x, r, weight, bias, out, eps: float) -> None:
    """K5b: x, r bf16[M, N], weight, bias f32[N] → out bf16[M, N], LN(bf16(x
    + r)) in f32 (ops/encoder.py allocates); N in 1..LN_MAX_N, any M (0
    launches nothing). 8-byte pieces where N % 4 == 0 and the pointers allow,
    else single elements: the kernel picks."""
    M, N = x.shape
    ln_width(N)
    bf16, f32 = torch.bfloat16, torch.float32
    ptrs = ([_ptr(t, bf16, (M, N)) for t in (x, r)]
            + [_ptr(t, f32, (N,)) for t in (weight, bias)] + [_ptr(out, bf16, (M, N))])
    if M == 0:
        return
    lib = _load("encoder")
    with on_card(x, r, weight, bias, out) as stream:
        rc = lib.stract_add_layernorm(*ptrs, M, N, float(eps), stream)
    _check(rc, "stract_add_layernorm")
    counted("add_layernorm")


def add_layernorm_backward(x, r, dy, weight, eps: float) -> tuple:
    """K14b: x, r, dy bf16[..., N] (contiguous), weight f32[N] → (ds bf16 of
    x's shape, the cotangent of both x and r; dweight, dbias f32[N]); N in
    1..LN_MAX_N, any number of rows. dweight, dbias and the partials f32[2,
    blocks, N] of the fixed grid (LN_BWD_BLOCKS blocks of LN_BWD_WARPS rows
    at most) share one allocation."""
    N = x.shape[-1]
    ln_width(N, "LayerNorm backward")
    bf16, f32 = torch.bfloat16, torch.float32
    ptrs = [_ptr(t, bf16, x.shape) for t in (x, r, dy)] + [_ptr(weight, f32, (N,))]
    M = x.numel() // N
    blocks = min(LN_BWD_BLOCKS, -(-M // LN_BWD_WARPS))
    ds = torch.empty_like(x)
    out = torch.empty((2 + 2 * blocks) * N, dtype=f32, device=x.device)
    base = out.data_ptr()
    lib = _load("encoder")
    with on_card(x, r, dy, weight, ds, out) as stream:
        rc = lib.stract_add_layernorm_backward(*ptrs, ds.data_ptr(), base, base + 4 * N,
                                               base + 8 * N, M, N, blocks, float(eps), stream)
    _check(rc, "stract_add_layernorm_backward")
    counted("add_layernorm_backward")
    return ds, out[:N], out[N:2 * N]


def gelu_backward_blocks(M: int, N: int) -> int:
    """K14c's row blocks: GELU_BWD_BLOCKS blocks in all over the column
    blocks, at least one, at most one for each GELU_BWD_ROWS rows."""
    cols = -(-N // GELU_BWD_COLS)
    return max(1, min(-(-M // GELU_BWD_ROWS), GELU_BWD_BLOCKS // cols))


def bias_gelu_backward(y, b, dout, c1: float, c2: float) -> tuple:
    """K14c: y, dout bf16[M, N] (contiguous, any N, any alignment: 16-byte
    pieces where N % 8 == 0 and the pointers allow, else single elements,
    on the same grid),
    b bf16[N] → (dy bf16[M, N], db bf16[N]), the VJP of the tanh GELU of
    bf16(y + b) at the constants c1, c2; M >= 1 (ops/encoder.py gives db its
    zeros when M = 0). The fixed grid's partials f32[blocks, N] are one
    allocation; the column sum runs in the same call."""
    M, N = y.shape
    bf16 = torch.bfloat16
    ptrs = (_ptr(y, bf16, (M, N)), _ptr(b, bf16, (N,)), _ptr(dout, bf16, (M, N)))
    if M < 1:
        raise ValueError("the bias + GELU backward takes at least one row")
    blocks = gelu_backward_blocks(M, N)
    dy = torch.empty_like(y)
    db = torch.empty(N, dtype=bf16, device=y.device)
    partials = torch.empty((blocks, N), dtype=torch.float32, device=y.device)
    lib = _load("encoder")
    with on_card(y, b, dout, dy, db, partials) as stream:
        rc = lib.stract_bias_gelu_backward(*ptrs, dy.data_ptr(), db.data_ptr(),
                                           partials.data_ptr(), M, N, blocks, c1, c2, stream)
    _check(rc, "stract_bias_gelu_backward")
    counted("bias_gelu_backward")
    return dy, db


def _pool_dims(B: int, T: int, H: int, h_or_dh) -> None:
    if not 1 <= -(-T // POOL_SPAN) <= GRID_YZ or not 8 <= H <= POOL_MAX_H or H % 8:
        raise ValueError(f"the mean pool takes 1..{GRID_YZ * POOL_SPAN} tokens and widths that are "
                         f"multiples of 8 up to {POOL_MAX_H}, not T = {T}, H = {H}")
    if _ptr(h_or_dh, torch.bfloat16, (B, T, H)) % 16:
        raise ValueError("the mean pool moves rows in 16-byte pieces: the hidden states "
                         "must be 16-byte aligned")


def mean_pool(h, mask, out, raw, normalize: bool) -> None:
    """K5d's forward: h bf16[B, T, H] (16-byte aligned; T in 1..GRID_YZ x POOL_SPAN,
    H a multiple of 8 up to POOL_MAX_H), mask i32[B, T] → out f32[B, H], the
    masked mean, L2-normalised when `normalize`, and then raw f32[B, H] the
    mean before it (ops/encoder.py allocates; raw is out when not
    normalised). B = 0 launches nothing."""
    B, T, H = h.shape
    _pool_dims(B, T, H, h)
    f32 = torch.float32
    ptrs = (h.data_ptr(), _ptr(mask, torch.int32, (B, T)), _ptr(out, f32, (B, H)),
            _ptr(raw, f32, (B, H)))
    if B == 0:
        return
    lib = _load("encoder")
    with on_card(h, mask, out, raw) as stream:
        rc = lib.stract_mean_pool(*ptrs, B, T, H, int(normalize), stream)
    _check(rc, "stract_mean_pool")
    counted("mean_pool")


def mean_pool_backward(mask, raw, g, dh, normalize: bool) -> None:
    """K5d's backward: mask i32[B, T], raw f32[B, H] (the forward's mean
    before normalisation), g f32[B, H] (the cotangent of its output) → dh
    bf16[B, T, H] (16-byte aligned; ops/encoder.py allocates), T and H as
    the forward's. B = 0 launches nothing."""
    B, T, H = dh.shape
    _pool_dims(B, T, H, dh)
    f32 = torch.float32
    ptrs = (_ptr(mask, torch.int32, (B, T)), _ptr(raw, f32, (B, H)), _ptr(g, f32, (B, H)),
            dh.data_ptr())
    if B == 0:
        return
    lib = _load("encoder")
    with on_card(mask, raw, g, dh) as stream:
        rc = lib.stract_mean_pool_backward(*ptrs, B, T, H, int(normalize), stream)
    _check(rc, "stract_mean_pool_backward")
    counted("mean_pool")


def _stage_dims(qkv) -> tuple:
    B, T, H3 = qkv.shape
    H = H3 // 3
    if not (H3 == 3 * H and H >= 1 and T >= 1 and B <= GRID_YZ):
        raise ValueError(f"the stage attention takes qkv [B, T, 3H] with T, H >= 1 and up to "
                         f"{GRID_YZ} batch rows, not {tuple(qkv.shape)}")
    return B, T, H


def stage_attention(qkv, out) -> None:
    """K16a: qkv f32[B, T, 3H] → out f32[B, T, H] (ops/stage.py allocates)."""
    B, T, H = _stage_dims(qkv)
    f32 = torch.float32
    ptrs = (_ptr(qkv, f32, (B, T, 3 * H)), _ptr(out, f32, (B, T, H)))
    lib = _load("stage")
    with on_card(qkv, out) as stream:
        rc = lib.stract_stage_attention(*ptrs, B, T, H, stream)
    _check(rc, "stract_stage_attention")
    counted("stage_attention")


def stage_attention_backward(qkv, dout, probs, dscores, dqkv) -> None:
    """K16b: qkv f32[B, T, 3H], dout f32[B, T, H] → dqkv f32[B, T, 3H];
    probs and dscores f32[B, T, T] are scratch (ops/stage.py allocates all)."""
    B, T, H = _stage_dims(qkv)
    f32 = torch.float32
    ptrs = (_ptr(qkv, f32, (B, T, 3 * H)), _ptr(dout, f32, (B, T, H)),
            _ptr(probs, f32, (B, T, T)), _ptr(dscores, f32, (B, T, T)),
            _ptr(dqkv, f32, (B, T, 3 * H)))
    lib = _load("stage")
    with on_card(qkv, dout, probs, dscores, dqkv) as stream:
        rc = lib.stract_stage_attention_backward(*ptrs, B, T, H, stream)
    _check(rc, "stract_stage_attention_backward")
    counted("stage_attention_backward")


def gelu_tanh(x, y) -> None:
    """K16c: x f32 (contiguous, any shape and view) → y f32 of x's shape,
    the tanh GELU (ops/stage.py allocates); no elements launch nothing."""
    f32 = torch.float32
    ptrs = (_ptr(x, f32), _ptr(y, f32, x.shape))
    n = x.numel()
    if n == 0:
        return
    lib = _load("stage")
    with on_card(x, y) as stream:
        rc = lib.stract_gelu_tanh(*ptrs, n, stream)
    _check(rc, "stract_gelu_tanh")
    counted("gelu_tanh")


def gelu_tanh_backward(x, dout, dx) -> None:
    """K16c's backward: x, dout f32 (contiguous, one shape) → dx f32, the
    VJP of the tanh GELU (ops/stage.py allocates); no elements launch
    nothing."""
    f32 = torch.float32
    ptrs = (_ptr(x, f32), _ptr(dout, f32, x.shape), _ptr(dx, f32, x.shape))
    n = x.numel()
    if n == 0:
        return
    lib = _load("stage")
    with on_card(x, dout, dx) as stream:
        rc = lib.stract_gelu_tanh_backward(*ptrs, n, stream)
    _check(rc, "stract_gelu_tanh_backward")
    counted("gelu_tanh")


def sgd_multi(params: list, grads: list, lr: float) -> None:
    """K16d: p -= lr * g in place for every pair, f32 tensors of one card
    (each g of its p's size): one launch per SGD_MAX_TENSORS pairs
    (ops/stage.py groups by card)."""
    f32 = torch.float32
    ps, gs = [_ptr(p, f32) for p in params], [_ptr(g, f32) for g in grads]
    ns = [p.numel() for p in params]
    if ns != [g.numel() for g in grads]:
        raise ValueError("SGD takes a gradient of each parameter's size for each parameter")
    live = [i for i, n in enumerate(ns) if n]
    if not live:
        return
    lib = _load("stage")
    for c in range(0, len(live), SGD_MAX_TENSORS):
        idx = live[c:c + SGD_MAX_TENSORS]
        k = len(idx)
        first = [0]
        for i in idx:
            first.append(first[-1] - (-ns[i] // SGD_TILE))
        args = SgdArgs(count=k, lr=lr)
        args.p[:k], args.g[:k] = [ps[i] for i in idx], [gs[i] for i in idx]
        args.n[:k], args.first_block[:k + 1] = [ns[i] for i in idx], first
        with on_card(*(params[i] for i in idx), *(grads[i] for i in idx)) as stream:
            rc = lib.stract_sgd_multi(ctypes.byref(args), first[-1], stream)
        _check(rc, "stract_sgd_multi")
        counted("sgd")


# limits of csrc/moe.cu: experts per router; the router backward's fixed grid
# (at most MOE_BWD_BLOCKS blocks, at least MOE_BWD_TOKENS tokens a block)
MOE_MAX_E = 16
MOE_BWD_BLOCKS, MOE_BWD_TOKENS = 264, 16


def _router_dims(x, w) -> tuple:
    N, H = x.shape
    E = w.shape[0]
    if not (N >= 1 and H >= 1 and 1 <= E <= MOE_MAX_E):
        raise ValueError(f"the router takes 1..{MOE_MAX_E} experts over [N, H] tokens, not "
                         f"{E} experts over {tuple(x.shape)}")
    return N, H, E


def moe_router(x, w, bias, probs, top, gate) -> None:
    """K15a: x bf16[N, H], w f32[E, H], bias f32[E] → probs f32[N, E], top
    i32[N], gate bf16[N] (ops/moe.py allocates)."""
    N, H, E = _router_dims(x, w)
    f32 = torch.float32
    ins = (_ptr(x, torch.bfloat16, (N, H)), _ptr(w, f32, (E, H)), _ptr(bias, f32, (E,)))
    outs = (_ptr(probs, f32, (N, E)), _ptr(top, torch.int32, (N,)),
            _ptr(gate, torch.bfloat16, (N,)))
    lib = _load("moe")
    with on_card(x, w, bias, probs, top, gate) as stream:
        rc = lib.stract_moe_router(*ins, N, H, E, *outs, stream)
    _check(rc, "stract_moe_router")
    counted("moe_router")


def moe_router_backward(x, probs, top, dgate, w) -> tuple:
    """K15a backward, the router's whole VJP: x bf16[N, H], probs f32[N, E],
    top i32[N], dgate bf16[N] (the gate's cotangent), w f32[E, H] → (dx
    bf16[N, H], dw f32[E, H], db f32[E]). One call, counted once: the
    backward kernel over a fixed grid of at most MOE_BWD_BLOCKS blocks and
    the column sum of its partials f32[blocks, E*H + E]; dw, db and the
    partials share one allocation. Two calls give the same bits."""
    N, H, E = _router_dims(x, w)
    f32 = torch.float32
    ins = (_ptr(x, torch.bfloat16, (N, H)), _ptr(probs, f32, (N, E)),
           _ptr(top, torch.int32, (N,)), _ptr(dgate, torch.bfloat16, (N,)), _ptr(w, f32, (E, H)))
    blocks = min(MOE_BWD_BLOCKS, -(-N // MOE_BWD_TOKENS))
    cols = E * H + E
    dx = torch.empty_like(x)
    out = torch.empty((blocks + 1) * cols, dtype=f32, device=x.device)
    lib = _load("moe")
    with on_card(x, probs, top, dgate, w, dx, out) as stream:
        rc = lib.stract_moe_router_backward(*ins, N, H, E, blocks, dx.data_ptr(),
                                            out.data_ptr(), stream)
    _check(rc, "stract_moe_router_backward")
    counted("moe_router")
    return dx, out[:E * H].view(E, H), out[E * H:cols]


def _select_dims(out_e, top, gate, g=None) -> tuple:
    """Check K15b's arguments (ValueError before any build or launch) → (E,
    N, H, their pointers)."""
    if out_e.dim() != 3:
        raise ValueError(f"select-and-scale takes the experts' rows [E, N, H], not "
                         f"{tuple(out_e.shape)}")
    E, N, H = out_e.shape
    bf16 = torch.bfloat16
    ptrs = [_ptr(out_e, bf16), _ptr(top, torch.int32, (N,)), _ptr(gate, bf16, (N,))]
    if g is not None:
        ptrs.append(_ptr(g, bf16, (N, H)))
    if E < 1 or H < 1:
        raise ValueError(f"select-and-scale takes E, H >= 1, not {tuple(out_e.shape)}")
    return E, N, H, ptrs


def moe_select(out_e, top, gate) -> torch.Tensor:
    """K15b: out_e bf16[E, N, H], top i32[N] (each in 0..E-1), gate bf16[N] →
    bf16[N, H], bf16(out_e[top[n], n] * gate[n]). N = 0 launches nothing."""
    E, N, H, ptrs = _select_dims(out_e, top, gate)
    out = torch.empty((N, H), dtype=torch.bfloat16, device=out_e.device)
    if N == 0:
        return out
    lib = _load("moe")
    with on_card(out_e, top, gate, out) as stream:
        rc = lib.stract_moe_select(*ptrs, N, H, out.data_ptr(), stream)
    _check(rc, "stract_moe_select")
    counted("moe_select")
    return out


def moe_select_backward(out_e, top, gate, g) -> tuple:
    """K15b backward: out_e bf16[E, N, H], top i32[N], gate bf16[N], g
    bf16[N, H] (the output's cotangent) → (d_out bf16[E, N, H], bf16(g *
    gate) in row top[n] and zeros in the others; d_gate bf16[N], the f32 row
    sum of out_e[top[n], n] * g rounded once), one allocation. N = 0
    launches nothing."""
    E, N, H, ptrs = _select_dims(out_e, top, gate, g)
    buf = torch.empty(E * N * H + N, dtype=torch.bfloat16, device=out_e.device)
    d_out, d_gate = buf[:E * N * H].view(E, N, H), buf[E * N * H:]
    if N == 0:
        return d_out, d_gate
    lib = _load("moe")
    with on_card(out_e, top, gate, g, buf) as stream:
        rc = lib.stract_moe_select_backward(*ptrs, E, N, H, buf.data_ptr(),
                                            buf.data_ptr() + 2 * E * N * H, stream)
    _check(rc, "stract_moe_select_backward")
    counted("moe_select")
    return d_out, d_gate


def info_nce(logits, loss, d, blocks: int | None = None) -> None:
    """K15c's InfoNCE head: logits f32[B, B] → loss f32[], d f32[B, B]
    (ops/losses.py allocates). blocks: 1, one block (up to 12,288 rows), or
    ceil(B / INFO_NCE_GRID_ROWS), the grid and its ordered second pass over
    a scratch of the rows' terms allocated here; by default one block up to
    INFO_NCE_ONE_BLOCK rows. Both give the same bits."""
    B = logits.shape[0]
    grid = -(-B // INFO_NCE_GRID_ROWS)
    if blocks is None:
        blocks = 1 if B <= INFO_NCE_ONE_BLOCK else grid
    if blocks not in (1, grid) or (blocks == 1 and B > 12288):
        raise ValueError(f"the InfoNCE head takes 1 or {grid} blocks at B = {B} (one block up "
                         f"to 12288 rows), not {blocks}")
    f32 = torch.float32
    ptrs = (_ptr(logits, f32, (B, B)), _ptr(loss, f32, ()), _ptr(d, f32, (B, B)))
    terms = torch.empty(B, dtype=f32, device=logits.device) if blocks > 1 else None
    lib = _load("losses")
    with on_card(logits, loss, d, terms) as stream:
        rc = lib.stract_info_nce(*ptrs, _ptr(terms, f32, (B,)), B, blocks, stream)
    _check(rc, "stract_info_nce")
    counted("info_nce")


def pair_loss(s_pos, s_neg, t_pos, t_neg, alpha: float, loss, d_pos, d_neg) -> None:
    """K15c's pair head: s_pos, s_neg f32[B] and, distilled, the targets
    t_pos, t_neg f32[B] (None: the plain pairwise head) → loss f32[], d_pos,
    d_neg f32[B] (ops/losses.py allocates)."""
    B = s_pos.shape[0]
    f32 = torch.float32
    distill = t_pos is not None
    ins = [_ptr(t, f32, (B,)) for t in (s_pos, s_neg, t_pos, t_neg)]
    outs = (_ptr(loss, f32, ()), _ptr(d_pos, f32, (B,)), _ptr(d_neg, f32, (B,)))
    if distill != (t_neg is not None):
        raise ValueError("the distilled pair head takes both targets")
    lib = _load("losses")
    with on_card(s_pos, s_neg, t_pos, t_neg, loss, d_pos, d_neg) as stream:
        rc = lib.stract_pair_loss(*ins, *outs, B, float(alpha), int(distill), stream)
    _check(rc, "stract_pair_loss")
    counted("pair_loss")


# limits of csrc/graph.cu: registers per row (a power of two up to 65,536;
# past 1,024 a block a row)
HLL_MAX_M = 65536


def _csr_ptrs(n: int, offsets, sources, long_rows) -> tuple:
    i32 = torch.int32
    if sources.shape[0] >= 2 ** 31:
        raise ValueError("the graph kernels index edges with int32")
    return (_ptr(offsets, i32, (n + 1,)), _ptr(sources, i32), _ptr(long_rows, i32),
            int(long_rows.shape[0]))


def _hll_rows(m: int, *regs) -> None:
    """Raise for what no graph kernel takes: a row width that is not a power
    of two, one past HLL_MAX_M registers, or a register tensor that does not
    start on a whole piece (min(m, 16) bytes)."""
    if m < 1 or m & (m - 1):
        raise ValueError(f"HLL rows of {m} registers: not a power of two")
    if m > HLL_MAX_M:
        raise ValueError(f"HLL rows of {m} registers: past the kernels' {HLL_MAX_M:,}")
    for t in regs:
        if t is not None and t.data_ptr() % min(m, 16):
            raise ValueError(f"HLL registers of {m} a row must start on a {min(m, 16)}-byte "
                             f"boundary")


def _change_bytes(flags, flags_out, n: int) -> tuple:
    """Pointers of the change bytes u8[n] read and written (None: null);
    the two must be other tensors."""
    if flags is not None and flags_out is not None and flags.data_ptr() == flags_out.data_ptr():
        raise ValueError("the change bytes written must be another tensor than those read")
    return _ptr(flags, torch.uint8, (n,)), _ptr(flags_out, torch.uint8, (n,))


def hll_merge(regs, offsets, sources, long_rows, long_cut: int, alpha: float, out, sizes,
              changed, flags=None, flags_out=None) -> None:
    """K6a (+K6b): regs u8[N, m] over the reverse CSR (offsets i32[N + 1],
    sources i32[E]; long_rows i32[L], the rows with more than long_cut
    in-edges) → out u8[N, m] (another tensor), sizes f32[N] (or None),
    changed i32[1]. flags u8[N]: the rows that changed in the round before,
    the only in-neighbours gathered (None: every row); flags_out u8[N] (or
    None): this round's change bytes (ops/hll_ops.py allocates)."""
    n, m = regs.shape
    _hll_rows(m, regs, out)
    if out.data_ptr() == regs.data_ptr():
        raise ValueError("K6a writes its rows into another tensor than the registers it reads")
    off, src, lr, n_long = _csr_ptrs(n, offsets, sources, long_rows)
    fl, fl_out = _change_bytes(flags, flags_out, n)
    u8 = torch.uint8
    lib = _load("graph")
    with on_card(regs, flags, offsets, sources, out, flags_out, sizes, changed) as stream:
        rc = lib.stract_hll_merge(_ptr(regs, u8, (n, m)), fl, off, src, lr, n_long, n, m,
                                  long_cut, alpha, _ptr(out, u8, (n, m)), fl_out,
                                  _ptr(sizes, torch.float32, (n,)),
                                  _ptr(changed, torch.int32, (1,)), stream)
    _check(rc, "stract_hll_merge")
    counted("hll_merge")


def hll_estimate(regs, alpha: float, sizes) -> None:
    """K6b: regs u8[N, m] → sizes f32[N]."""
    n, m = regs.shape
    _hll_rows(m, regs)
    lib = _load("graph")
    with on_card(regs, sizes) as stream:
        rc = lib.stract_hll_estimate(_ptr(regs, torch.uint8, (n, m)), n, m, alpha,
                                     _ptr(sizes, torch.float32, (n,)), stream)
    _check(rc, "stract_hll_estimate")
    counted("hll_estimate")


def bfs_step(frontier, seen, dist, offsets, sources, long_rows, long_cut: int, level: int,
             next_frontier, changed) -> None:
    """K7, round `level` of the BFS over the reverse CSR: frontier, seen
    i32[N, W] (32 sources' bits a word; seen's bits past the sources set),
    dist i32[N, 32 W] → seen and dist updated in place, next_frontier
    i32[N, W] (another tensor than frontier), changed i32[1]
    (webgraph/shortest_path.py allocates). Counted as "bfs_relax"."""
    n, W = frontier.shape
    if W < 1 or tuple(dist.shape) != (n, 32 * W):
        raise ValueError(f"the BFS step takes bits i32[N, W], W >= 1, and distances "
                         f"i32[N, 32 W], not {tuple(frontier.shape)} and {tuple(dist.shape)}")
    if next_frontier.data_ptr() == frontier.data_ptr():
        raise ValueError("the next frontier must be another tensor than the frontier")
    if not 0 <= level < 2 ** 31 - 2:
        raise ValueError(f"round {level} out of range")
    off, src, lr, n_long = _csr_ptrs(n, offsets, sources, long_rows)
    i32 = torch.int32
    lib = _load("graph")
    with on_card(frontier, seen, dist, offsets, sources, long_rows, next_frontier,
                 changed) as stream:
        rc = lib.stract_bfs_step(_ptr(frontier, i32, (n, W)), off, src, lr, n_long, n, W,
                                 long_cut, level, _ptr(seen, i32, (n, W)),
                                 _ptr(dist, i32, (n, 32 * W)), _ptr(next_frontier, i32, (n, W)),
                                 _ptr(changed, i32, (1,)), stream)
    _check(rc, "stract_bfs_step")
    counted("bfs_relax")


def hll_ring_step(out, buf, offsets, sources, long_rows, long_cut: int, alpha: float,
                  start=None, sizes=None, changed=None, flags=None, flags_out=None) -> None:
    """K8, one ring step of one shard: out u8[S, m] (in place) ∪= buf u8[S, m]
    over the bucket's reverse CSR (offsets i32[S + 1], sources i32[E] rows of
    buf, long_rows i32[L]), gathering only the rows of buf whose change byte
    in flags u8[S] is set (None: every row); at the round's last step start
    u8[S, m] (the round-start shard) with changed i32[1], and sizes f32[S]
    and flags_out u8[S] (the rows' change bytes) or None."""
    S, m = out.shape
    _hll_rows(m, out, buf, start)
    if buf.data_ptr() == out.data_ptr():
        raise ValueError("the ring buffer must be another tensor than the rows it updates")
    if (start is None) != (changed is None) or (
            (sizes is not None or flags_out is not None) and start is None):
        raise ValueError("the last step takes start with changed (and sizes, flags_out); "
                         "the others none")
    off, src, lr, n_long = _csr_ptrs(S, offsets, sources, long_rows)
    fl, fl_out = _change_bytes(flags, flags_out, S)
    u8 = torch.uint8
    lib = _load("graph")
    with on_card(out, buf, flags, offsets, sources, start, flags_out, sizes, changed) as stream:
        rc = lib.stract_hll_ring_step(_ptr(out, u8, (S, m)), _ptr(buf, u8, (S, m)), fl, off, src,
                                      lr, n_long, S, m, long_cut, alpha, _ptr(start, u8, (S, m)),
                                      fl_out, _ptr(sizes, torch.float32, (S,)),
                                      _ptr(changed, torch.int32, (1,)), stream)
    _check(rc, "stract_hll_ring_step")
    counted("hll_ring_step")
