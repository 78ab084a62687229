"""Build and ctypes binding of the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled with nvcc for sm_90a at first use into its own
library under stract_tpu_torch/build/ (plain C interfaces, so each build
takes seconds; all sources build in parallel) and loaded with ctypes. A
library is rebuilt when its source is newer. Nothing here runs at import
time: the CPU tests import this module on machines without nvcc or a card.

  csrc/scoring.cu   K1 stage A (q16 or q8 rows, with or without block-max UB), K13
                    stage A through the P-way bitonic merge, K2 stage B, K3 pass-2
                    signals, K11 the device factor join (alone, and inside stage B
                    and pass 2), K12 pass 2 from the slots' L-row prefixes, K10 the
                    dense rerank
  csrc/forest.cu    K4 LambdaMART forest walk
  csrc/encoder.cu   K5a masked attention of the BERT encoder, K14a its backward
  csrc/graph.cu     K6a HyperBall register merge (+ K6b in its epilogue), K6b HLL
                    size estimate, K7 BFS relaxation
  csrc/moe.cu       K15a the MoE router (logits, softmax, argmax, gate) and its
                    backward

(K5b-d and K14b-c, the encoder's residual + LayerNorm, bias + GELU and mean
pool, forward and backward, are Triton kernels in ops/encoder.py; K14d and
K15d, the fused AdamW updates of f32 masters and of bf16 parameters, are in
optim.py; K15b-c, the MoE select-and-scale and the loss heads, in ops/moe.py
beside the CUDA router K15a (csrc/moe.cu); they count their launches here
too.)

Each launch function takes tensors already on the card, allocated by its
caller (ops/*.py), launches on PyTorch's current stream, raises on a
non-zero CUDA status, and adds one to its entry in LAUNCHES.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
# library name -> source file under csrc/
SOURCES = {"scoring": "scoring.cu", "forest": "forest.cu", "encoder": "encoder.cu",
           "graph": "graph.cu", "moe": "moe.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

# limits of csrc/scoring.cu (MAX_SORT, MAX_SIG_K): the largest top-C, Kd or
# page one block sorts in shared memory, and the most fused signal columns
MAX_SORT = 4096
MAX_SIG_K = 64
# limits of the search and rerank kernels (MAX_NSIG, MAX_H, the slot count whose
# factor chunk fits the block's shared memory)
MAX_NSIG = 64
MAX_H = 1024
MAX_SEARCH_P = 8192
# limits of csrc/encoder.cu: the head width and the longest sequence
ATTN_HEAD_DIM = 32
ATTN_MAX_T = 256
# a block's shared memory on the card (the forest is staged there whole)
MAX_SMEM = 227 * 1024

# launches per kernel since the last reset_launches(): the proof that a run of
# the main path went through the kernels
# (a stage-A launch counts once: under "stage_a_merge" through the merge
# network, else "stage_a_ub" when it folds UB bounds, else "stage_a_q8" on q8
# rows, else "stage_a"; "signals_joined" is pass 2 with the join inside,
# "signals_prefix" is K12; "moe_router" and "moe_select" count forward and
# backward launches alike)
LAUNCHES = {"stage_a": 0, "stage_a_q8": 0, "stage_a_ub": 0, "stage_a_merge": 0, "stage_b": 0,
            "signals_q16": 0, "factors_join": 0, "stage_b_joined": 0, "signals_joined": 0,
            "signals_prefix": 0, "dense_rerank": 0, "forest": 0, "attention": 0,
            "add_layernorm": 0, "bias_gelu": 0, "mean_pool": 0, "attention_backward": 0,
            "add_layernorm_backward": 0, "bias_gelu_backward": 0, "adamw": 0,
            "moe_router": 0, "moe_select": 0, "loss_heads": 0, "adamw_bf16": 0,
            "hll_merge": 0, "hll_estimate": 0, "bfs_relax": 0}

_lock = threading.Lock()
_count_lock = threading.Lock()  # the server launches from two worker threads
_libs: dict = {}


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def counted(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def on_device(x, dev, dtype=None):
    """A kernel argument of any origin (tensor, array, list) as a contiguous
    tensor on `dev` (None stays None)."""
    if x is None:
        return None
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
        for name, src in SOURCES.items():
            lib, src = _library(name), os.path.join(CSRC, src)
            if not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(src):
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
                lib.stract_stage_a.argtypes = [seg, qry, P, LL, I, P, P, I, I, I, I, I, F,
                                               P, P, P, P, P, P, P, P]
                lib.stract_stage_a_merge.argtypes = [seg, qry, P, LL, I, P, P, I, I, I, I, F,
                                                     P, P, P, P, P, P, P]
                lib.stract_stage_b.argtypes = [seg, qry, agg, P, P, I, I, F, I, I, P, P, P, P, P]
                lib.stract_signals_q16.argtypes = [seg, qry, agg, P, P, I, F, P, P, P]
                lib.stract_factors_join.argtypes = [P, LL, I, P, P, P, I, I, I, P, P]
                lib.stract_stage_b_joined.argtypes = [seg, qry, P, LL, I, P, I, I, F, I,
                                                      P, P, P, P]
                lib.stract_signals_search.argtypes = [seg, qry, agg, P, LL, I, P, I, I, I, F,
                                                      P, P, P, P]
                lib.stract_dense_rerank.argtypes = [P, I, P, P, I, I, I, F, I, P, P, P]
                fns = (lib.stract_stage_a, lib.stract_stage_a_merge, lib.stract_stage_b,
                       lib.stract_signals_q16,
                       lib.stract_factors_join, lib.stract_stage_b_joined,
                       lib.stract_signals_search, lib.stract_dense_rerank)
            elif name == "forest":
                lib.stract_forest.argtypes = [P, P, P, P, P, P, P, I, I, I, I, I, I, P]
                fns = (lib.stract_forest,)
            elif name == "graph":
                lib.stract_hll_merge.argtypes = [P, P, P, P, I, I, I, I, F, P, P, P, P]
                lib.stract_hll_estimate.argtypes = [P, I, I, F, P, P]
                lib.stract_bfs_relax.argtypes = [P, P, P, P, I, I, I, I, P, P, P]
                fns = (lib.stract_hll_merge, lib.stract_hll_estimate, lib.stract_bfs_relax)
            elif name == "moe":
                lib.stract_moe_router.argtypes = [P, P, P, I, I, I, P, P, P, P]
                lib.stract_moe_router_backward.argtypes = [P, P, P, P, I, I, I, P, P, P]
                fns = (lib.stract_moe_router, lib.stract_moe_router_backward)
            else:
                lib.stract_attention.argtypes = [P, P, P, P, P, I, I, I, P]
                lib.stract_attention_backward.argtypes = [P, P, P, P, P, P, P, P, I, I, I, P]
                fns = (lib.stract_attention, lib.stract_attention_backward)
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
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"kernel argument has shape {tuple(t.shape)}, expected {tuple(shape)}")
    return t.data_ptr()


def _check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def seg_args(seg) -> SegArgs:
    f32, db = torch.float32, seg.static_default.shape[0]
    return SegArgs(_ptr(seg.static_cols, f32, (_NUM_STATIC, db)), _ptr(seg.static_default, f32),
                   _ptr(seg.region_ids, torch.int32, (db,)), _ptr(seg.last_updated, f32, (db,)),
                   db, float(seg.static_scale), int(seg.num_docs))


_QUERY_SHAPES = {"starts": "BP", "lens": "BP", "group": "BP", "n_required": "B", "idf": "BP",
                 "w_bm25": "BP", "w_bm25f": "BP", "w_presence": "BP", "static_coeffs": "BS",
                 "region_lut": "BR", "coeff_region": "B", "coeff_update": "B",
                 "current_ts": "B", "soft_bonus": "B"}
_INT_QUERY_FIELDS = ("starts", "lens", "group", "n_required")
_NUM_STATIC, _NUM_REGIONS = 11, 16


def query_args(q) -> QueryArgs:
    B, P = q.starts.shape
    dims = {"B": B, "P": P, "S": _NUM_STATIC, "R": _NUM_REGIONS}
    ptrs = [_ptr(getattr(q, name),
                 torch.int32 if name in _INT_QUERY_FIELDS else torch.float32,
                 tuple(dims[c] for c in _QUERY_SHAPES[name]))
            for name, _ in QueryArgs._fields_[:14]]
    return QueryArgs(*ptrs, B, P)


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


def stage_a(seg, q, L: int, K: int, T: int, default_static: bool, soft_required: bool,
            inv_fs: float, tkey, tsum, tmask, taux, skey, out_docs, out_scores,
            ub_entry=None, ub_total=None) -> None:
    """K1 over q16 or q8 rows; ub_entry f32[B, P] with ub_total f32[B] turn
    block-max UB scoring on."""
    if not 1 <= K <= MAX_SORT:
        raise ValueError(f"stage A keeps 1..{MAX_SORT} candidates per query, not {K}")
    if (ub_entry is None) != (ub_total is None):
        raise ValueError("UB scoring takes ub_entry and ub_total together")
    B, P = q.starts.shape
    i32, f32 = torch.int32, torch.float32
    post, n_rows, w = _postings(seg)
    ub_e, ub_t = _ptr(ub_entry, f32, (B, P)), _ptr(ub_total, f32, (B,))
    lib = _load("scoring")
    s, qa = seg_args(seg), query_args(q)
    rc = lib.stract_stage_a(
        ctypes.byref(s), ctypes.byref(qa), post, n_rows, w, ub_e, ub_t, L, K, T,
        int(default_static), int(soft_required), inv_fs,
        _ptr(tkey, i32, (B, T)), _ptr(tsum, f32, (B, T)), _ptr(tmask, torch.int64, (B, T)),
        _ptr(taux, i32, (B, T)), _ptr(skey, i32, (B, T)), _ptr(out_docs, i32, (B, K)),
        _ptr(out_scores, f32, (B, K)), _stream())
    _check(rc, "stract_stage_a")
    counted("stage_a_ub" if ub_entry is not None else "stage_a_q8" if w == 2 else "stage_a")


def stage_a_merge(seg, q, L: int, K: int, default_static: bool, soft_required: bool,
                  inv_fs: float, mkey, mcon, maux, skey, out_docs, out_scores, ub_entry=None,
                  ub_total=None) -> None:
    """K13: stage A through the P-way bitonic merge of the [P, L] tiles.
    Network rows mkey i32[B, P*L], mcon f32[B, P*L], maux i32[B, P*L] (None
    when not default_static), skey i32[B, P*L] scratch; K = 0 runs the
    network alone (skey, the outputs and ub_total None)."""
    B, P = q.starts.shape
    N = P * L
    if not (P >= 2 and P & (P - 1) == 0 and L >= 1 and L & (L - 1) == 0 and N <= 1 << 24):
        raise ValueError(f"the merge takes [P, L] tiles of powers of two, P >= 2, not {P} x {L}")
    if not 0 <= K <= MAX_SORT:
        raise ValueError(f"stage A keeps 0..{MAX_SORT} candidates per query, not {K}")
    if K and (ub_entry is None) != (ub_total is None):
        raise ValueError("UB scoring takes ub_entry and ub_total together")
    if default_static and maux is None:
        raise ValueError("the default static score reads the aux words: maux is needed")
    i32, f32 = torch.int32, torch.float32
    post, n_rows, w = _postings(seg)
    net = (_ptr(mkey, i32, (B, N)), _ptr(mcon, f32, (B, N)), _ptr(maux, i32, (B, N)))
    outs = ((_ptr(skey, i32, (B, N)), _ptr(out_docs, i32, (B, K)), _ptr(out_scores, f32, (B, K)))
            if K else (None, None, None))
    ub_e, ub_t = _ptr(ub_entry, f32, (B, P)), _ptr(ub_total, f32, (B,))
    lib = _load("scoring")
    s, qa = seg_args(seg), query_args(q)
    rc = lib.stract_stage_a_merge(ctypes.byref(s), ctypes.byref(qa), post, n_rows, w, ub_e, ub_t,
                                  L, K, int(default_static), int(soft_required), inv_fs, *net,
                                  *outs, _stream())
    _check(rc, "stract_stage_a_merge")
    counted("stage_a_merge")


def stage_b(seg, q, aggs: AggArgs, factors, cand, default_static: bool, inv_fs: float,
            k: int, ks: int, out_docs, out_scores, out_sq, out_scale) -> None:
    if not 1 <= cand.shape[1] <= MAX_SORT or not 0 <= ks <= MAX_SIG_K:
        raise ValueError(f"stage B takes 1..{MAX_SORT} candidates and 0..{MAX_SIG_K} "
                         f"signal columns, not {cand.shape[1]} and {ks}")
    lib = _load("scoring")
    s, qa = seg_args(seg), query_args(q)
    (B, P), Kd = q.starts.shape, cand.shape[1]
    i32, f32 = torch.int32, torch.float32
    rc = lib.stract_stage_b(
        ctypes.byref(s), ctypes.byref(qa), ctypes.byref(aggs), _ptr(factors, i32, (B, P, Kd)),
        _ptr(cand, i32, (B, Kd)), Kd, int(default_static), inv_fs, k, ks,
        _ptr(out_docs, i32, (B, k)), _ptr(out_scores, f32, (B, k)),
        _ptr(out_sq, torch.int16, (B, aggs.nsig, ks)), _ptr(out_scale, f32, (B, aggs.nsig)),
        _stream())
    _check(rc, "stract_stage_b")
    counted("stage_b")


def signals_q16(seg, q, aggs: AggArgs, factors, cand, inv_fs: float, out_q, out_scale) -> None:
    if not 1 <= cand.shape[1] <= MAX_SORT:
        raise ValueError(f"pass 2 takes 1..{MAX_SORT} candidates per query, not {cand.shape[1]}")
    lib = _load("scoring")
    s, qa = seg_args(seg), query_args(q)
    (B, P), K = q.starts.shape, cand.shape[1]
    rc = lib.stract_signals_q16(
        ctypes.byref(s), ctypes.byref(qa), ctypes.byref(aggs),
        _ptr(factors, torch.int32, (B, P, K)), _ptr(cand, torch.int32, (B, K)), K, inv_fs,
        _ptr(out_q, torch.int16, (B, aggs.nsig, K)), _ptr(out_scale, torch.float32, (B, aggs.nsig)),
        _stream())
    _check(rc, "stract_signals_q16")
    counted("signals_q16")


def factors_join(seg, starts, lens, cand, out) -> None:
    """K11 alone: starts, lens i32[B, P], cand i32[B, Kd] → out i32[B, P, Kd],
    the packed factors of each candidate in each slot's full posting range
    (ops/scoring.py allocates)."""
    (B, P), Kd = starts.shape, cand.shape[1]
    if not (1 <= B <= 65535 and 1 <= P <= 65535 and Kd >= 1):
        raise ValueError(f"the join takes 1..65535 queries and slots, not {B} x {P} x {Kd}")
    i32 = torch.int32
    post, n_rows, w = _postings(seg)
    ptrs = (_ptr(starts, i32, (B, P)), _ptr(lens, i32, (B, P)), _ptr(cand, i32, (B, Kd)))
    o = _ptr(out, i32, (B, P, Kd))
    lib = _load("scoring")
    rc = lib.stract_factors_join(post, n_rows, w, *ptrs, B, P, Kd, o, _stream())
    _check(rc, "stract_factors_join")
    counted("factors_join")


def stage_b_joined(seg, q, cand, default_static: bool, inv_fs: float, k: int, skey,
                   out_docs, out_scores) -> None:
    """K2 with the join inside: cand i32[B, Kd] → out_docs i32[B, k],
    out_scores f32[B, k]; skey i32[B, S] is scratch, S the power of two >= Kd."""
    (B, _), Kd = q.starts.shape, cand.shape[1]
    if not 1 <= Kd <= MAX_SORT or not 1 <= k <= Kd or B > 65535:
        raise ValueError(f"stage B takes 1..{MAX_SORT} candidates and keeps 1..Kd, not "
                         f"{Kd} and {k}")
    S = 1 << (Kd - 1).bit_length()
    i32, f32 = torch.int32, torch.float32
    post, n_rows, w = _postings(seg)
    ptrs = (_ptr(skey, i32, (B, S)), _ptr(out_docs, i32, (B, k)), _ptr(out_scores, f32, (B, k)))
    c = _ptr(cand, i32, (B, Kd))
    lib = _load("scoring")
    s, qa = seg_args(seg), query_args(q)
    rc = lib.stract_stage_b_joined(ctypes.byref(s), ctypes.byref(qa), post, n_rows, w, c, Kd,
                                   int(default_static), inv_fs, k, *ptrs, _stream())
    _check(rc, "stract_stage_b_joined")
    counted("stage_b_joined")


def signals_search(seg, q, aggs: AggArgs, cand, inv_fs: float, L: int = 0, steps: int = 0,
                   out_f32=None, out_q=None, out_scale=None) -> None:
    """Pass 2 that finds its own factors: L = 0 joins each candidate over the
    slots' full ranges (K11 inside K3), L > 0 searches the first L rows of
    each slot in `steps` steps (K12). cand i32[B, K] → out_f32 f32[B, nsig, K],
    or out_q i16[B, nsig, K] with out_scale f32[B, nsig]."""
    (B, P), K = q.starts.shape, cand.shape[1]
    if (out_f32 is None) == (out_q is None) or (out_q is not None and out_scale is None):
        raise ValueError("pass 2 writes f32 rows, or q16 rows with their scales")
    if K < 1 or not 1 <= P <= MAX_SEARCH_P or not 1 <= aggs.nsig <= MAX_NSIG or L < 0 or \
            (L > 0 and steps < 1):
        raise ValueError(f"pass 2 takes 1..{MAX_SEARCH_P} slots, 1..{MAX_NSIG} signal rows and "
                         f"a prefix of L >= 0 rows, not {P}, {aggs.nsig}, {L}")
    f32 = torch.float32
    post, n_rows, w = _postings(seg)
    c = _ptr(cand, torch.int32, (B, K))
    outs = (_ptr(out_f32, f32, (B, aggs.nsig, K)), _ptr(out_q, torch.int16, (B, aggs.nsig, K)),
            _ptr(out_scale, f32, (B, aggs.nsig)))
    lib = _load("scoring")
    s, qa = seg_args(seg), query_args(q)
    rc = lib.stract_signals_search(ctypes.byref(s), ctypes.byref(qa), ctypes.byref(aggs), post,
                                   n_rows, w, c, K, L, steps, inv_fs, *outs, _stream())
    _check(rc, "stract_signals_search")
    counted("signals_prefix" if L > 0 else "signals_joined")


_RERANK_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


def dense_rerank(cand_emb, query_emb, base, weight: float, k: int, out_idx, out_scores) -> None:
    """K10: cand_emb f32/f16/bf16[B, K, H], query_emb f32[B, H], base f32[B, K]
    → out_idx i32[B, k], out_scores f32[B, k] (ops/dense_rerank.py allocates)."""
    B, K, H = cand_emb.shape
    if cand_emb.dtype not in _RERANK_DTYPES:
        raise ValueError(f"the rerank reads f32, f16 or bf16 rows, not {cand_emb.dtype}")
    if not (B >= 1 and 1 <= K <= MAX_SORT and 1 <= H <= MAX_H and 1 <= k <= K):
        raise ValueError(f"the rerank takes 1..{MAX_SORT} candidates of 1..{MAX_H} dims and "
                         f"keeps 1..K, not {K}, {H}, {k}")
    f32 = torch.float32
    ptrs = (_ptr(cand_emb, cand_emb.dtype), _RERANK_DTYPES[cand_emb.dtype],
            _ptr(query_emb, f32, (B, H)), _ptr(base, f32, (B, K)))
    outs = (_ptr(out_idx, torch.int32, (B, k)), _ptr(out_scores, f32, (B, k)))
    lib = _load("scoring")
    rc = lib.stract_dense_rerank(*ptrs, B, K, H, float(weight), k, *outs, _stream())
    _check(rc, "stract_dense_rerank")
    counted("dense_rerank")


def forest(feature, threshold, left, right, leaf_value, x, out, max_depth: int) -> None:
    """K4 over x f32[K, F] into out f32[K] (ops/forest.py allocates)."""
    T, N = feature.shape
    L = leaf_value.shape[1]
    K, F = x.shape
    i32, f32 = torch.int32, torch.float32
    if 16 * T * N + 4 * T * L > MAX_SMEM or min(T, N, L, F) < 1:
        raise ValueError(f"a forest of {T} trees x {N} nodes x {L} leaves over {F} features "
                         "does not fit one block's shared memory")
    lib = _load("forest")
    rc = lib.stract_forest(
        _ptr(feature, i32, (T, N)), _ptr(threshold, f32, (T, N)), _ptr(left, i32, (T, N)),
        _ptr(right, i32, (T, N)), _ptr(leaf_value, f32, (T, L)), _ptr(x, f32, (K, F)),
        _ptr(out, f32, (K,)), T, N, L, K, F, int(max_depth), _stream())
    _check(rc, "stract_forest")
    counted("forest")


def _attention_ptrs(tensors, shape) -> list:
    B, T, H, D = shape
    if D != ATTN_HEAD_DIM or not 1 <= T <= ATTN_MAX_T or B > 65535 or H > 65535:
        raise ValueError(f"attention takes head dim {ATTN_HEAD_DIM} and 1..{ATTN_MAX_T} "
                         f"tokens, not q of shape {tuple(shape)}")
    ptrs = [_ptr(t, torch.bfloat16, (B, T, H, D)) for t in tensors]
    if any(p % 4 for p in ptrs):
        raise ValueError("attention reads its rows as bf16 pairs: pointers must be 4-byte aligned")
    return ptrs


def attention(q, k, v, mask, out) -> None:
    """K5a: q, k, v bf16[B, T, H, 32], mask i32[B, T] → out bf16[B, T, H*32]
    (ops/encoder.py allocates)."""
    B, T, H, D = q.shape
    ptrs = _attention_ptrs((q, k, v), q.shape)
    bf16 = torch.bfloat16
    lib = _load("encoder")
    rc = lib.stract_attention(*ptrs, _ptr(mask, torch.int32, (B, T)),
                              _ptr(out, bf16, (B, T, H * D)), B, T, H, _stream())
    _check(rc, "stract_attention")
    counted("attention")


def attention_backward(q, k, v, mask, dout, dq, dk, dv) -> None:
    """K14a: q, k, v bf16[B, T, H, 32], mask i32[B, T], dout bf16[B, T, H*32]
    → dq, dk, dv bf16[B, T, H, 32] (ops/encoder.py allocates)."""
    B, T, H, D = q.shape
    _ptr(dout, torch.bfloat16, (B, T, H * D))
    ptrs = _attention_ptrs((q, k, v, dout.view(B, T, H, D), dq, dk, dv), q.shape)
    lib = _load("encoder")
    rc = lib.stract_attention_backward(*ptrs[:3], _ptr(mask, torch.int32, (B, T)), *ptrs[3:],
                                       B, T, H, _stream())
    _check(rc, "stract_attention_backward")
    counted("attention_backward")


# limit of csrc/moe.cu: experts per router
MOE_MAX_E = 16


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
    rc = lib.stract_moe_router(*ins, N, H, E, *outs, _stream())
    _check(rc, "stract_moe_router")
    counted("moe_router")


def moe_router_backward(probs, top, dgate, w, dlogits, dx) -> None:
    """K15a backward: probs f32[N, E], top i32[N], dgate bf16[N], w f32[E, H]
    → dlogits f32[N, E], dx bf16[N, H]."""
    N, H, E = _router_dims(dx, w)
    f32 = torch.float32
    ins = (_ptr(probs, f32, (N, E)), _ptr(top, torch.int32, (N,)),
           _ptr(dgate, torch.bfloat16, (N,)), _ptr(w, f32, (E, H)))
    outs = (_ptr(dlogits, f32, (N, E)), _ptr(dx, torch.bfloat16, (N, H)))
    lib = _load("moe")
    rc = lib.stract_moe_router_backward(*ins, N, H, E, *outs, _stream())
    _check(rc, "stract_moe_router_backward")
    counted("moe_router")


# limits of csrc/graph.cu: registers per row (a power of two, 4..1024)
HLL_MAX_M = 1024


def _csr_ptrs(n: int, offsets, sources, long_rows) -> tuple:
    i32 = torch.int32
    if sources.shape[0] >= 2 ** 31:
        raise ValueError("the graph kernels index edges with int32")
    return (_ptr(offsets, i32, (n + 1,)), _ptr(sources, i32), _ptr(long_rows, i32),
            int(long_rows.shape[0]))


def hll_merge(regs, offsets, sources, long_rows, long_cut: int, alpha: float, out, sizes,
              changed) -> None:
    """K6a (+K6b): regs u8[N, m] over the reverse CSR (offsets i32[N + 1],
    sources i32[E]; long_rows i32[L], the rows with more than long_cut
    in-edges) → out u8[N, m], sizes f32[N] (or None), changed i32[1]
    (ops/hll_ops.py allocates)."""
    n, m = regs.shape
    if not 4 <= m <= HLL_MAX_M or m & (m - 1):
        raise ValueError(f"HLL rows of {m} registers: the kernel takes a power of two, 4..1024")
    off, src, lr, n_long = _csr_ptrs(n, offsets, sources, long_rows)
    u8 = torch.uint8
    lib = _load("graph")
    rc = lib.stract_hll_merge(_ptr(regs, u8, (n, m)), off, src, lr, n_long, n, m, long_cut,
                              alpha, _ptr(out, u8, (n, m)), _ptr(sizes, torch.float32, (n,)),
                              _ptr(changed, torch.int32, (1,)), _stream())
    _check(rc, "stract_hll_merge")
    counted("hll_merge")


def hll_estimate(regs, alpha: float, sizes) -> None:
    """K6b: regs u8[N, m] → sizes f32[N]."""
    n, m = regs.shape
    if not 4 <= m <= HLL_MAX_M or m & (m - 1):
        raise ValueError(f"HLL rows of {m} registers: the kernel takes a power of two, 4..1024")
    lib = _load("graph")
    rc = lib.stract_hll_estimate(_ptr(regs, torch.uint8, (n, m)), n, m, alpha,
                                 _ptr(sizes, torch.float32, (n,)), _stream())
    _check(rc, "stract_hll_estimate")
    counted("hll_estimate")


def bfs_relax(dist, offsets, sources, long_rows, long_cut: int, out, changed) -> None:
    """K7: dist i32[N, S] (S = 1 or a multiple of 32) over the reverse CSR →
    out i32[N, S], changed i32[1] (webgraph/shortest_path.py allocates)."""
    n, S = dist.shape
    if S != 1 and S % 32:
        raise ValueError(f"the relaxation takes 1 or a multiple of 32 sources, not {S}")
    off, src, lr, n_long = _csr_ptrs(n, offsets, sources, long_rows)
    i32 = torch.int32
    lib = _load("graph")
    rc = lib.stract_bfs_relax(_ptr(dist, i32, (n, S)), off, src, lr, n_long, n, S, long_cut,
                              _ptr(out, i32, (n, S)), _ptr(changed, i32, (1,)), _stream())
    _check(rc, "stract_bfs_relax")
    counted("bfs_relax")
