"""ctypes bindings for the native host runtime (native/stract_native.cpp).

Builds lazily with make on first use (g++ is in the image; pybind11 is not, so
plain ctypes). Every entry point has a pure-Python fallback with identical
semantics — the native path is an accelerator, not a behavior change, and
`tokenize_hashes` returns None for the rare texts the native tokenizer rejects
(codepoints whose lowercase expands, e.g. ß)."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_DIR, "stract_native.so")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        if not os.path.exists(_LIB_PATH):
            try:
                subprocess.run(
                    ["make", "-s"], cwd=_DIR, check=True, capture_output=True, timeout=300
                )
            except (subprocess.SubprocessError, OSError):
                _build_failed = True
                return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _build_failed = True
            return None
        if not hasattr(lib, "slot_factors"):  # stale .so predating the symbol
            try:
                subprocess.run(["make", "-s", "-B"], cwd=_DIR, check=True,
                               capture_output=True, timeout=300)
                lib = ctypes.CDLL(_LIB_PATH)
            except (subprocess.SubprocessError, OSError):
                _build_failed = True
                return None
            if not hasattr(lib, "slot_factors"):
                _build_failed = True
                return None
        lib.tokenize_hashes.restype = ctypes.c_int64
        lib.tokenize_hashes.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64,
        ]
        lib.combine_field.restype = None
        lib.combine_field.argtypes = [
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.slot_factors.restype = None
        lib.slot_factors.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def tokenize_hashes(text: str, ngrams: bool = False):
    """→ (uni u64[N], bi u64[max(N-1,0)] | None, tri | None) token hashes of the
    default tokenizer, or None if native is unavailable / text needs fallback."""
    lib = _load()
    if lib is None:
        return None
    data = text.encode("utf-8")
    max_toks = len(data) // 1 + 8
    uni = np.empty(max_toks, dtype=np.uint64)
    if ngrams:
        bi = np.empty(max_toks, dtype=np.uint64)
        tri = np.empty(max_toks, dtype=np.uint64)
        bi_p = bi.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
        tri_p = tri.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
    else:
        bi = tri = None
        bi_p = tri_p = None
    n = lib.tokenize_hashes(
        data, len(data),
        uni.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), max_toks,
        bi_p, max_toks if ngrams else 0,
        tri_p, max_toks if ngrams else 0,
    )
    if n < 0:
        return None
    uni = uni[:n]
    if not ngrams:
        return uni, None, None
    return uni, bi[: max(n - 1, 0)], tri[: max(n - 2, 0)]


def combine_field(hashes: np.ndarray, field_id: int) -> np.ndarray:
    """term_hash(field, token) for a hash stream (utils/hashing semantics)."""
    lib = _load()
    hashes = np.ascontiguousarray(hashes, dtype=np.uint64)
    out = np.empty(len(hashes), dtype=np.uint64)
    if lib is None or len(hashes) == 0:
        from .utils.hashing import combine_u64s, splitmix64

        seed = splitmix64(field_id)
        for i, h in enumerate(hashes):
            out[i] = combine_u64s(seed, int(h))
        return out
    lib.combine_field(
        hashes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(hashes),
        ctypes.c_uint64(field_id),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return out


def slot_factors(postings: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                 cand: np.ndarray, out: np.ndarray) -> bool:
    """Stage-B factor matrix: out[p, k] = packed factor of cand[k] in slot p's
    doc-ordered posting range (0 when absent). postings is the [n, 3] i32
    device-posting matrix (mmap ok). Sorts candidates once so each slot's
    lookups walk its range monotonically (gallop + narrowed binary search).
    → False when the native library is unavailable (caller falls back)."""
    lib = _load()
    if lib is None:
        return False
    assert postings.dtype == np.int32 and postings.ndim == 2 and postings.shape[1] == 3
    K = len(cand)
    order = np.argsort(cand, kind="stable")
    cand_sorted = np.ascontiguousarray(cand[order], dtype=np.int32)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int64)
    P = len(starts)
    tmp = np.empty((P, K), dtype=np.int32)
    lib.slot_factors(
        postings.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        P,
        cand_sorted.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        K,
        tmp.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    out[:P, order] = tmp
    return True
