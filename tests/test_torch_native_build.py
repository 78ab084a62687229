"""The root conftest.py builds the native host library once per test run,
under a lock: six processes calling its build function at once on a fresh
copy of native/'s sources must each end up loading a whole library that
exports slot_factors."""

from __future__ import annotations

import ctypes
import importlib.util
import multiprocessing as mp
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = ("Makefile", "gen_tables.py", "stract_native.cpp")


def _root_conftest():
    spec = importlib.util.spec_from_file_location("root_conftest",
                                                  os.path.join(ROOT, "conftest.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _build_and_load(native_dir: str, start, out) -> None:
    start.wait()
    try:
        lib = ctypes.CDLL(_root_conftest().build_native(native_dir))
        out.put(hasattr(lib, "slot_factors"))
    except Exception as e:  # reported to the parent, which fails the test
        out.put(repr(e))


def test_six_processes_build_the_native_library_once(tmp_path):
    native_dir = tmp_path / "native"
    native_dir.mkdir()
    for name in SOURCES:
        shutil.copy(os.path.join(ROOT, "native", name), native_dir / name)
    ctx = mp.get_context("spawn")
    start, out = ctx.Event(), ctx.Queue()
    procs = [ctx.Process(target=_build_and_load, args=(str(native_dir), start, out))
             for _ in range(6)]
    for p in procs:
        p.start()
    start.set()
    results = [out.get(timeout=300) for _ in procs]
    for p in procs:
        p.join(timeout=60)
    assert results == [True] * 6
    assert all(p.exitcode == 0 for p in procs)
    assert (native_dir / "stract_native.so").exists() and (native_dir / "tables.h").exists()
