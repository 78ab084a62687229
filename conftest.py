"""Set-up shared by every pytest process of a run.

The native host library (native/stract_native.so, with its generated
tables.h) is built here once, before any test module is collected. Both
packages build it lazily at first use, without a lock; under pytest-xdist
every worker imports every test module while it collects, so several
processes would otherwise run `make` on the same files at once, and a
worker that loads a half-written library, or whose build trips over a
tables.h another process is writing, gives up on the library for the rest
of its run. The xdist controller runs pytest_configure before it starts the
workers, and each worker runs it again: the first process to take the lock
builds, the others find a whole library.
"""

from __future__ import annotations

import fcntl
import os
import subprocess

NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
LIBRARY = "stract_native.so"
LOCK = ".build.lock"
# a library built before this entry point existed is stale
REQUIRED_SYMBOL = b"slot_factors"


def build_native(native_dir: str = NATIVE_DIR) -> str:
    """Build `native_dir`'s library under an exclusive lock on a file beside
    it, unless it is there and exports REQUIRED_SYMBOL → the library's path.
    Raises if make fails."""
    lib = os.path.join(native_dir, LIBRARY)
    with open(os.path.join(native_dir, LOCK), "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            if not (os.path.exists(lib) and _exports_symbol(lib)):
                subprocess.run(["make", "-s", "-B"] if os.path.exists(lib) else ["make", "-s"],
                               cwd=native_dir, check=True, capture_output=True, timeout=300)
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    return lib


def _exports_symbol(lib: str) -> bool:
    # the symbol's name is in the library's string table; reading the bytes
    # does not map the library into this process
    with open(lib, "rb") as fh:
        return REQUIRED_SYMBOL in fh.read()


def pytest_configure(config):
    build_native()
