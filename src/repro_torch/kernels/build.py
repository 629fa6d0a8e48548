"""Build-at-first-use for the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` file exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into its own shared library, loaded with
``ctypes``.  The library is keyed by a hash of its source, lives in
``kernels/_build/`` (listed in ``.gitignore``), and is built only from the
files in this package — a fresh checkout builds it on the first call.
Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# One build of a source at a time in a process (different sources still
# build together): the parallel dist_ooc workers may ask for a library on
# several threads at once, and two builds of one source would write the
# same temporary file.
_SOURCE_LOCKS: dict = {}
_SOURCE_LOCKS_LOCK = threading.Lock()


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
            "CUDA kernels are built on a machine with the CUDA toolkit")
    return path


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    digest = hashlib.sha256((CSRC / source).read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


@functools.lru_cache(maxsize=None)
def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` unless its library is already built, and
    load it.  The compiler's register/spill report (``-Xptxas -v``) is kept
    beside the library as ``<name>.log``."""
    so = library_path(source)
    with _SOURCE_LOCKS_LOCK:
        lock = _SOURCE_LOCKS.setdefault(source, threading.Lock())
    with lock:
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / source)],
                capture_output=True, text=True, check=False)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {source}:\n{proc.stderr}")
            so.with_suffix(".log").write_text(proc.stderr)
            os.replace(tmp, so)
    return ctypes.CDLL(str(so))
