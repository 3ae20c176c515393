"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
alone (no PyTorch headers, so a build takes seconds) into a shared
library, loaded with ``ctypes``; ptxas's report (registers, shared
memory, spills per kernel) is kept beside it.  Every library comes from
a gated :class:`~..compile.aot.ExecutableStore`: the one a caller passes
(``--aot-cache``, with outcomes on its registry), else this process's
build directory, a store of its own at ``build/torch_kernels`` in the
checkout unless :func:`set_build_dir` moves it (``--compile-cache-dir``/
``--cache-dir``, ``utils/compile_cache.py``).  Either way a library is
reused only under the key of its source, flags, torch build, driver and
card, its bytes are checked before ``ctypes`` opens it, and a hit runs
no ``nvcc``.

A process loads each library once and keeps it: whichever call loads it
first decides which store it comes from, and every later call, with or
without a store, gets that library.  So the directory and the store must
be chosen before the first load; a second directory or store later in
the process loads no second copy.  ``LOADS`` counts the libraries
loaded, ``BUILDS`` the ``nvcc`` runs.

Nothing here runs at import time: CPU-only hosts import this module and
never call it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# sm_90a (not sm_90): Hopper-only instructions stay available to the
# sources.  No --use_fast_math: the kernels rely on IEEE division and
# rounding (csrc/int8_head.cu).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()  # guards _store, _locks, _loaded, _origins, LOADS and BUILDS
_store = None  # BUILD_DIR's store
_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}
# How each loaded library came: its store's outcome (hit, miss, fallback).
_origins: dict[str, str] = {}
# Libraries loaded into this process (each built first if it was not on
# disk): a pool's replica restart must load none.
LOADS = 0
# nvcc runs in this process: a warm start from the store must run none.
BUILDS = 0


def set_build_dir(path: str | os.PathLike) -> Path:
    """Build into and load from a store at ``path`` (created 0700 if
    missing) instead of ``build/torch_kernels``; only the libraries this
    process has not loaded yet come from it."""
    global BUILD_DIR
    BUILD_DIR = Path(path).resolve()
    return Path(build_store().directory)


def build_store():
    """The build directory's :class:`~..compile.aot.ExecutableStore` (no
    registry: it records no outcome), made at first use."""
    from ..compile.aot import ExecutableStore

    global _store
    with _lock:
        if _store is None or _store.directory != str(BUILD_DIR):
            _store = ExecutableStore(str(BUILD_DIR))
        return _store


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else under ``CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); the CUDA kernels "
        "of this package are built from source at first use"
    )


def sources() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_build(name: str, out: str | os.PathLike) -> str:
    """One ``nvcc`` run: compile ``csrc/<name>.cu`` into ``out``; returns
    nvcc's output (ptxas's report).  A failed build raises."""
    global BUILDS
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]
    with _lock:
        BUILDS += 1
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{proc.stdout}")
    return proc.stdout


def ptxas_report(name: str) -> str:
    """nvcc's output from the build of ``csrc/<name>.cu`` in the build
    directory's store (ptxas's per-kernel registers, shared memory and
    spills); empty if this environment has no entry for it."""
    store = build_store()
    entry = store.entry(name)
    log = Path(store.directory, entry["log"]) if entry else None
    return log.read_text() if log is not None and log.exists() else ""


def library(name: str, store=None) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``.  At its first load in the
    process it comes from ``store`` (an ``ExecutableStore``), or without
    one from the build directory's: a hit, or a build kept there.  Builds
    of different sources run concurrently (one lock per source), so
    threads calling this for every source build them in parallel."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        with _lock:
            lib = _loaded.get(name)
        if lib is not None:
            return lib
        lib, outcome = (store or build_store()).load_or_build(
            name, lambda out: nvcc_build(name, out), lambda path: ctypes.CDLL(path))
        global LOADS
        with _lock:
            _loaded[name] = lib
            _origins[name] = outcome
            LOADS += 1
        return lib


def origin(name: str) -> str | None:
    """Where this process's copy of library ``name`` came from: its
    store's outcome (``hit``, ``miss``, ``fallback``), or None while it is
    not loaded."""
    with _lock:
        return _origins.get(name)
