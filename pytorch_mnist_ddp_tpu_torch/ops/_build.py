"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
alone (no PyTorch headers, so a build takes seconds) into
``build/torch_kernels/<name>-<hash>.so`` at the root of the checkout,
loaded with ``ctypes``; ptxas's report (registers, shared memory, spills
per kernel) lands beside it in ``<name>-<hash>.log``.  The hash covers
the source and the flags, so an edited source rebuilds and an unchanged
one is reused.  A build writes a
private temporary file and renames it into place, so concurrent builds
never load a torn library.

Nothing here runs at import time: CPU-only hosts import this module and
never call it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
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

_lock = threading.Lock()  # guards _locks and _loaded
_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}


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


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.blake2b(src + " ".join(NVCC_FLAGS).encode(), digest_size=8)
    return BUILD_DIR / f"{name}-{digest.hexdigest()}.so"


def _compile(name: str, target: Path) -> None:
    """Compile ``csrc/<name>.cu`` into ``target``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f"{name}.", suffix=".so.tmp")
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        os.remove(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{proc.stdout}")
    target.with_suffix(".log").write_text(proc.stdout)
    os.replace(tmp, target)


def ptxas_report(name: str) -> str:
    """nvcc's output from the build of ``csrc/<name>.cu`` (ptxas's
    per-kernel registers, shared memory and spills); empty if the library
    was built before reports were kept."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed.  Builds
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
        target = _target(name)
        if not target.exists():
            _compile(name, target)
        lib = ctypes.CDLL(str(target))
        with _lock:
            _loaded[name] = lib
        return lib
