"""ctypes bindings for the port's native data-loader core
(``csrc/fastloader.cpp``): the JAX package's ``data/native.py``, held to
the port's numpy path byte for byte.

The shared library is host C++ with a plain C ABI (no CUDA, no PyTorch
headers), built on first use with ``g++`` into ``cache_root("torch",
"native")``, the port's own subdirectory, under a file name keyed on the
source, the flags and the CPU's ISA (``-march=native``), written through a
temporary file and ``os.replace``: concurrent test workers or ranks never
load a half-written library.  The first build runs under the
``native.build`` lock (``analysis/lockwatch.make_lock``).
``$TPU_MNIST_TORCH_NATIVE_LIB`` names a prebuilt library instead; a library
without the port's ABI symbol (a JAX ``libfastloader``, whose C signatures
match with other semantics) is refused.

What it computes, against numpy's ``normalize`` and fancy indexing:

- :func:`gather_normalize`: uint8 ``[N, H, W]`` rows at ``indices`` ->
  float32 ``[B, H, W]``, each element ``float(x) * scale`` rounded, then
  ``+ shift`` rounded, with ``data/transforms.py``'s f32 ``scale`` and
  ``shift``: equal to ``normalize(images[indices])[..., 0]`` bit for bit
  (the JAX package's core derives them in f32 and lets the compiler fuse
  an FMA, which moves the last bit);
- :func:`gather_labels`: uint8 labels -> int64, the port's label dtype;
- :func:`parse_idx_native`: the IDX header checks of ``data/mnist.py``'s
  ``parse_idx`` (its errors raise ``ValueError``).

Indices keep numpy's semantics: negatives wrap, anything out of range
raises ``IndexError``, checked before any narrowing.  A non-uint8 or
non-contiguous input returns None, and numpy takes it.

No hidden fallback: numpy takes over only where no ``g++`` is on ``PATH``,
no library is cached and no override is set, which is announced once on
stderr and read through :func:`status`.  Where a compiler is present and the build or the load
fails, the error is raised, with the compiler's stderr (the JAX package
swallows it).  :data:`CALLS` counts the native calls by function.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import shutil
import subprocess
import sys
import threading

import numpy as np

from ..analysis.lockwatch import make_lock
from ..utils.cache_dir import cache_root
from .transforms import SCALE, SHIFT

_SRC = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "fastloader.cpp"
_LIB_ENV = "TPU_MNIST_TORCH_NATIVE_LIB"
# -ffp-contract=off: no FMA contraction of x * scale + shift (numpy rounds
# the product and the sum apart).  Never -ffast-math.
_CFLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17"]
ABI_VERSION = 1
NUMPY_NOTICE = ("native data loader: no g++ on PATH and no "
                f"${_LIB_ENV}; batches are assembled with numpy")

CALLS = {"gather_normalize": 0, "gather_labels": 0, "parse_idx": 0}
_calls_lock = threading.Lock()
_build_lock = make_lock("native.build")
_lib = None
_status = {"state": "unresolved", "path": None}


def _cpu_tag() -> str:
    """Discriminator for the -march=native binary: arch + ISA feature set,
    so a cache shared across heterogeneous hosts never serves a binary
    with unsupported instructions (SIGILL)."""
    feats = b""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith((b"flags", b"Features")):
                    feats = b" ".join(sorted(line.split(b":", 1)[1].split()))
                    break
    except OSError:
        pass
    return platform.machine() + "-" + hashlib.sha256(feats).hexdigest()[:8]


def _build_lib() -> str | None:
    """The cached library's path, built with ``g++`` if absent; None if it
    is absent and no ``g++`` is on ``PATH``.  A failed build raises with
    the compiler's stderr."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_CFLAGS).encode()).hexdigest()
    cache_dir = cache_root("torch", "native")
    out = os.path.join(cache_dir, f"libtmnist_fastloader-{digest[:16]}-{_cpu_tag()}.so")
    if os.path.exists(out):
        return out
    compiler = shutil.which("g++")
    if compiler is None:
        return None
    os.makedirs(cache_dir, exist_ok=True)
    tmp = f"{out}.build{os.getpid()}"
    cmd = [compiler, *_CFLAGS, "-o", tmp, str(_SRC), "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed building {_SRC.name} (exit {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load(path: str):
    lib = ctypes.CDLL(path)
    try:
        abi = lib.tmnist_fastloader_abi
    except AttributeError:
        raise RuntimeError(f"{path} is not the port's native data loader (no "
                           "tmnist_fastloader_abi symbol)") from None
    abi.restype = ctypes.c_int
    if abi() != ABI_VERSION:
        raise RuntimeError(f"{path} has ABI {abi()}, this module wants {ABI_VERSION}")
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.tmnist_gather_normalize.argtypes = [ptr, ptr, i64, i64, ctypes.c_float,
                                            ctypes.c_float, ptr]
    lib.tmnist_gather_normalize.restype = None
    lib.tmnist_gather_labels.argtypes = [ptr, ptr, i64, ptr]
    lib.tmnist_gather_labels.restype = None
    lib.tmnist_idx_parse_header.argtypes = [ptr, i64, ptr]
    lib.tmnist_idx_parse_header.restype = ctypes.c_int
    return lib


def get_lib():
    """The loaded library, built at first use; None where it is not cached,
    no ``g++`` is on ``PATH`` and no override is set (announced once on
    stderr).  A failed build or load raises, every call."""
    global _lib
    if _status["state"] in ("loaded", "numpy"):
        return _lib
    with _build_lock:
        if _status["state"] in ("loaded", "numpy"):
            return _lib
        path = os.environ.get(_LIB_ENV)
        if not path:
            path = _build_lib()
            if path is None:
                _status.update(state="numpy", path=None)
                print(NUMPY_NOTICE, file=sys.stderr)
                return None
        elif not os.path.exists(path):
            raise FileNotFoundError(f"${_LIB_ENV} names {path}, which does not exist")
        _lib = _load(path)
        _status.update(state="loaded", path=path)
    return _lib


def status() -> dict:
    """``{"state": "loaded" | "numpy" | "unresolved", "path": ...}``: the
    library in use, numpy where no compiler was found, or nothing tried
    yet."""
    return dict(_status)


def _count(name: str) -> None:
    with _calls_lock:
        CALLS[name] += 1


def _checked_indices(indices: np.ndarray, n: int) -> np.ndarray:
    """Validate gather indices with numpy's semantics before handing them
    to the native kernels (which, like any C gather, do no bounds checks):
    negatives wrap from the end, anything out of range raises IndexError."""
    # Bounds-check in the ORIGINAL dtype: narrowing int64 -> int32 first
    # would wrap out-of-range values into range and gather the wrong row.
    orig = np.asarray(indices)
    if orig.size:
        lo, hi = int(orig.min()), int(orig.max())
        if lo < -n or hi >= n:
            bad = lo if lo < -n else hi
            raise IndexError(f"index {bad} is out of bounds for axis 0 with size {n}")
    idx = np.ascontiguousarray(orig, dtype=np.int32)
    if orig.size and lo < 0:
        idx = np.where(idx < 0, idx + n, idx).astype(np.int32)
    return idx


def _usable(a: np.ndarray) -> bool:
    return a.dtype == np.uint8 and a.flags["C_CONTIGUOUS"]


def gather_normalize(images: np.ndarray, indices: np.ndarray) -> np.ndarray | None:
    """uint8 ``[N, H, W]`` rows ``indices`` -> float32 ``[B, H, W]``,
    ``normalize``'s values bit for bit; None without the library or for
    images that are not one contiguous uint8 buffer."""
    if not _usable(images) or images.ndim != 3:
        return None
    lib = get_lib()
    if lib is None:
        return None
    idx = _checked_indices(indices, len(images))
    b, h, w = len(idx), images.shape[1], images.shape[2]
    out = np.empty((b, h, w), np.float32)
    lib.tmnist_gather_normalize(images.ctypes.data, idx.ctypes.data, b, h * w,
                                float(SCALE), float(SHIFT), out.ctypes.data)
    _count("gather_normalize")
    return out


def gather_labels(labels: np.ndarray, indices: np.ndarray) -> np.ndarray | None:
    """uint8 labels at ``indices`` -> int64; None without the library or
    for labels that are not one contiguous uint8 buffer."""
    if not _usable(labels):
        return None
    lib = get_lib()
    if lib is None:
        return None
    idx = _checked_indices(indices, len(labels))
    out = np.empty(len(idx), np.int64)
    lib.tmnist_gather_labels(labels.ctypes.data, idx.ctypes.data, len(idx), out.ctypes.data)
    _count("gather_labels")
    return out


def parse_idx_native(raw: bytes) -> np.ndarray | None:
    """Native IDX parse (a copy of the payload); None without the library.
    A bad magic, bad dimensions or a truncated payload raise
    ``ValueError``."""
    lib = get_lib()
    if lib is None:
        return None
    buf = np.frombuffer(raw, dtype=np.uint8)
    dims = np.zeros(4, np.int64)
    rc = lib.tmnist_idx_parse_header(buf.ctypes.data, len(buf), dims.ctypes.data)
    if rc != 0:
        raise ValueError(f"not an MNIST IDX buffer (native parser rc={rc})")
    _count("parse_idx")
    n, rows, cols, offset = (int(d) for d in dims)
    if rows:  # images
        return buf[offset: offset + n * rows * cols].reshape(n, rows, cols).copy()
    return buf[offset: offset + n].copy()
