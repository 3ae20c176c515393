"""The int8 dense head (fc1 -> relu -> fc2) as one CUDA kernel launch.

``fused_int8_head`` launches ``csrc/int8_head.cu`` for CUDA tensors and
raises if it cannot; for CPU tensors it runs :func:`int8_head_reference`,
the plain PyTorch version of the same arithmetic.  There is no fallback
from the card to the plain version: the plain version is what the tests
and ``chip_smoke.py`` hold the kernel against, never what serves on the
card.

On the card the kernel splits fc1's inputs over a thread-block cluster
per 16 rows; :func:`launch_plan` picks the cluster size from how many
clusters of each size the card runs at once (:func:`active_clusters`).
It takes every shape the JAX kernel takes (JAX asks hidden % 128 == 0;
this wrapper hidden % 16 == 0): a K-slice wider than a block's registers
runs in several K-passes, fc1's hidden columns in tiles of 128, and where
the hidden activations would overflow rank 0's shared memory they go
through a scratch buffer in device memory.

Layer dicts are :func:`~..models.quant.quantize_params` entries:
``weight_q`` int8 ``[out, in]``, ``scale`` f32 ``[out]``, ``bias`` f32
``[out]``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

QMAX = 127.0

# Kernel launches made through fused_int8_head (one per launch); the
# plain CPU path does not count.
LAUNCHES = 0

# The kernel's launch geometry (csrc/int8_head.cu): a cluster of C blocks
# per tile of ROWS rows, each block one K-slice of whole 32-column chunks,
# taken in K-passes of at most MAX_PASS columns, fc1's columns in tiles of
# at most H_TILE.
ROWS = 16  # one mma M tile
CLUSTER_SIZES = (16, 8, 4, 2, 1)  # 16 is non-portable: one GPC
MAX_PASS = 1152  # x columns a block holds in registers (MAXC = 9 float4 a lane)
H_TILE = 128  # fc1 columns per step: a pair of n-tiles for each of 8 warps
SMEM_LIMIT = 232448  # 227 KB: the most dynamic shared memory a block may use
_HEADER = 1152  # a1 and a2 per row, every rank's row maxima


def _int8_dense_reference(x: torch.Tensor, layer: dict) -> torch.Tensor:
    """Per-row dynamically quantized int8 product, op for op
    ``models/quant.py:_int8_dense`` of the JAX package: divide (never a
    reciprocal multiply), round half to even, clamp, exact integer product,
    then ``acc * (a_scale * scale) + bias``."""
    a_max = x.abs().amax(dim=-1, keepdim=True)
    # Divide by a tensor, not a Python scalar: CUDA's tensor/scalar
    # division multiplies by the scalar's reciprocal, which is not the
    # IEEE quotient the reference takes.
    qmax = torch.full_like(a_max, QMAX)
    a_scale = torch.where(a_max > 0, a_max / qmax, torch.ones_like(a_max))
    x_q = torch.clamp(torch.round(x / a_scale), -QMAX, QMAX)
    w_q = layer["weight_q"]
    if x.device.type == "cpu":
        acc = (x_q.to(torch.int32) @ w_q.to(torch.int32).T).to(torch.float32)
    else:
        # No int32 matmul on CUDA in torch; float64 is exact here (every
        # partial sum is an integer below 2^53), and float64 -> float32
        # rounds the same integer to nearest as int32 -> float32 does.
        acc = (x_q.to(torch.float64) @ w_q.to(torch.float64).T).to(torch.float32)
    return acc * (a_scale * layer["scale"]) + layer["bias"]


def int8_head_reference(fc1: dict, fc2: dict, x: torch.Tensor) -> torch.Tensor:
    """Plain version: ``int8_dense(relu(int8_dense(x, fc1)), fc2)``,
    f32 ``[n, in]`` -> f32 ``[n, out2]`` pre-softmax logits."""
    h = torch.relu(_int8_dense_reference(x.to(torch.float32), fc1))
    return _int8_dense_reference(h, fc2)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device,
           aligned: bool = True) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if aligned and t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _slice(k: int, cluster: int) -> int:
    """Columns of the widest K-slice: 32-column chunks spread over the ranks."""
    chunks = -(-k // 32)
    return 32 * -(-chunks // cluster)


def _k_slices(k: int, cluster: int) -> list[tuple[int, int]]:
    """Columns ``[c0, c1)`` of each rank: whole 32-column chunks spread
    evenly, only the last slice ending inside a chunk; as the kernel
    computes them."""
    chunks = -(-k // 32)
    return [(32 * (r * chunks // cluster), min(k, 32 * ((r + 1) * chunks // cluster)))
            for r in range(cluster)]


def _passes(k: int, cluster: int) -> int:
    """K-passes per slice: as many as the widest slice needs."""
    return -(-_slice(k, cluster) // MAX_PASS)


def _pass_width(k: int, cluster: int) -> int:
    """Columns of a K-pass: the slice's chunks spread evenly over the passes."""
    return 32 * -(-(_slice(k, cluster) // 32) // _passes(k, cluster))


def _k_passes(k: int, cluster: int) -> list[list[tuple[int, int]]]:
    """Per rank, the columns ``[p0, p1)`` of each K-pass of its slice (the
    last passes of a short slice may be empty); as the kernel computes them."""
    width = _pass_width(k, cluster)
    return [[(min(c1, c0 + p * width), min(c1, c0 + (p + 1) * width))
             for p in range(_passes(k, cluster))] for c0, c1 in _k_slices(k, cluster)]


def _h_tiles(h: int) -> list[tuple[int, int]]:
    """fc1's columns ``[h0, h1)`` of each step's h-tile."""
    tile = min(h, H_TILE)
    return [(h0, min(h, h0 + tile)) for h0 in range(0, h, tile)]


def _smem_bytes(k: int, h: int, o: int, cluster: int, hid_smem: bool = True) -> int:
    """Dynamic shared memory of one block, the kernel's ``layout()``:
    header, one step's W1 tile and codes at a pitch of the pass width + 16
    bytes, the int32 partials sent and received, and (``hid_smem``) h, its
    codes and W2 on rank 0.  With one h-tile h overwrites the partials."""
    pitch = _pass_width(k, cluster) + 16
    tile = min(h, H_TILE)
    total = _HEADER + (tile + ROWS) * pitch + 2 * ROWS * tile * 4
    if hid_smem:
        if len(_h_tiles(h)) == 1:
            total -= ROWS * tile * 4
        # per row and hidden column: h in f32 and its int8 code; W2
        total += ROWS * h * (4 + 1) + o * h
    return -(-total // 16) * 16


def _hid_smem(k: int, h: int, o: int, cluster: int) -> bool:
    """Whether h, its codes and W2 fit in rank 0's shared memory (else they
    go through device memory)."""
    return _smem_bytes(k, h, o, cluster) <= SMEM_LIMIT


def _fits(k: int, h: int, o: int, cluster: int) -> bool:
    """Every rank has columns."""
    return cluster <= -(-k // 32)


def _launch_plan(n: int, k: int, h: int, o: int, max_clusters: dict[int, int]) -> dict:
    """Cluster size and grid for ``n`` rows.  ``max_clusters[C]`` is how many
    clusters of C blocks run at once on the card.  Each size costs waves x
    slice (a block's bytes scale with its slice); the cheapest wins, then
    fewer waves, then the larger cluster.  Raises ValueError where the card
    runs no cluster of any size that fits."""
    tiles = -(-n // ROWS)
    best = None
    for c in CLUSTER_SIZES:
        active = max_clusters.get(c, 0)
        if not _fits(k, h, o, c) or active < 1:
            continue
        waves = -(-tiles // active)
        key = (waves * _slice(k, c), waves, -c)
        if best is None or key < best[0]:
            hid_smem = _hid_smem(k, h, o, c)
            best = (key, {"cluster": c, "rows": ROWS, "grid": (c, tiles),
                          "smem": _smem_bytes(k, h, o, c, hid_smem), "slice": _slice(k, c),
                          "passes": _passes(k, c), "pass_width": _pass_width(k, c),
                          "h_tiles": len(_h_tiles(h)), "hid_smem": hid_smem,
                          "max_clusters": active, "waves": waves})
    if best is None:
        raise ValueError(f"int8_head: the card runs no cluster at in={k}, hidden={h}, "
                         f"out={o} ({max_clusters})")
    return best[1]


@functools.cache
def _library():
    lib = _build.library("int8_head")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.int8_head_launch.argtypes = [i, p, i, i, p, p, p, i, p, p, p, i, p, i, i, p, p, p]
    lib.int8_head_launch.restype = i
    lib.int8_head_max_clusters.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.int8_head_max_clusters.restype = i
    return lib


@functools.cache
def active_clusters(device: int, k: int, h: int, o: int) -> dict[int, int]:
    """Clusters of each size that fits the shape the card runs at once,
    from cudaOccupancyMaxActiveClusters; asked once per shape."""
    counts = {}
    for c in CLUSTER_SIZES:
        if not _fits(k, h, o, c):
            continue
        count = ctypes.c_int(0)
        rc = _library().int8_head_max_clusters(
            device, c, _smem_bytes(k, h, o, c, _hid_smem(k, h, o, c)), ctypes.byref(count))
        if rc != 0:
            raise RuntimeError(f"int8_head occupancy query failed at cluster {c}: CUDA error {rc}")
        counts[c] = count.value
    return counts


def launch_plan(n: int, k: int, h: int, o: int, device: int) -> dict:
    """The plan ``fused_int8_head`` launches with on ``cuda:device``."""
    return _launch_plan(n, k, h, o, active_clusters(device, k, h, o))


def fused_int8_head(fc1: dict, fc2: dict, x: torch.Tensor) -> torch.Tensor:
    """``relu(int8_dense(x, fc1))`` then ``int8_dense(., fc2)``: f32
    ``[n, in]`` -> f32 ``[n, out2]`` pre-softmax logits, in one kernel
    launch on the card (the plain version for CPU tensors)."""
    if x.device.type == "cpu":
        return int8_head_reference(fc1, fc2, x)
    if x.device.type != "cuda":
        raise ValueError(f"fused_int8_head runs on cuda or cpu, got {x.device}")
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"x must be [n >= 1, in], got {tuple(x.shape)}")
    n, k = x.shape
    h = fc1["weight_q"].shape[0]
    o = fc2["weight_q"].shape[0]
    if h % 16:  # JAX's kernel asks hidden % 128 == 0
        raise ValueError(f"need hidden % 16 == 0, got {h}")
    dev = x.device
    # x and W1 may sit at any offset: the kernel reads them element-wise then.
    _check("x", x, torch.float32, (n, k), dev, aligned=False)
    _check("fc1.weight_q", fc1["weight_q"], torch.int8, (h, k), dev, aligned=False)
    _check("fc2.weight_q", fc2["weight_q"], torch.int8, (o, h), dev)
    for layer, name, width in ((fc1, "fc1", h), (fc2, "fc2", o)):
        for leaf in ("scale", "bias"):
            _check(f"{name}.{leaf}", layer[leaf], torch.float32, (width,), dev)
    out = torch.empty((n, o), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        plan = launch_plan(n, k, h, o, dev.index)
        scratch = (None, None)
        if not plan["hid_smem"]:  # h and its codes, a row tile's rows at a time
            rows = plan["grid"][1] * ROWS
            scratch = (torch.empty((rows, h), dtype=torch.float32, device=dev),
                       torch.empty((rows, h), dtype=torch.int8, device=dev))
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _library().int8_head_launch(
            dev.index, x.data_ptr(), n, k,
            fc1["weight_q"].data_ptr(), fc1["scale"].data_ptr(),
            fc1["bias"].data_ptr(), h,
            fc2["weight_q"].data_ptr(), fc2["scale"].data_ptr(),
            fc2["bias"].data_ptr(), o,
            out.data_ptr(), plan["cluster"], plan["smem"],
            *(None if t is None else t.data_ptr() for t in scratch), stream,
        )
    if rc != 0:
        raise RuntimeError(f"int8_head kernel launch failed: CUDA error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out
