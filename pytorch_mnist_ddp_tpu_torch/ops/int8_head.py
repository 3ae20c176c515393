"""The int8 dense head (fc1 -> relu -> fc2) as one CUDA kernel launch.

``fused_int8_head`` launches ``csrc/int8_head.cu`` for CUDA tensors and
raises if it cannot; for CPU tensors it runs :func:`int8_head_reference`,
the plain PyTorch version of the same arithmetic.  There is no fallback
from the card to the plain version: the plain version is what the tests
and ``chip_smoke.py`` hold the kernel against, never what serves on the
card.

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


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


@functools.cache
def _launcher():
    fn = _build.library("int8_head").int8_head_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [i, p, i, i, p, p, p, i, p, p, p, i, p, p]
    fn.restype = i
    return fn


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
    if k % 16 or h % 16:
        raise ValueError(f"need in % 16 == 0 and hidden % 16 == 0, got {k}, {h}")
    dev = x.device
    _check("x", x, torch.float32, (n, k), dev)
    _check("fc1.weight_q", fc1["weight_q"], torch.int8, (h, k), dev)
    _check("fc2.weight_q", fc2["weight_q"], torch.int8, (o, h), dev)
    for layer, name, width in ((fc1, "fc1", h), (fc2, "fc2", o)):
        for leaf in ("scale", "bias"):
            _check(f"{name}.{leaf}", layer[leaf], torch.float32, (width,), dev)
    out = torch.empty((n, o), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _launcher()(
            dev.index, x.data_ptr(), n, k,
            fc1["weight_q"].data_ptr(), fc1["scale"].data_ptr(),
            fc1["bias"].data_ptr(), h,
            fc2["weight_q"].data_ptr(), fc2["scale"].data_ptr(),
            fc2["bias"].data_ptr(), o,
            out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"int8_head kernel launch failed: CUDA error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out
