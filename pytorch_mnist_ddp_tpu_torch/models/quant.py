"""int8 inference variant: quantized weights, int8 dense head, f32 tail.

The JAX package's post-training symmetric scheme, on torch-layout weights:

- **Weights**: per-output-channel symmetric int8.  ``scale[o] =
  max|W[o, ...]| / 127``; ``W_q = round(W / scale)`` clipped to
  ``[-127, 127]``.  The output channel is dim 0 in torch's layout (OIHW
  convs, ``[out, in]`` Linear); a channel's max-abs does not depend on the
  order of its inputs, so the codes equal the JAX package's codes after
  the layout map (fc1's column permutation included).
- **Dense head (fc1, fc2)**: per-row dynamic activation quantization and
  an int8 x int8 -> int32 product, then ``acc * (a_scale * scale) + bias``.
  Two heads compute it (:func:`int8_forward_fn`): ``"pallas"``, the fused
  kernel of ``ops/int8_head.py`` (the port's default, one launch on the
  card), and ``"dot"``, the JAX package's ``lax.dot_general`` head:
  two library int8 GEMMs (``torch._int_mm``), each quantize and rescale
  an op of its own.  Both accumulate in int32 exactly, so their int8
  codes are equal.
- **Convs**: weight-only — int8 kernels dequantized to f32 at use.
- **Tail**: relu/maxpool and the log_softmax stay f32.

Parity with the f32 ``Net`` is gated by the serving engine, never assumed.
BatchNorm checkpoints are rejected (with the JAX engine's text).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.int8_head import fused_int8_head, int8_head_reference
from .net import to_nchw

QMAX = 127.0
QUANT_LAYERS = ("conv1", "conv2", "fc1", "fc2")


def quantize_tensor(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel (dim 0) symmetric int8: ``(W_q int8, scale f32[out])``.

    An all-zero channel gets scale 1.0 (its codes are zero either way;
    0/0 must not poison the dequant)."""
    w = w.detach().to(torch.float32)
    absmax = w.abs().reshape(w.shape[0], -1).amax(dim=1)
    # absmax / a full tensor, not / QMAX: CUDA divides by a Python scalar
    # through its reciprocal, which is not the IEEE quotient.
    scale = torch.where(
        absmax > 0, absmax / torch.full_like(absmax, QMAX), torch.ones_like(absmax)
    )
    bcast = scale.reshape(-1, *([1] * (w.dim() - 1)))
    q = torch.clamp(torch.round(w / bcast), -QMAX, QMAX).to(torch.int8)
    return q, scale


def quantize_params(state: dict[str, torch.Tensor]) -> dict[str, dict[str, torch.Tensor]]:
    """torch state dict -> quantized serving tree
    ``{layer: {"weight_q": int8, "scale": f32[out], "bias": f32[out]}}``,
    on the state's device."""
    if any(k.startswith("bn") for k in state):
        raise ValueError(
            "int8 variant does not support BatchNorm checkpoints; "
            "serve BN checkpoints at f32 or bf16"
        )
    out = {}
    for layer in QUANT_LAYERS:
        if f"{layer}.weight" not in state:
            raise ValueError(f"state dict has no layer {layer!r}")
        weight_q, scale = quantize_tensor(state[f"{layer}.weight"])
        out[layer] = {
            "weight_q": weight_q.contiguous(),
            "scale": scale.contiguous(),
            "bias": state[f"{layer}.bias"].detach().to(torch.float32).contiguous(),
        }
    return out


def qparams_to(qparams: dict, device: torch.device) -> dict:
    return {
        layer: {k: v.to(device) for k, v in leaves.items()}
        for layer, leaves in qparams.items()
    }


def _dequant_conv(x: torch.Tensor, layer: dict) -> torch.Tensor:
    """Weight-only int8 conv: dequantize the kernel, run the f32 conv."""
    weight = layer["weight_q"].to(torch.float32) * layer["scale"].reshape(-1, 1, 1, 1)
    return F.conv2d(x, weight, layer["bias"])


def conv_stack(qparams: dict, x: torch.Tensor) -> torch.Tensor:
    """The shared front half: ``[n, 28, 28, 1]`` -> ``[n, 9216]`` features
    (C*H*W order), f32 throughout."""
    x = to_nchw(x.to(torch.float32))
    x = F.relu(_dequant_conv(x, qparams["conv1"]))
    x = F.relu(_dequant_conv(x, qparams["conv2"]))
    x = F.max_pool2d(x, 2)
    return torch.flatten(x, 1).contiguous()


def int8_forward(qparams: dict, x: torch.Tensor) -> torch.Tensor:
    """Eval-mode quantized forward through the PLAIN dense head:
    ``[n, 28, 28, 1]`` f32 -> ``[n, 10]`` f32 log-probs.  The reference
    the kernel is held to; the serving engine runs
    :func:`int8_forward_fused`."""
    x = int8_head_reference(qparams["fc1"], qparams["fc2"], conv_stack(qparams, x))
    return F.log_softmax(x, dim=-1)


def int8_forward_fused(qparams: dict, x: torch.Tensor) -> torch.Tensor:
    """:func:`int8_forward` with the dense head as ONE kernel launch on the
    card (``ops/int8_head.py``); on CPU tensors the head is the plain
    version."""
    x = fused_int8_head(qparams["fc1"], qparams["fc2"], conv_stack(qparams, x))
    return F.log_softmax(x, dim=-1)


# torch._int_mm's shape rules (CUDA): more than 16 rows, the inner and
# output widths multiples of 8.
_INT_MM_MIN_ROWS = 17
_INT_MM_ALIGN = 8


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _int8_gemm(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """``int8 [n, in] x int8 [out, in]^T -> int32 [n, out]``, exact, by one
    ``torch._int_mm``.  Rows, inner and output widths are zero-padded to
    the library's shape rules and the result sliced back: zero codes add
    nothing to an integer sum.  ``w_q.t()`` is the column-major view the
    library takes without a copy."""
    n, k = x_q.shape
    o = w_q.shape[0]
    rows = max(n, _INT_MM_MIN_ROWS)
    k_pad, o_pad = _round_up(k, _INT_MM_ALIGN), _round_up(o, _INT_MM_ALIGN)
    if (rows, k_pad) != (n, k):
        x_q = F.pad(x_q, (0, k_pad - k, 0, rows - n))
    if (o_pad, k_pad) != (o, k):
        w_q = F.pad(w_q, (0, k_pad - k, 0, o_pad - o))
    return torch._int_mm(x_q, w_q.t())[:n, :o]


def _int8_dense(x: torch.Tensor, layer: dict) -> torch.Tensor:
    """The JAX package's ``models/quant.py:_int8_dense``: per-row dynamic
    quantization (divide by a tensor, round half to even, clamp), the
    int8 x int8 -> int32 GEMM, then ``acc * (a_scale * scale) + bias``."""
    a_max = x.abs().amax(dim=-1, keepdim=True)
    a_scale = torch.where(a_max > 0, a_max / torch.full_like(a_max, QMAX),
                          torch.ones_like(a_max))
    x_q = torch.clamp(torch.round(x / a_scale), -QMAX, QMAX).to(torch.int8)
    acc = _int8_gemm(x_q, layer["weight_q"])
    return acc.to(torch.float32) * (a_scale * layer["scale"]) + layer["bias"]


def int8_head_dot(fc1: dict, fc2: dict, x: torch.Tensor) -> torch.Tensor:
    """The dense head by two library int8 GEMMs: f32 ``[n, in]`` -> f32
    ``[n, out2]`` pre-softmax logits, equal to the kernel's
    (``ops/int8_head.py:fused_int8_head``) bit for bit."""
    return _int8_dense(torch.relu(_int8_dense(x, fc1)), fc2)


def int8_forward_dot(qparams: dict, x: torch.Tensor) -> torch.Tensor:
    """:func:`int8_forward` with the JAX package's ``dot`` head
    (:func:`int8_head_dot`), no kernel launch."""
    x = int8_head_dot(qparams["fc1"], qparams["fc2"], conv_stack(qparams, x))
    return F.log_softmax(x, dim=-1)


INT8_IMPLS = ("dot", "pallas")


def int8_forward_fn(int8_impl: str = "pallas"):
    """The int8 forward for an impl name (the JAX ``--int8-impl``
    choices): ``"pallas"`` the kernel head, ``"dot"`` the GEMM head."""
    if int8_impl == "dot":
        return int8_forward_dot
    if int8_impl == "pallas":
        return int8_forward_fused
    raise ValueError(f"unknown int8 impl {int8_impl!r} (want dot|pallas)")
