"""Forward-only predict functions for the serving engine, on one device.

``predict_fn(params, x) -> log_probs``: ``params`` is the eval-mode
:class:`~..models.net.Net` (BatchNorm layers normalize by their running
averages) for the f32 and bf16 forwards, or a
:func:`~..models.quant.quantize_params` tree for the int8 one; ``x`` is a
``[bucket, 28, 28, 1]`` float32 tensor on the params' device.  Rows are
independent through the eval forward, so padded rows never perturb live
ones.

The f32 and bf16 forwards take the JAX package's ``compute_dtype`` and
``conv_impl``; the int8 forward takes its ``int8_impl`` (``"pallas"``: the
kernel head of ``ops/int8_head.py``; ``"dot"``: two library int8 GEMMs).

The packed twins take the segment-id vector too (``int32[capacity]``,
``-1`` on padding rows; serving/buckets.py ``segment_ids``) and set the
padding rows to exactly ``0.0``, leaving live rows bit-equal to the
unpacked forward.
"""

from __future__ import annotations

import torch

from ..models.quant import int8_forward_fn


def _mask_padding(log_probs: torch.Tensor, seg_ids: torch.Tensor) -> torch.Tensor:
    return torch.where(seg_ids[:, None] >= 0, log_probs, 0.0)


def make_predict_step(compute_dtype: torch.dtype = torch.float32, conv_impl: str = "conv"):
    """The f32 (or bf16) forward: ``predict_fn(model, x)``."""

    def predict(model, x):
        return model(x, conv_impl=conv_impl, compute_dtype=compute_dtype)

    return predict


def make_int8_predict_step(int8_impl: str = "pallas"):
    """The int8 forward: ``predict_fn(qparams, x)``."""
    return int8_forward_fn(int8_impl)


def make_packed_predict_step(compute_dtype: torch.dtype = torch.float32,
                             conv_impl: str = "conv"):
    """Packed twin of :func:`make_predict_step`: ``predict_fn(model, x,
    seg_ids)``."""
    forward = make_predict_step(compute_dtype, conv_impl)

    def predict(model, x, seg_ids):
        return _mask_padding(forward(model, x), seg_ids)

    return predict


def make_packed_int8_predict_step(int8_impl: str = "pallas"):
    """Packed twin of :func:`make_int8_predict_step`."""
    forward = int8_forward_fn(int8_impl)

    def predict(qparams, x, seg_ids):
        return _mask_padding(forward(qparams, x), seg_ids)

    return predict
