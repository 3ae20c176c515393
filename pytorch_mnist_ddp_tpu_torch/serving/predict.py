"""Forward-only predict functions for the serving engine, on one device.

``predict_fn(params, x) -> log_probs``: ``params`` is the eval-mode
:class:`~..models.net.Net` for the f32 forward or a
:func:`~..models.quant.quantize_params` tree for the int8 one; ``x`` is a
``[bucket, 28, 28, 1]`` float32 tensor on the params' device.  Rows are
independent through the eval forward, so padded rows never perturb live
ones.

The packed twins take the segment-id vector too (``int32[capacity]``,
``-1`` on padding rows; serving/buckets.py ``segment_ids``) and set the
padding rows to exactly ``0.0``, leaving live rows bit-equal to the
unpacked forward.
"""

from __future__ import annotations

import torch

from ..models.quant import int8_forward_fused


def _f32_forward(model, x: torch.Tensor) -> torch.Tensor:
    return model(x)


def _mask_padding(log_probs: torch.Tensor, seg_ids: torch.Tensor) -> torch.Tensor:
    return torch.where(seg_ids[:, None] >= 0, log_probs, 0.0)


def make_predict_step():
    """The f32 forward: ``predict_fn(model, x)``."""
    return _f32_forward


def make_int8_predict_step():
    """The int8 forward: ``predict_fn(qparams, x)``; its dense head is the
    CUDA kernel on the card (models/quant.py ``int8_forward_fused``)."""
    return int8_forward_fused


def make_packed_predict_step():
    """Packed twin of :func:`make_predict_step`: ``predict_fn(model, x,
    seg_ids)``."""

    def predict(model, x, seg_ids):
        return _mask_padding(_f32_forward(model, x), seg_ids)

    return predict


def make_packed_int8_predict_step():
    """Packed twin of :func:`make_int8_predict_step`."""

    def predict(qparams, x, seg_ids):
        return _mask_padding(int8_forward_fused(qparams, x), seg_ids)

    return predict
