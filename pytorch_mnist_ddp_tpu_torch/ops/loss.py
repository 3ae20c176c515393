"""Negative log-likelihood with 0/1 sample weights (``F.nll_loss``).

Padded batches carry a weight vector: ``mean`` divides the weighted sum by
the real-sample count ``max(w.sum(), 1)``, ``sum`` adds only real samples;
on unpadded input both equal torch's ``F.nll_loss``.
"""

from __future__ import annotations

import torch


def nll_loss(
    log_probs: torch.Tensor,
    targets: torch.Tensor,
    weights: torch.Tensor | None = None,
    reduction: str = "mean",
) -> torch.Tensor:
    """NLL from log-probabilities ``[n, c]`` and integer targets ``[n]``."""
    per_sample = -log_probs.gather(1, targets[:, None].long())[:, 0]
    if weights is not None:
        per_sample = per_sample * weights
        denom = torch.clamp(weights.sum(), min=1.0)
    else:
        # A tensor, not a Python number: CUDA's tensor / python_scalar
        # multiplies by the reciprocal instead of dividing.
        denom = torch.full((), per_sample.shape[0], dtype=per_sample.dtype,
                           device=per_sample.device)
    if reduction == "mean":
        return per_sample.sum() / denom
    if reduction == "sum":
        return per_sample.sum()
    if reduction == "none":
        return per_sample
    raise ValueError(f"unknown reduction {reduction!r}")
