"""Adadelta with torch's update (``optim.Adadelta``), per parameter.

The reference builds ``optim.Adadelta(params, lr=1.0)`` with ``rho=0.9``,
``eps=1e-6`` and no weight decay.  The update, eps inside both roots and
``acc_delta`` accumulating delta WITHOUT lr:

    square_avg <- rho * square_avg + ((1-rho) * g) * g
    delta      <- (sqrt(acc_delta + eps) / sqrt(square_avg + eps)) * g
    acc_delta  <- rho * acc_delta + ((1-rho) * delta) * delta
    p          <- p - lr * delta

Every product and sum is a separate, rounded torch op, in the order above:
``add_(alpha=)`` and ``addcmul_`` are fused multiply-adds, which round
once where the reference rounds twice.  This is the default optimizer
path and the plain version the kernel in ``csrc/adadelta.cu`` is held
against.  Unlike the JAX package's pure functions, the update writes the
parameters and both accumulators in place (no second copy of the model).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

Params = dict[str, torch.Tensor]  # named_parameters() order


class AdadeltaState(NamedTuple):
    square_avg: Params
    acc_delta: Params


def adadelta_init(params: Params) -> AdadeltaState:
    """Zero accumulators shaped like ``params``, as torch initializes them."""
    return AdadeltaState(
        square_avg={k: torch.zeros_like(p) for k, p in params.items()},
        acc_delta={k: torch.zeros_like(p) for k, p in params.items()},
    )


def adadelta_delta(
    g: torch.Tensor, sq: torch.Tensor, ac: torch.Tensor, rho: float, eps: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrence on one (grad, square_avg, acc_delta) triple: returns
    new ``(delta, square_avg, acc_delta)`` tensors; the caller applies
    ``p - lr * delta``."""
    sq = sq.mul(rho).add(g.mul(1.0 - rho).mul(g))
    delta = ac.add(eps).sqrt().div(sq.add(eps).sqrt()).mul(g)
    ac = ac.mul(rho).add(delta.mul(1.0 - rho).mul(delta))
    return delta, sq, ac


@torch.no_grad()
def adadelta_update(
    params: Params,
    grads: Params,
    state: AdadeltaState,
    lr: float,
    rho: float = 0.9,
    eps: float = 1e-6,
) -> tuple[Params, AdadeltaState]:
    """One Adadelta step over every parameter, in place; returns
    ``(params, state)``, the same objects."""
    for name, p in params.items():
        sq, ac = state.square_avg[name], state.acc_delta[name]
        delta, new_sq, new_ac = adadelta_delta(grads[name], sq, ac, rho, eps)
        p.sub_(delta.mul(lr))
        sq.copy_(new_sq)
        ac.copy_(new_ac)
    return params, state
