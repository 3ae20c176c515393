"""The train and eval steps, for a world of one device (no collectives yet).

``train_step(model, state, x, y, w, lr)`` is one optimizer step: the
train-mode forward with dropout, the masked-mean NLL, the backward, and
the Adadelta update through ``adadelta_update_best`` (the JAX package's
dispatch).  It returns the loss as a device tensor and never waits for the
device: the caller reads it only on log steps.  ``eval_step(model, x, y,
w)`` returns the summed NLL and the count of correct predictions over the
real samples, both device tensors.

``make_forward_train_step``/``make_forward_eval_step`` build the same two
steps around any ``forward(model, x) -> log-probs`` without dropout and
with the plain per-parameter Adadelta update: the ViT family's steps
(``vit_mnist.py``, ``parallel/sp.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..models.net import Net
from ..ops.adadelta import AdadeltaState, adadelta_init, adadelta_update
from ..ops.adadelta_flat import (
    FlatAdadeltaState,
    adadelta_init_flat,
    adadelta_update_best,
)
from ..ops.loss import nll_loss
from ..utils.rng import fold_step


@dataclass
class TrainState:
    """Adadelta accumulators and the optimizer-step counter; the
    parameters live in the model."""

    opt: AdadeltaState | FlatAdadeltaState
    step: int = 0


def make_train_state(model: Net, use_pallas: bool = False) -> TrainState:
    """Fresh state; with ``use_pallas`` the accumulators are flat, so the
    step takes the delta kernel's path, as the JAX package's
    ``make_train_state`` chooses its layout."""
    params = dict(model.named_parameters())
    init = adadelta_init_flat if use_pallas else adadelta_init
    return TrainState(opt=init(params))


def forward_loss(
    model: Net,
    x: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor,
    dropout_generator: torch.Generator | None,
    compute_dtype: torch.dtype = torch.float32,
    conv_impl: str = "conv",
) -> torch.Tensor:
    """Train-mode forward and the masked-mean NLL (float32 log-probs
    whatever ``compute_dtype``)."""
    log_probs = model(x, dropout_generator, conv_impl, compute_dtype)
    return nll_loss(log_probs, y, w, reduction="mean")


def make_train_step(
    dropout: bool = True,
    use_pallas: bool = False,
    dropout_seed: int = 0,
    rho: float = 0.9,
    eps: float = 1e-6,
    compute_dtype: torch.dtype = torch.float32,
    conv_impl: str = "conv",
) -> Callable[..., torch.Tensor]:
    """``train_step(model, state, x, y, w, lr) -> loss``.  With
    ``dropout``, step ``state.step`` draws its masks from a generator on
    x's device seeded with ``fold_step(dropout_seed, state.step)``.
    ``compute_dtype`` and ``conv_impl`` are the forward's (``models/net.py``)."""
    generators: dict[torch.device, torch.Generator] = {}

    def train_step(model: Net, state: TrainState, x, y, w, lr: float) -> torch.Tensor:
        gen = None
        if dropout:
            gen = generators.get(x.device)
            if gen is None:
                gen = generators[x.device] = torch.Generator(device=x.device)
            gen.manual_seed(fold_step(dropout_seed, state.step))
        model.train()
        params = dict(model.named_parameters())
        loss = forward_loss(model, x, y, w, gen, compute_dtype, conv_impl)
        grads = torch.autograd.grad(loss, list(params.values()))
        adadelta_update_best(
            params, dict(zip(params, grads)), state.opt, lr, rho, eps,
            use_pallas=use_pallas,
        )
        state.step += 1
        return loss.detach()

    return train_step


def make_forward_train_step(
    forward: Callable[[torch.nn.Module, torch.Tensor], torch.Tensor],
    rho: float = 0.9,
    eps: float = 1e-6,
) -> Callable[..., torch.Tensor]:
    """``train_step(model, state, x, y, w, lr) -> loss``: ``forward``, the
    masked-mean NLL, the backward and the plain Adadelta update in place."""

    def train_step(model, state: TrainState, x, y, w, lr: float) -> torch.Tensor:
        model.train()
        params = dict(model.named_parameters())
        loss = nll_loss(forward(model, x), y, w, reduction="mean")
        grads = torch.autograd.grad(loss, list(params.values()))
        adadelta_update(params, dict(zip(params, grads)), state.opt, lr, rho, eps)
        state.step += 1
        return loss.detach()

    return train_step


def make_forward_eval_step(
    forward: Callable[[torch.nn.Module, torch.Tensor], torch.Tensor],
) -> Callable[..., tuple[torch.Tensor, torch.Tensor]]:
    """``eval_step(model, x, y, w) -> (loss_sum, correct)`` over the real
    (weight-1) samples of the batch."""

    @torch.no_grad()
    def eval_step(model, x, y, w):
        model.eval()
        log_probs = forward(model, x)
        loss_sum = nll_loss(log_probs, y, w, reduction="sum")
        correct = ((log_probs.argmax(1) == y).to(w.dtype) * w).sum()
        return loss_sum, correct

    return eval_step


def make_eval_step(
    compute_dtype: torch.dtype = torch.float32, conv_impl: str = "conv"
) -> Callable[..., tuple[torch.Tensor, torch.Tensor]]:
    """The CNN's eval step: ``model(x)`` in eval mode, with the forward's
    ``compute_dtype`` and ``conv_impl``."""
    return make_forward_eval_step(
        lambda model, x: model(x, None, conv_impl, compute_dtype))
