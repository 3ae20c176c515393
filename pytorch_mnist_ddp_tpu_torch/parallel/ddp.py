"""The train and eval steps, for a world of one device or of N ranks.

``train_step(model, state, x, y, w, lr)`` is one optimizer step: the
train-mode forward with dropout, the masked-mean NLL, the backward, the
gradients concatenated into one flat buffer (``named_parameters`` order,
the delta kernel's), and the Adadelta update: flat accumulators take that
buffer into the delta kernel as it is, per-leaf ones take views of it
through ``adadelta_update_best`` (the JAX package's dispatch).  It
returns the loss as a device tensor and never waits for the device: the
caller reads it only on log steps.  ``eval_step(model, x, y, w)``
returns the summed NLL and the count of correct predictions over the
real samples, both device tensors.

Given a distributed :class:`~.distributed.DistState`, both are the JAX
package's data-parallel steps (its ``parallel/ddp.py``) over the default
process group, one rank a process: each rank takes the masked mean over
its own batch and its gradients, then one ``all_reduce(SUM)`` of the flat
gradient buffer divided by the world size (``lax.pmean``) before the
update, and a ``use_bn`` model sums its BatchNorm statistics over the
ranks.  The eval step all-reduces its two sums.  The returned loss is
the rank's own, not all-reduced: the reference logs rank 0's.  The
model is not wrapped in ``DistributedDataParallel``: its reducer hooks
run from ``AccumulateGrad``, which ``torch.autograd.grad`` never reaches.

``make_forward_train_step``/``make_forward_eval_step`` build the same two
steps around any ``forward(model, x) -> log-probs`` without dropout and
with the plain per-parameter Adadelta update: the ViT family's steps
(``vit_mnist.py``, ``parallel/sp.py``, ``tp_vit.py``, ``sp3.py``), on
one device or one rank of a ``(data, seq, model)`` grid.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
import torch.distributed as dist

from ..models.net import Net
from ..ops.adadelta import AdadeltaState, adadelta_init, adadelta_update
from ..ops.adadelta_flat import (
    FlatAdadeltaState,
    adadelta_init_flat,
    adadelta_step_flat,
    adadelta_update_best,
    is_flat_state,
)
from ..ops.loss import nll_loss
from ..utils.rng import fold_replica_step
from .distributed import DistState
from .mesh import Group, RankGrid, all_reduce_


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
    sync_bn: bool = False,
) -> torch.Tensor:
    """Train-mode forward and the masked-mean NLL (float32 log-probs
    whatever ``compute_dtype``).  ``w`` also keeps the padding rows out of
    the BatchNorm statistics of a ``use_bn`` model; ``sync_bn`` sums those
    statistics over the default process group."""
    log_probs = model(x, dropout_generator, conv_impl, compute_dtype, mask=w, sync_bn=sync_bn)
    return nll_loss(log_probs, y, w, reduction="mean")


def broadcast_from_chief(tensors) -> None:
    """Rank 0's values into every rank's ``tensors``, in place, as
    ``DistributedDataParallel``'s constructor broadcasts the module."""
    for t in tensors:
        dist.broadcast(t.data, src=0)


def _mean_over_ranks(flat: torch.Tensor, world_size: int) -> torch.Tensor:
    """``flat`` summed over the ranks and divided by their number, in
    place.  The divisor is a tensor: CUDA's ``tensor / python_scalar``
    multiplies by the reciprocal."""
    dist.all_reduce(flat)
    return flat.div_(torch.full((), world_size, dtype=flat.dtype, device=flat.device))


def make_train_step(
    dropout: bool = True,
    use_pallas: bool = False,
    dropout_seed: int = 0,
    rho: float = 0.9,
    eps: float = 1e-6,
    compute_dtype: torch.dtype = torch.float32,
    conv_impl: str = "conv",
    world: DistState | None = None,
) -> Callable[..., torch.Tensor]:
    """``train_step(model, state, x, y, w, lr) -> loss``.  With
    ``dropout``, step ``state.step`` draws its masks from a generator on
    x's device seeded with ``fold_replica_step(dropout_seed, state.step,
    rank, world_size)``, one stream per (step, rank).  ``compute_dtype``
    and ``conv_impl`` are the forward's (``models/net.py``).  A
    distributed ``world`` all-reduces the gradients (module docstring)."""
    world = world or DistState()
    generators: dict[torch.device, torch.Generator] = {}

    def train_step(model: Net, state: TrainState, x, y, w, lr: float) -> torch.Tensor:
        gen = None
        if dropout:
            gen = generators.get(x.device)
            if gen is None:
                gen = generators[x.device] = torch.Generator(device=x.device)
            gen.manual_seed(fold_replica_step(dropout_seed, state.step, world.rank,
                                              world.world_size))
        model.train()
        params = dict(model.named_parameters())
        loss = forward_loss(model, x, y, w, gen, compute_dtype, conv_impl,
                            sync_bn=world.distributed)
        grads = torch.autograd.grad(loss, list(params.values()))
        flat = torch.cat([g.reshape(-1) for g in grads])
        if world.distributed:
            _mean_over_ranks(flat, world.world_size)
        if is_flat_state(state.opt):
            adadelta_step_flat(params, flat, state.opt, lr, rho, eps)
        else:
            views = dict(zip(params, (v.view_as(p) for v, p in zip(
                flat.split([p.numel() for p in params.values()]), params.values()))))
            adadelta_update_best(params, views, state.opt, lr, rho, eps, use_pallas=use_pallas)
        state.step += 1
        return loss.detach()

    return train_step


def make_forward_grads(
    forward: Callable[[torch.nn.Module, torch.Tensor], torch.Tensor],
    grid: RankGrid = RankGrid(),
) -> Callable[..., tuple[torch.Tensor, dict[str, torch.Tensor]]]:
    """``grads(model, x, y, w) -> (loss, {name: gradient})``: ``forward``
    in train mode, the masked-mean NLL and its backward.

    On a rank ``grid`` (``parallel/mesh.py``) the gradients are the JAX
    sp/tp steps': every leaf into one flat buffer, one ``all_reduce(SUM)``
    over the ranks that share this rank's model coordinate (data x seq),
    divided by the data degree as a tensor: the data-axis sum of
    local-mean gradients over the data degree.  ``forward`` makes each
    rank's leaves its share of that sum (``parallel/sp.py``,
    ``tp_vit.py``).  Sharded leaves (``--tp``) are this rank's own, and
    summed only with the same shard of the other data and seq ranks."""

    def grads_of(model, x, y, w):
        model.train()
        params = dict(model.named_parameters())
        loss = nll_loss(forward(model, x), y, w, reduction="mean")
        grads = torch.autograd.grad(loss, list(params.values()))
        if grid.grad.size > 1:
            flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]), grid.grad)
            flat.div_(torch.full((), grid.num_data, dtype=flat.dtype, device=flat.device))
            grads = [v.view_as(p) for v, p in zip(
                flat.split([p.numel() for p in params.values()]), params.values())]
        return loss.detach(), dict(zip(params, grads))

    return grads_of


def make_forward_train_step(
    forward: Callable[[torch.nn.Module, torch.Tensor], torch.Tensor],
    rho: float = 0.9,
    eps: float = 1e-6,
    grid: RankGrid = RankGrid(),
) -> Callable[..., torch.Tensor]:
    """``train_step(model, state, x, y, w, lr) -> loss``:
    :func:`make_forward_grads`' gradients and the plain Adadelta update in
    place."""
    grads_of = make_forward_grads(forward, grid)

    def train_step(model, state: TrainState, x, y, w, lr: float) -> torch.Tensor:
        loss, grads = grads_of(model, x, y, w)
        adadelta_update(dict(model.named_parameters()), grads, state.opt, lr, rho, eps)
        state.step += 1
        return loss

    return train_step


def make_forward_eval_step(
    forward: Callable[[torch.nn.Module, torch.Tensor], torch.Tensor],
    data_group: Group = Group(),
) -> Callable[..., tuple[torch.Tensor, torch.Tensor]]:
    """``eval_step(model, x, y, w) -> (loss_sum, correct)`` over the real
    (weight-1) samples of the batch, summed over ``data_group`` (the
    data shards of one seq and model coordinate: JAX's ``psum`` over the
    data axis; its seq and model members hold the same totals)."""

    @torch.no_grad()
    def eval_step(model, x, y, w):
        model.eval()
        log_probs = forward(model, x)
        loss_sum = nll_loss(log_probs, y, w, reduction="sum")
        correct = ((log_probs.argmax(1) == y).to(w.dtype) * w).sum()
        if data_group.size == 1:
            return loss_sum, correct
        totals = all_reduce_(torch.stack((loss_sum, correct)), data_group)
        return totals[0], totals[1]

    return eval_step


def make_eval_step(
    compute_dtype: torch.dtype = torch.float32,
    conv_impl: str = "conv",
    world: DistState | None = None,
) -> Callable[..., tuple[torch.Tensor, torch.Tensor]]:
    """The CNN's eval step: ``model(x)`` in eval mode, with the forward's
    ``compute_dtype`` and ``conv_impl``.  A distributed ``world`` sums
    both totals over the ranks with one all-reduce, so every rank holds
    the whole batch's (the JAX package's ``psum``)."""
    local = make_forward_eval_step(lambda model, x: model(x, None, conv_impl, compute_dtype))
    if world is None or not world.distributed:
        return local

    @torch.no_grad()
    def eval_step(model, x, y, w):
        totals = torch.stack(local(model, x, y, w))
        dist.all_reduce(totals)
        return totals[0], totals[1]

    return eval_step
