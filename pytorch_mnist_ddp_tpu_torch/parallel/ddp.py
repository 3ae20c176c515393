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

With ZeRO-1 accumulators (:func:`make_train_state` ``zero=True``,
``mnist_ddp.py --zero``) the step reduce-scatters the flat gradient
instead, updates this rank's chunk of the state and all-gathers the
delta (``parallel/zero.py``); the layout of ``state.opt`` selects it.

``make_forward_train_step``/``make_forward_eval_step`` build the same two
steps around any ``forward(model, x) -> log-probs`` without dropout and
with the plain per-parameter Adadelta update (or ZeRO-1's, as above): the
ViT family's steps (``vit_mnist.py``, ``parallel/sp.py``, ``tp_vit.py``,
``sp3.py``, ``ep.py``), on one device or one rank of a ``(data, seq,
model)`` grid.
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
from .mesh import Group, RankGrid, all_reduce_, world_group
from .zero import is_zero_state, zero_init, zero_update


@dataclass
class TrainState:
    """Adadelta accumulators and the optimizer-step counter; the
    parameters live in the model."""

    opt: AdadeltaState | FlatAdadeltaState
    step: int = 0


def make_train_state(model: Net, use_pallas: bool = False, zero: bool = False,
                     world: DistState | None = None) -> TrainState:
    """Fresh state; with ``use_pallas`` the accumulators are flat, so the
    step takes the delta kernel's path, as the JAX package's
    ``make_train_state`` chooses its layout; with ``zero`` they are this
    rank's ZeRO-1 chunks over ``world``."""
    params = dict(model.named_parameters())
    if zero:
        return TrainState(opt=zero_init(params, world_group(world or DistState())))
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


def make_step_body(
    use_pallas: bool = False,
    rho: float = 0.9,
    eps: float = 1e-6,
    compute_dtype: torch.dtype = torch.float32,
    conv_impl: str = "conv",
    world: DistState | None = None,
) -> Callable[..., torch.Tensor]:
    """``body(model, opt, x, y, w, lr, generator) -> loss``: one optimizer
    step's work on the device, the part :func:`make_train_step` and the
    fused path (``parallel/fused.py``, which captures it in a CUDA graph)
    share.  The train-mode forward (dropout drawn from ``generator``, none
    if it is None), the masked-mean NLL, the backward, the flat gradient,
    its mean over a distributed ``world``, and the update of the model's
    parameters and ``opt`` in place (ZeRO-1's, the delta kernel's or the
    per-leaf one, by ``opt``'s layout).  ``lr`` is a number or a 0-d f32
    tensor on the device; the products are the same.  Nothing here reads
    the device from the host."""
    world = world or DistState()
    group = world_group(world)

    def body(model: Net, opt, x, y, w, lr, generator) -> torch.Tensor:
        model.train()
        params = dict(model.named_parameters())
        loss = forward_loss(model, x, y, w, generator, compute_dtype, conv_impl,
                            sync_bn=world.distributed)
        grads = torch.autograd.grad(loss, list(params.values()))
        flat = torch.cat([g.reshape(-1) for g in grads])
        if is_zero_state(opt):
            zero_update(params, flat, opt, lr, group, rho, eps)
        else:
            if world.distributed:
                _mean_over_ranks(flat, world.world_size)
            if is_flat_state(opt):
                adadelta_step_flat(params, flat, opt, lr, rho, eps)
            else:
                views = dict(zip(params, (v.view_as(p) for v, p in zip(
                    flat.split([p.numel() for p in params.values()]), params.values()))))
                adadelta_update_best(params, views, opt, lr, rho, eps,
                                     use_pallas=use_pallas)
        return loss.detach()

    return body


def dropout_seed_of(dropout_seed: int, step: int, world: DistState) -> int:
    """The seed of step ``step``'s dropout generator on this rank."""
    return fold_replica_step(dropout_seed, step, world.rank, world.world_size)


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
    distributed ``world`` all-reduces the gradients (module docstring).
    The work is :func:`make_step_body`'s."""
    world = world or DistState()
    body = make_step_body(use_pallas, rho, eps, compute_dtype, conv_impl, world)
    generators: dict[torch.device, torch.Generator] = {}

    def train_step(model: Net, state: TrainState, x, y, w, lr: float) -> torch.Tensor:
        gen = None
        if dropout:
            gen = generators.get(x.device)
            if gen is None:
                gen = generators[x.device] = torch.Generator(device=x.device)
            gen.manual_seed(dropout_seed_of(dropout_seed, state.step, world))
        loss = body(model, state.opt, x, y, w, lr, gen)
        state.step += 1
        return loss

    return train_step


def reduce_grads(
    grads: dict[str, torch.Tensor],
    group: Group,
    num_data: int,
    sharded: Callable[[str], bool] | None = None,
) -> dict[str, torch.Tensor]:
    """The data-parallel gradient from this rank's ``grads``: the leaves
    summed over ``group`` in one flat ``all_reduce(SUM)`` and every leaf
    divided by ``num_data`` as a tensor (the data-axis sum of local-mean
    gradients over the data degree).  Leaves ``sharded`` names (the expert
    stacks, ``parallel/ep.py``) are this rank's alone: they stay out of the
    all-reduce and are only divided.  A group of one returns ``grads``."""
    if group.size == 1:
        return grads
    shared = [k for k in grads if not (sharded and sharded(k))]
    flat = all_reduce_(torch.cat([grads[k].reshape(-1) for k in shared]), group)
    num = torch.full((), num_data, dtype=flat.dtype, device=flat.device)
    flat.div_(num)
    summed = dict(zip(shared, flat.split([grads[k].numel() for k in shared])))
    return {k: summed[k].view_as(g) if k in summed else g / num for k, g in grads.items()}


def _local_grads(forward, model, x, y, w) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """``forward`` in train mode, the masked-mean NLL and this rank's own
    gradients.  A ``forward`` that returns ``(log_probs, penalty)`` (the
    MoE ViT's weighted balance loss) is trained on ``nll + penalty`` and
    reports the nll."""
    model.train()
    params = dict(model.named_parameters())
    out = forward(model, x)
    log_probs, penalty = out if isinstance(out, tuple) else (out, None)
    loss = nll_loss(log_probs, y, w, reduction="mean")
    objective = loss if penalty is None else loss + penalty
    return loss.detach(), dict(zip(params, torch.autograd.grad(objective, list(params.values()))))


def make_forward_grads(
    forward: Callable[[torch.nn.Module, torch.Tensor], torch.Tensor],
    grid: RankGrid = RankGrid(),
    sharded: Callable[[str], bool] | None = None,
) -> Callable[..., tuple[torch.Tensor, dict[str, torch.Tensor]]]:
    """``grads(model, x, y, w) -> (loss, {name: gradient})``: ``forward``
    in train mode, the masked-mean NLL and its backward.

    On a rank ``grid`` (``parallel/mesh.py``) the gradients are the JAX
    sp/tp/ep steps': :func:`reduce_grads` over the ranks that share this
    rank's model coordinate (data x seq) and the data degree.  ``forward``
    makes each rank's leaves its share of that sum (``parallel/sp.py``,
    ``tp_vit.py``).  Sharded leaves (``--tp``) are this rank's own, and
    summed only with the same shard of the other data and seq ranks;
    those ``sharded`` names (``--experts``) are not summed at all."""

    def grads_of(model, x, y, w):
        loss, grads = _local_grads(forward, model, x, y, w)
        return loss, reduce_grads(grads, grid.grad, grid.num_data, sharded)

    return grads_of


def make_forward_step_body(
    forward: Callable[[torch.nn.Module, torch.Tensor], torch.Tensor],
    rho: float = 0.9,
    eps: float = 1e-6,
    grid: RankGrid = RankGrid(),
    sharded: Callable[[str], bool] | None = None,
) -> Callable[..., torch.Tensor]:
    """``body(model, opt, x, y, w, lr, generator) -> loss``: one optimizer
    step of ``forward`` on the device, :func:`make_step_body`'s
    counterpart for the ViT family, shared by
    :func:`make_forward_train_step` and the fused ViT
    (``parallel/fused_vit.py``, which captures it in a CUDA graph).  This
    rank's gradients (:func:`_local_grads`), then :func:`reduce_grads`
    over ``grid.grad`` and the plain per-leaf Adadelta update, or with
    ZeRO-1 accumulators :func:`~.zero.zero_update` over the data group;
    ``opt``'s layout selects it.  ``lr`` is a number or a 0-d f32 tensor
    on the device; the products are the same.  ``generator`` is unused
    (the family has no dropout).  Nothing here reads the device from the
    host."""

    def body(model, opt, x, y, w, lr, generator=None) -> torch.Tensor:
        params = dict(model.named_parameters())
        loss, grads = _local_grads(forward, model, x, y, w)
        if is_zero_state(opt):
            flat = torch.cat([g.reshape(-1) for g in grads.values()])
            zero_update(params, flat, opt, lr, grid.data, rho, eps)
        else:
            grads = reduce_grads(grads, grid.grad, grid.num_data, sharded)
            adadelta_update(params, grads, opt, lr, rho, eps)
        return loss

    return body


def make_forward_train_step(
    forward: Callable[[torch.nn.Module, torch.Tensor], torch.Tensor],
    rho: float = 0.9,
    eps: float = 1e-6,
    grid: RankGrid = RankGrid(),
    sharded: Callable[[str], bool] | None = None,
) -> Callable[..., torch.Tensor]:
    """``train_step(model, state, x, y, w, lr) -> loss``:
    :func:`make_forward_grads`' gradients and the plain Adadelta update in
    place.  With ZeRO-1 accumulators (``vit_mnist.py --zero``) this rank's
    own gradients go to :func:`~.zero.zero_update` over the data group
    instead, as in :func:`make_train_step`.  The work is
    :func:`make_forward_step_body`'s."""
    body = make_forward_step_body(forward, rho, eps, grid, sharded)

    def train_step(model, state: TrainState, x, y, w, lr: float) -> torch.Tensor:
        loss = body(model, state.opt, x, y, w, lr)
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
