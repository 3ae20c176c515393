"""ZeRO-1 data parallelism: the Adadelta accumulators sharded 1/N over the
data group (the JAX package's ``parallel/zero.py``).

Plain data parallelism all-reduces the gradient and every rank applies
the same update to a full copy of the accumulators.  Here each of the N
ranks owns one contiguous ``chunk`` of a flat, zero-padded accumulator
vector and updates only that:

    gradient --reduce_scatter-->  this rank's chunk of the summed gradient, / N
    the plain Adadelta recurrence on the chunk (no kernel: row 3 stays off
    this path, as JAX's trainer refuses --zero --pallas-opt)
    delta chunk --all_gather-->   the whole delta, ``p -= lr * delta`` per leaf

The flat order is the port's (``named_parameters``), not JAX's
``ravel_pytree`` order, so which rank owns which element differs between
the packages and no value does.  Archives are per leaf on disk
(:func:`zero_opt_to_per_leaf`, collective; :func:`per_leaf_opt_to_zero`
on load), so they cross between ``--zero`` and plain runs of either
package.  The recurrence is elementwise and the reduce-scatter sums what
the all-reduce sums, so at N = 1 a ZeRO step is the plain per-leaf step
bit for bit, and at N ranks the plain data-parallel step's values.

The accumulator layout selects the update: ``parallel/ddp.py``'s steps
take the ZeRO path for a :class:`ZeroAdadeltaState`, the CNN's
(``mnist_ddp.py --zero``) and the ViT's (``vit_mnist.py --zero``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.adadelta import AdadeltaState, adadelta_delta
from .mesh import Group, all_gather_flat, reduce_scatter

Params = dict[str, torch.Tensor]


class ZeroAdadeltaState(NamedTuple):
    """This rank's chunk of the flat padded accumulators (``[chunk]``
    float32 each).  A type of its own: dispatch keys on ``isinstance``."""

    square_avg: torch.Tensor
    acc_delta: torch.Tensor


def is_zero_state(opt) -> bool:
    return isinstance(opt, ZeroAdadeltaState)


def zero_chunk(n_params: int, n_shards: int) -> int:
    """Each rank's slice length: the padded vector divides exactly."""
    return -(-n_params // n_shards)


def _numel(params: Params) -> int:
    return sum(p.numel() for p in params.values())


def zero_init(params: Params, group: Group) -> ZeroAdadeltaState:
    """Zero accumulator chunks for ``params`` on their device."""
    chunk = zero_chunk(_numel(params), group.size)
    device = next(iter(params.values())).device
    return ZeroAdadeltaState(torch.zeros(chunk, device=device),
                             torch.zeros(chunk, device=device))


@torch.no_grad()
def zero_update(params: Params, flat_grad: torch.Tensor, opt: ZeroAdadeltaState, lr: float,
                group: Group, rho: float = 0.9, eps: float = 1e-6) -> None:
    """One ZeRO-1 step in place: ``flat_grad`` this rank's local-mean
    gradient in ``named_parameters`` order, ``opt`` its accumulator
    chunks.  Collective over ``group``."""
    n, size = flat_grad.numel(), group.size
    chunk = opt.square_avg.numel()
    g = reduce_scatter(F.pad(flat_grad, (0, chunk * size - n)), group)
    # The divisor is a tensor: CUDA's tensor / python_scalar multiplies by
    # the reciprocal.
    g = g / torch.full((), size, dtype=g.dtype, device=g.device)
    delta, sq, ac = adadelta_delta(g, opt.square_avg, opt.acc_delta, rho, eps)
    opt.square_avg.copy_(sq)
    opt.acc_delta.copy_(ac)
    delta = all_gather_flat(delta, group)[:n]
    for p, d in zip(params.values(), delta.split([p.numel() for p in params.values()])):
        p.sub_(d.view_as(p).mul(lr))


def _chunks(tree: Params, group: Group) -> torch.Tensor:
    flat = torch.cat([t.reshape(-1) for t in tree.values()])
    chunk = zero_chunk(flat.numel(), group.size)
    return F.pad(flat, (0, chunk * group.size - flat.numel())).chunk(group.size)[group.rank]


def per_leaf_opt_to_zero(opt: AdadeltaState, group: Group) -> ZeroAdadeltaState:
    """Per-leaf accumulators (an archive's, in ``named_parameters``
    order) -> this rank's chunks."""
    return ZeroAdadeltaState(_chunks(opt.square_avg, group).clone(),
                             _chunks(opt.acc_delta, group).clone())


@torch.no_grad()
def zero_opt_to_per_leaf(opt: ZeroAdadeltaState, params: Params, group: Group) -> AdadeltaState:
    """Every rank's chunks gathered and cut back into per-leaf trees shaped
    like ``params`` (collective over ``group``: every rank calls it, the
    chief writes the archive)."""
    n = _numel(params)
    trees = []
    for buf in opt:
        flat = all_gather_flat(buf, group)[:n]
        trees.append({k: v.view_as(p).clone() for (k, p), v in
                      zip(params.items(), flat.split([p.numel() for p in params.values()]))})
    return AdadeltaState(*trees)

