"""Pipeline parallelism for the CNN (the JAX package's ``parallel/pp.py``,
``mnist_ddp.py --pp``): its two stages over the 2-wide model axis of a
``(data, 1, stage)`` rank grid.

- stage 0: conv1 -> relu -> conv2 -> relu -> maxpool -> dropout(.25) ->
  flatten (``Net.features``), a ``[mb, 9216]`` boundary in the compute
  dtype (bfloat16 under ``--bf16``, half the bytes a hop);
- stage 1: fc1 -> relu -> dropout(.5) -> fc2 -> log_softmax
  (``Net.head``) -> the weighted NLL sum.

``parallel/pipeline.py`` schedules them over ``--pp-microbatches``
microbatches of each data shard's batch, the boundary staged through the
host over gloo.  Every rank holds the whole model; the stages' disjoint
gradients are summed over every rank (data x stage) in one all-reduce and
divided by the data degree (JAX's stage ``psum`` then data ``pmean``), and
every rank applies the same plain Adadelta update.  Dropout draws a
stream per microbatch and stage (JAX's per-microbatch keys; the masks'
geometry differs from the data-parallel step's, as in JAX).

Serving (:func:`make_pp_predict_step`, a ``pp2`` replica) runs the two
stages in one process (:class:`~.mesh.Lockstep`): microbatch ``j``'s
boundary goes from stage 0's stream to stage 1's while stage 0 runs
microbatch ``j + 1``.
"""

from __future__ import annotations

import torch

from ..models.net import Net
from ..ops.adadelta import adadelta_update
from ..ops.loss import nll_loss
from ..utils.rng import fold_replica_step, fold_step
from .ddp import TrainState, reduce_grads
from .mesh import Lockstep, RankGrid, all_reduce_
from .pipeline import make_pipeline

NUM_STAGES = 2
FLAT = 9216  # the stage boundary's width, 64 * 12 * 12


def make_pp_grads(grid: RankGrid, num_micro: int = 2, dropout: bool = True,
                  dropout_seed: int = 0, compute_dtype: torch.dtype = torch.float32):
    """``grads(model, x, y, w, step) -> (loss, {name: gradient})`` on the
    ``(data, 1, 2)`` grid: this data shard's mean loss (both stages hold
    it) and the whole model's gradient, every rank alike; ``step`` seeds
    the dropout streams."""
    if grid.model.size != NUM_STAGES:
        raise ValueError(f"pipeline needs a {NUM_STAGES}-wide 'model' axis, got "
                         f"{grid.model.size}")
    d = grid.coords[0]
    gens: dict = {}
    seed = [None]  # the step's dropout seed, set before each pipeline call

    def generator(device, j: int, stage: int):
        if seed[0] is None:
            return None
        gen = gens.get((device, j))
        if gen is None:
            gen = gens[(device, j)] = torch.Generator(device=device)
        gen.manual_seed(fold_step(fold_step(seed[0], j), stage))
        return gen

    def stage0(model: Net, x_mb, j):
        return model.features(x_mb, generator(x_mb.device, j, 1), compute_dtype=compute_dtype)

    def stage1(model: Net, act, y_mb, w_mb, j):
        log_probs = model.head(act, generator(act.device, j, 2))
        return nll_loss(log_probs, y_mb, w_mb, reduction="sum")

    pipeline = make_pipeline([stage0, stage1], num_micro, grid.model)
    ready = []

    def grads_of(model: Net, x, y, w, step: int):
        n = x.shape[0]
        if n % num_micro:
            raise ValueError(f"shard batch {n} not divisible by {num_micro} microbatches")
        if not ready:
            if grid.model.backend == "nccl":
                # NCCL wants every member in a group's first call; the
                # pipeline's first is a send between two of them.
                all_reduce_(torch.zeros(1, device=x.device), grid.model)
            ready.append(True)
        seed[0] = fold_replica_step(dropout_seed, step, d, grid.num_data) if dropout else None
        mb = n // num_micro
        model.train()
        denom = torch.clamp(w.sum(), min=1.0)
        boundary = torch.empty((mb, FLAT), dtype=compute_dtype, device=x.device)
        loss_sum, grads = pipeline(model, x.reshape(num_micro, mb, *x.shape[1:]),
                                   y.reshape(num_micro, mb), w.reshape(num_micro, mb),
                                   torch.ones((), device=x.device) / denom, boundary)
        return loss_sum / denom, reduce_grads(grads, grid.world, grid.num_data)

    return grads_of


def make_pp_train_step(grid: RankGrid, num_micro: int = 2, dropout: bool = True,
                       dropout_seed: int = 0, compute_dtype: torch.dtype = torch.float32,
                       rho: float = 0.9, eps: float = 1e-6):
    """``train_step(model, state, x, y, w, lr) -> loss``: :func:`make_pp_grads`'
    gradient and the plain Adadelta update, the same on every rank."""
    grads_of = make_pp_grads(grid, num_micro, dropout, dropout_seed, compute_dtype)

    def train_step(model: Net, state: TrainState, x, y, w, lr: float) -> torch.Tensor:
        loss, grads = grads_of(model, x, y, w, state.step)
        adadelta_update(dict(model.named_parameters()), grads, state.opt, lr, rho, eps)
        state.step += 1
        return loss

    return train_step


def pp_predict(stages: list[Net], x: torch.Tensor, num_micro: int,
               lock: Lockstep) -> torch.Tensor:
    """The 2-stage pipeline's serving forward (JAX ``make_pp_predict_step``):
    ``x`` (on the first device) in ``num_micro`` microbatches, each through
    stage 0 (``Net.features``) on ``stages[0]``'s device, its ``[mb,
    9216]`` boundary handed to stage 1 (``Net.head``) on ``stages[1]``'s
    (the ppermute), the rows gathered in order on the first device.  Each
    stage holds the whole model, as JAX replicates it; the same ops in the
    same order as the single-device forward, a microbatch at a time."""
    n = x.shape[0]
    if n % num_micro:
        raise ValueError(f"batch {n} not divisible by {num_micro} microbatches")
    mb = n // num_micro
    first, second = stages
    x0 = lock.to_shard(x, 0)
    outs = []
    for j in range(num_micro):
        with lock.on(0):
            act = first.features(x0[j * mb:(j + 1) * mb])
        act = lock.send(act, 0, 1)
        with lock.on(1):
            outs.append(second.head(act))
    return torch.cat([lock.to_controller(o, 1) for o in outs])


def make_pp_predict_step(lock: Lockstep, num_micro: int = 2):
    """``predict_fn(stages, x) -> log_probs`` over ``lock``'s two stages."""
    if lock.size != NUM_STAGES:
        raise ValueError(f"pipeline needs a {NUM_STAGES}-wide 'model' axis, got {lock.size}")
    if num_micro < 1:
        raise ValueError(f"num_micro must be >= 1, got {num_micro}")

    def predict(stages, x):
        return pp_predict(stages, x, num_micro, lock)

    return predict
