"""Tensor parallelism for the CNN over a model group (the JAX package's
``parallel/tp.py``, ``mnist_ddp.py --tp N``).

On a ``(data, model)`` rank grid (``mesh.make_rank_grid([("model", N)])``)
the classifier is Megatron-style:

- fc1 is column-parallel: each member holds 128/N of its output features
  (rows of the torch ``[out, in]`` weight and of its bias); relu and
  dropout are elementwise, so they need no communication;
- fc2 is row-parallel: each member holds the matching 128/N input columns
  of its weight, computes a partial logit sum, and one all-reduce over the
  model group completes the logits (:func:`~.mesh.reduce_forward`), before
  the replicated bias;
- the convs stay replicated (0.03% of the parameters).

Gradients are JAX's under its VMA: the flattened activation entering the
column-parallel fc1 passes its gradient summed over the group
(:func:`~.mesh.reduce_backward`), so the convs' gradients are whole on
every member; the sharded leaves get their own slice's.  The step then
sums them over the data ranks that share this model coordinate and
divides by the data degree (``ddp.reduce_grads``), and the plain Adadelta
runs on local shards (elementwise, so sharded state is exact).  With
``--bf16`` the partial logits cross the group at half width.

Dropout: the conv stage's mask is the data shard's (every model member of
it draws the same), fc1's is the member's own; the seeds are the port's
(an expected divergence from JAX's keys).

Serving (:func:`make_tp_predict_step`, a ``tpK`` replica) runs the same
layers over ``k`` shards in one process (:class:`~.mesh.Lockstep`), the
fc2 sum an explicit one in shard order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.net import DROPOUT2_RATE, Net, _linear, dropout
from ..ops.adadelta import adadelta_update
from ..ops.loss import nll_loss
from ..utils.rng import fold_replica_step, fold_step
from .ddp import TrainState, make_forward_eval_step, reduce_grads
from .mesh import Group, Lockstep, RankGrid, all_gather, reduce_backward, reduce_forward

# The leaf's split dim in torch's [out, in] layout (JAX's param_specs: fc1
# kernel P(None, model) and bias P(model); fc2 kernel P(model, None)).
SPLIT_DIM = {"fc1.weight": 0, "fc1.bias": 0, "fc2.weight": 1}


def split_dim(name: str) -> int | None:
    """The dim a CNN leaf splits on over the model group, or None
    (replicated)."""
    return SPLIT_DIM.get(name)


@torch.no_grad()
def shard_state(model: Net, group: Group) -> Net:
    """Keep this member's slices of the sharded leaves, in place (JAX's
    ``shard_state``; the accumulators, made after it, shard alike);
    returns ``model``."""
    for name, param in model.named_parameters():
        dim = split_dim(name)
        if dim is not None:
            if param.shape[dim] % group.size:
                raise ValueError(f"{name} {tuple(param.shape)} does not split "
                                 f"{group.size} ways")
            param.data = param.data.chunk(group.size, dim)[group.rank].clone()
    return model


@torch.no_grad()
def gather_replicated(model: Net, group: Group) -> dict[str, torch.Tensor]:
    """The whole state dict from the members' shards: collective over the
    group, so every member calls it (the chief alone writes)."""
    out = {}
    for name, value in model.state_dict().items():
        dim = split_dim(name)
        out[name] = value if dim is None else torch.cat(all_gather(value, group), dim)
    return out


def tp_forward(model: Net, x: torch.Tensor, group: Group = Group(),
               generators: tuple | None = None,
               compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The CNN forward over a model shard (JAX ``_tp_forward``): log-probs
    of this data shard's rows.  ``generators`` ``(conv stage, fc1)`` turn
    dropout on."""
    gen1, gen2 = generators or (None, None)
    x = reduce_backward(model.features(x, gen1, compute_dtype=compute_dtype), group)
    h = F.relu(_linear(model.fc1, x))
    if gen2 is not None:
        h = dropout(h, DROPOUT2_RATE, gen2)
    logits = reduce_forward(F.linear(h, model.fc2.weight.to(h.dtype)), group)
    logits = logits + model.fc2.bias.to(h.dtype)
    return F.log_softmax(logits.float(), dim=-1)


def make_tp_grads(grid: RankGrid, dropout: bool = True, dropout_seed: int = 0,
                  compute_dtype: torch.dtype = torch.float32):
    """``grads(model, x, y, w, step) -> (loss, {name: gradient})`` on the
    ``(data, model)`` grid for a model cut by :func:`shard_state`: this
    data shard's mean loss and this member's gradients (its own slices of
    the sharded leaves), summed over the data ranks of its model
    coordinate and divided by the data degree.  Dropout seeds fold
    ``step`` and the data coordinate (the conv stage) and also the model
    coordinate (fc1)."""
    d, m = grid.coords[0], grid.coords[2]
    gens: dict = {}

    def generators(device, step):
        if not dropout:
            return None
        pair = gens.get(device)
        if pair is None:
            pair = gens[device] = (torch.Generator(device=device),
                                   torch.Generator(device=device))
        base = fold_replica_step(dropout_seed, step, d, grid.num_data)
        pair[0].manual_seed(base)
        pair[1].manual_seed(fold_step(base, 1 + m))
        return pair

    def grads_of(model: Net, x, y, w, step: int):
        model.train()
        params = dict(model.named_parameters())
        log_probs = tp_forward(model, x, grid.model, generators(x.device, step), compute_dtype)
        loss = nll_loss(log_probs, y, w, reduction="mean")
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        return loss.detach(), reduce_grads(grads, grid.grad, grid.num_data)

    return grads_of


def make_tp_train_step(grid: RankGrid, dropout: bool = True, dropout_seed: int = 0,
                       compute_dtype: torch.dtype = torch.float32, rho: float = 0.9,
                       eps: float = 1e-6):
    """``train_step(model, state, x, y, w, lr) -> loss``: :func:`make_tp_grads`'
    gradients and the plain Adadelta update on this member's shards."""
    grads_of = make_tp_grads(grid, dropout, dropout_seed, compute_dtype)

    def train_step(model: Net, state: TrainState, x, y, w, lr: float) -> torch.Tensor:
        loss, grads = grads_of(model, x, y, w, state.step)
        adadelta_update(dict(model.named_parameters()), grads, state.opt, lr, rho, eps)
        state.step += 1
        return loss

    return train_step


def make_tp_eval_step(grid: RankGrid, compute_dtype: torch.dtype = torch.float32):
    """``eval_step(model, x, y, w) -> (loss_sum, correct)`` on the sharded
    model, summed over the data group (JAX ``make_tp_eval_step``)."""
    return make_forward_eval_step(
        lambda model, x: tp_forward(model, x, grid.model, None, compute_dtype), grid.data)


def tp_predict(shards: list[Net], x: torch.Tensor, lock: Lockstep) -> torch.Tensor:
    """The CNN's tensor-parallel serving forward (JAX ``make_tp_predict_step``)
    over ``lock``'s shards, ``shards[i]`` cut by :func:`shard_state` for
    member ``i`` and placed on ``lock.devices[i]``; ``x`` and the log-probs
    on the first device.  The conv stage is replicated (every member of
    JAX's model axis computes it alike), so it runs once on the first
    device and goes to every shard; each shard's fc1 columns, relu and fc2
    rows give partial logits, summed in shard order (the psum), then fc2's
    bias and the float32 log_softmax."""
    feats = shards[0].features(x)
    parts = []
    for i, (model, f) in enumerate(zip(shards, lock.to_shards(feats))):
        with lock.on(i):
            h = F.relu(_linear(model.fc1, f))
            parts.append(F.linear(h, model.fc2.weight))
    logits = lock.psum(parts) + shards[0].fc2.bias
    return F.log_softmax(logits.float(), dim=-1)


def make_tp_predict_step(lock: Lockstep):
    """``predict_fn(shards, x) -> log_probs`` over ``lock``'s shards."""

    def predict(shards, x):
        return tp_predict(shards, x, lock)

    return predict
