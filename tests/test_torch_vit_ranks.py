"""The rank programs of the parallel ViT's gloo worlds, and the port's rank
grid, shards and data shards on their own.

``tests/test_torch_sp.py``, ``test_torch_tp_vit.py`` and
``test_torch_sp3.py`` hold the port's ``--sp``, ``--tp`` and ``--sp --tp``
against the JAX package; their worlds run :func:`grid_tasks` on every rank
(``test_torch_launch.run_world``: spawned processes, ``file://``
rendezvous, one thread a rank, one timeout a world).  This file imports no
JAX, so that each rank starts in seconds.

A task is ``(name, function, kwargs)``; every function here takes the
rank's grid first and returns numpy arrays, and what a rank returns is
``{name: result}``.  Inputs are global numpy arrays: each rank takes its
data shard's rows (``shard_rows``) and its seq member's tokens.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu_torch.data.loader import DataLoader
from pytorch_mnist_ddp_tpu_torch.models.vit import ViT, ViTConfig
from pytorch_mnist_ddp_tpu_torch.ops.adadelta import adadelta_init
from pytorch_mnist_ddp_tpu_torch.ops.flash_attention import select_attention
from pytorch_mnist_ddp_tpu_torch.parallel import sp, sp3, tp_vit
from pytorch_mnist_ddp_tpu_torch.parallel.ddp import (
    TrainState,
    make_forward_eval_step,
    make_forward_grads,
)
from pytorch_mnist_ddp_tpu_torch.parallel.mesh import (
    _members,
    grid_coords,
    grid_rank,
    grid_shape,
    make_rank_grid,
)
from pytorch_mnist_ddp_tpu_torch.utils.checkpoint import save_params_tree
from pytorch_mnist_ddp_tpu_torch.utils.convert import (
    gather_vit_state,
    jax_vit_tree_from_torch,
    shard_vit_state,
    tp_split_dim,
)

# -- the rank programs ------------------------------------------------------------


def grid_tasks(world, minors: list, tasks: list) -> dict:
    """This rank's grid over ``world`` for ``minors``, then every task."""
    grid = make_rank_grid(minors, world)
    out = {"coords": grid.coords, "shape": grid.shape}
    for name, fn, kwargs in tasks:
        out[name] = globals()[fn](grid, **kwargs)
    return out


def shard_rows(grid, a: np.ndarray) -> torch.Tensor:
    """This rank's data shard of a global batch (rows d*b onward)."""
    b = len(a) // grid.num_data
    d = grid.coords[0]
    return torch.from_numpy(np.ascontiguousarray(a[d * b:(d + 1) * b]))


def _model(grid, kind: str, state: dict, flash: bool = False, bf16: bool = False,
           remat: bool = False) -> ViT:
    model = ViT(ViTConfig(bf16=bf16, remat=remat), select_attention(flash))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    if kind in ("tp", "sp3"):
        tp_vit.shard_vit_tp(model, grid.model)
    return model


def _forward(grid, kind: str, flash: bool, impl: str):
    if kind == "sp":
        return lambda m, x: sp.sp_vit_forward(m, x, grid.seq, flash, impl)
    if kind == "tp":
        return lambda m, x: tp_vit.tp_vit_forward(m, x, grid.model, flash)
    return lambda m, x: sp3.sp3_vit_forward(m, x, grid, flash)


def _steps(grid, kind: str, flash: bool, impl: str, cfg: ViTConfig):
    if kind == "sp":
        return sp.make_sp_train_step(cfg, grid, flash, impl)
    if kind == "tp":
        return tp_vit.make_vit_tp_train_step(cfg, grid, flash)
    return sp3.make_sp3_train_step(cfg, grid, flash)


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _full_state(grid, kind: str, model: ViT) -> dict:
    state = (tp_vit.gather_vit_tp_state(model, grid.model) if kind in ("tp", "sp3")
             else model.state_dict())
    return {k: v.detach().numpy().copy() for k, v in state.items()}


def trajectory(grid, kind: str, state: dict, batches: tuple, impl: str = "ring",
               flash: bool = False, bf16: bool = False, remat: bool = False) -> dict:
    """The train step on this rank's shard of every global batch ``(xs,
    ys, ws)`` [steps, D*b] at lr 1.0: the losses, after every step a
    digest of the replicated leaves and one of all this rank's leaves, and
    the final state, gathered whole."""
    model = _model(grid, kind, state, flash, bf16, remat)
    train_state = TrainState(opt=adadelta_init(dict(model.named_parameters())))
    step = _steps(grid, kind, flash, impl, model.cfg)
    losses, replicated, local = [], [], []
    for x, y, w in zip(*batches):
        loss = step(model, train_state, shard_rows(grid, x), shard_rows(grid, y),
                    shard_rows(grid, w), 1.0)
        losses.append(float(loss))
        named = dict(model.named_parameters())
        replicated.append(_digest(p for k, p in named.items() if tp_split_dim(k) is None))
        local.append(_digest(named.values()))
    return {"losses": np.asarray(losses), "replicated": replicated, "local": local,
            "step": train_state.step, "state": _full_state(grid, kind, model)}


def forward(grid, kind: str, state: dict, x: np.ndarray, impl: str = "ring",
            flash: bool = False, bf16: bool = False) -> np.ndarray:
    """Log-probs of this rank's data shard of ``x``, without autograd."""
    model = _model(grid, kind, state, flash, bf16)
    with torch.no_grad():
        return _forward(grid, kind, flash, impl)(model, shard_rows(grid, x)).numpy()


def grads(grid, kind: str, state: dict, x: np.ndarray, y: np.ndarray, w: np.ndarray,
          impl: str = "ring", flash: bool = False) -> dict:
    """The step's gradients (``make_forward_grads``: after the sum over
    the data x seq ranks) of this rank's shard, by leaf."""
    model = _model(grid, kind, state, flash)
    fn = make_forward_grads(_forward(grid, kind, flash, impl), grid)
    _, g = fn(model, shard_rows(grid, x), shard_rows(grid, y), shard_rows(grid, w))
    return {k: v.numpy().copy() for k, v in g.items()}


def evaluate(grid, kind: str, state: dict, x: np.ndarray, y: np.ndarray, w: np.ndarray,
             impl: str = "ring", flash: bool = False) -> np.ndarray:
    """The eval step's totals over this rank's data group."""
    model = _model(grid, kind, state, flash)
    fn = make_forward_eval_step(_forward(grid, kind, flash, impl), grid.data)
    totals = fn(model, shard_rows(grid, x), shard_rows(grid, y), shard_rows(grid, w))
    return np.asarray([float(t) for t in totals])


def save(grid, kind: str, state: dict, path: str) -> None:
    """The model sharded as ``kind`` shards it, gathered and written by
    rank 0 as ``vit_mnist --save-model`` writes it."""
    model = _model(grid, kind, state)
    full = _full_state(grid, kind, model)
    if grid.coords == (0, 0, 0):
        save_params_tree(jax_vit_tree_from_torch(
            {k: torch.from_numpy(v) for k, v in full.items()}), path)


def attention(grid, q: np.ndarray, k: np.ndarray, v: np.ndarray, fn: str,
              flash: bool = False) -> dict:
    """``fn`` (``ring_attention``, ``ring_attention_flash`` or
    ``ulysses_attention``) on this seq member's token block of the global
    ``[b, T, h, d]`` q/k/v, with autograd: the output block and the
    gradients of q, k and v (of ``sum(out * cot)``, cot the block of
    ``k`` read as a cotangent)."""
    t = q.shape[1] // grid.seq.size
    tokens = slice(grid.seq.rank * t, (grid.seq.rank + 1) * t)
    local = [torch.from_numpy(np.ascontiguousarray(a[:, tokens])).requires_grad_()
             for a in (q, k, v)]
    extra = {"use_flash": flash} if fn == "ulysses_attention" else {}
    out = getattr(sp, fn)(*local, grid.seq, **extra)
    (out * torch.from_numpy(np.ascontiguousarray(k[:, tokens]))).sum().backward()
    return {"out": out.detach().numpy(), "dq": local[0].grad.numpy(),
            "dk": local[1].grad.numpy(), "dv": local[2].grad.numpy()}


# -- the grid, the shards and the data shards, without a world ---------------------


@pytest.mark.parametrize("shape", [(1, 2, 1), (2, 2, 1), (1, 4, 1), (2, 1, 2), (1, 2, 2),
                                   (2, 2, 2)])
def test_grid_is_jax_row_major_device_order(shape):
    """Rank r sits where np.reshape puts device r on a (D, S, M) mesh, and
    every group lists each rank once per axis."""
    order = np.arange(int(np.prod(shape))).reshape(shape)
    for r in range(order.size):
        assert grid_rank(*grid_coords(r, shape), shape) == r
        assert order[grid_coords(r, shape)] == r
    groups = _members(shape)
    for axis, size in (("data", shape[0]), ("seq", shape[1]), ("model", shape[2])):
        assert sorted(r for g in groups[axis] for r in g) == list(range(order.size))
        assert all(len(g) == size for g in groups[axis])
    assert [tuple(g) for g in groups["seq"]] == [tuple(order[i, :, j])
                                                for i in range(shape[0]) for j in range(shape[2])]
    # the gradient group: the ranks of one model coordinate, data then seq
    assert [tuple(g) for g in groups["grad"]] == [tuple(order[..., j].reshape(-1))
                                                 for j in range(shape[2])]
    assert grid_shape([("seq", shape[1]), ("model", shape[2])], order.size) == shape


def test_world_of_one_grid_has_no_process_group():
    grid = make_rank_grid([("seq", 1), ("model", 1)])
    assert grid.shape == (1, 1, 1) and grid.num_data == 1
    assert all(g.pg is None and g.size == 1 for g in (grid.data, grid.seq, grid.model, grid.grad))


@pytest.mark.parametrize("count", [1, 2, 4])
def test_vit_state_shards_gather_back(count):
    state = ViT(generator=torch.Generator().manual_seed(2)).state_dict()
    shards = [shard_vit_state(state, i, count) for i in range(count)]
    whole = gather_vit_state(shards)
    assert list(whole) == list(state)
    assert all(torch.equal(whole[k], state[k]) for k in state)
    # qkv's shard holds whole heads: rows (heads/count) * 3 * head_dim
    cfg = ViTConfig()
    assert shards[-1]["blocks.1.qkv.weight"].shape == (3 * cfg.dim // count, cfg.dim)
    assert shards[-1]["blocks.0.mlp_out.weight"].shape == (cfg.dim, cfg.mlp_dim // count)
    assert shards[-1]["blocks.0.proj.bias"].shape == (cfg.dim,)


@pytest.mark.parametrize("n, batch, shards", [(203, 24, 3), (10, 8, 3), (640, 64, 2)])
def test_data_shards_cut_each_global_batch(n, batch, shards):
    """Shard d yields rows d*b.. of each global batch of the epoch's
    permutation, padding (weight 0) past its end; together the shards are
    the one-shard loader at the global batch."""
    images = np.random.RandomState(0).randint(0, 255, (n, 28, 28)).astype(np.uint8)
    labels = np.arange(n) % 10
    cpu = torch.device("cpu")
    whole = DataLoader(images, labels, batch * shards, cpu, seed=3)
    parts = [DataLoader(images, labels, batch, cpu, seed=3, shard=s, num_shards=shards)
             for s in range(shards)]
    assert all(len(p) == len(whole) == -(-n // (batch * shards)) for p in parts)
    assert all(p.global_batch == batch * shards for p in parts)
    for got, want in zip(zip(*(p.epoch(2) for p in parts)), whole.epoch(2)):
        for i in range(3):
            assert torch.equal(torch.cat([g[i] for g in got]), want[i])
