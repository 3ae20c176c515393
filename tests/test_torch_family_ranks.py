"""The rank programs of the gloo worlds that hold the port's ``--experts``,
``--zero``, the ViT's and the CNN's ``--pp``, the CNN's ``--tp`` and
``--resume-reshard`` against the JAX package, and the checks of those
modes that need no JAX.

:func:`fused_epoch_ranks` is ``tests/test_torch_fused.py``'s rank program,
:func:`fused_vit_ranks` ``tests/test_torch_fused_vit.py``'s.
``tests/test_torch_ep.py``, ``test_torch_zero.py``,
``test_torch_pp_vit.py``, ``test_torch_cnn_mp.py`` and
``test_torch_elastic.py`` run :func:`family_tasks` on every rank of a
world (``test_torch_launch.run_world``).  This file imports no JAX, so
that each rank starts in seconds.  A task is ``(name, function, minors,
kwargs)``: the rank's grid for ``minors`` (``[]`` lays every rank on the
data axis, ``[("model", S)]`` the pipeline's stages), then the function
of this module on it; a rank returns ``{name: result}``.  Inputs are
global numpy arrays; each rank takes its data shard's rows.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu_torch.data.loader import DataLoader
from pytorch_mnist_ddp_tpu_torch.models.net import Net
from pytorch_mnist_ddp_tpu_torch.models.vit import ViT, ViTConfig
from pytorch_mnist_ddp_tpu_torch.ops.adadelta import AdadeltaState, adadelta_init
from pytorch_mnist_ddp_tpu_torch.ops.flash_attention import select_attention
from pytorch_mnist_ddp_tpu_torch.parallel import ep, fused, fused_vit, mesh, pp, pp_vit, tp
from pytorch_mnist_ddp_tpu_torch.parallel.ddp import (
    TrainState,
    make_eval_step,
    make_forward_eval_step,
    make_forward_grads,
    make_forward_train_step,
    make_train_state,
    make_train_step,
)
from pytorch_mnist_ddp_tpu_torch.parallel.mesh import make_rank_grid, world_group
from pytorch_mnist_ddp_tpu_torch.parallel.zero import (
    per_leaf_opt_to_zero,
    zero_chunk,
    zero_init,
    zero_opt_to_per_leaf,
)
from pytorch_mnist_ddp_tpu_torch.utils.checkpoint import save_params_tree
from pytorch_mnist_ddp_tpu_torch.utils.rng import split_streams
from pytorch_mnist_ddp_tpu_torch.utils.convert import (
    ep_split_dim,
    gather_vit_state,
    jax_vit_tree_from_torch,
    shard_vit_state,
)

MOE = ViTConfig(num_experts=8)

# -- the rank programs ------------------------------------------------------------


def family_tasks(world, tasks: list) -> dict:
    """Every task on this rank, each on its own grid."""
    out = {"rank": world.rank}
    for name, fn, minors, kwargs in tasks:
        grid = make_rank_grid(minors, world)
        out[name] = globals()[fn](grid, **kwargs)
    return out


def fused_epoch_ranks(world, state: dict, images: np.ndarray, labels: np.ndarray,
                      perm: np.ndarray, batch: int, epoch: int, runs: tuple) -> dict:
    """For each ``(name, pallas_opt, zero)`` of ``runs``: the CNN from
    ``state`` through one fused epoch of this rank (``parallel/fused.py``)
    on ``perm`` in JAX's layout, ``batch`` rows a rank, dropout off, lr
    1.0.  Returns per run the gathered losses, the step and the state."""
    torch.set_num_threads(1)
    out = {}
    for name, pallas_opt, zero in runs:
        model = _cnn(state)
        train_state = make_train_state(model, use_pallas=pallas_opt, zero=zero, world=world)
        loader = DataLoader(images, labels, batch, "cpu", rank=world.rank,
                            world_size=world.world_size)
        run = fused.FusedEpoch(model, train_state, loader, dropout=False,
                               use_pallas=pallas_opt, world=world)
        losses = run.epoch(epoch, 1.0, perm=perm)
        out[name] = {"losses": losses.numpy(), "step": train_state.step,
                     "state": {k: v.detach().clone() for k, v in model.state_dict().items()}}
    return out


def fused_vit_ranks(world, state: dict, cfg: dict, train: tuple, test: tuple, perms: list,
                    batch: int, lrs: list) -> dict:
    """The ViT ``ViTConfig(**cfg)`` from ``state`` through the fused run of
    ``parallel/fused_vit.py`` on this rank, every rank on the data axis
    (``--fused``), plain and with ZeRO-1 accumulators (``--zero``): epoch
    e + 1 on ``perms[e]`` in JAX's layout at ``lrs[e]``, ``batch`` rows a
    rank, each followed by the evaluation.  Returns per run the gathered
    losses ``[epochs, steps, ranks]``, the eval totals ``[epochs, 2]``,
    the step and the state."""
    torch.set_num_threads(1)
    grid = make_rank_grid([], world)
    out = {}
    for name in ("plain", "zero"):
        model = _vit(state, ViTConfig(**cfg))
        params = dict(model.named_parameters())
        opt = zero_init(params, grid.data) if name == "zero" else adadelta_init(params)
        train_state = TrainState(opt=opt)
        shard = {"shard": grid.coords[0], "num_shards": grid.num_data}
        run = fused_vit.make_fused_vit_run(
            model, train_state, DataLoader(*train, batch, "cpu", **shard),
            DataLoader(*test, batch, "cpu", shuffle=False, mask_padding=True, **shard), grid)
        losses, evals = [], []
        for e, (perm, lr) in enumerate(zip(perms, lrs), start=1):
            losses.append(run.train.epoch(e, lr, perm=perm).numpy())
            evals.append(fused.eval_totals(run.eval(model).numpy()))
        out[name] = {"losses": np.stack(losses), "evals": np.asarray(evals),
                     "step": train_state.step,
                     "state": {k: v.detach().clone() for k, v in model.state_dict().items()}}
    return out


def shard_rows(grid, a: np.ndarray) -> torch.Tensor:
    """This rank's data shard of a global batch (rows d*b onward)."""
    b = len(a) // grid.num_data
    d = grid.coords[0]
    return torch.from_numpy(np.ascontiguousarray(a[d * b:(d + 1) * b]))


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def _vit(state: dict, cfg: ViTConfig, flash: bool = False) -> ViT:
    model = ViT(cfg, select_attention(flash))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return model


def _step_and_state(grid, mode: str, model: ViT, num_micro: int):
    cfg = model.cfg
    if mode == "ep":
        ep.shard_ep(model, grid.data)
        return ep.make_ep_train_step(cfg, grid), TrainState(
            opt=adadelta_init(dict(model.named_parameters())))
    if mode == "zero":
        return make_forward_train_step(lambda m, x: m(x), grid=grid), TrainState(
            opt=zero_init(dict(model.named_parameters()), grid.data))
    return pp_vit.make_vit_pp_train_step(cfg, grid, num_micro), TrainState(
        opt=adadelta_init(dict(model.named_parameters())))


def vit_trajectory(grid, mode: str, state: dict, batches: tuple, cfg: dict,
                   flash: bool = False, num_micro: int = 2) -> dict:
    """``mode`` (``ep``, ``zero`` or ``pp``) on this rank's shard of every
    global batch ``(xs, ys, ws)`` at lr 1.0: the losses, after every step
    a digest of the leaves every rank holds whole, the final state
    gathered whole, and the host-staged sends."""
    model = _vit(state, ViTConfig(**cfg), flash)
    step, train_state = _step_and_state(grid, mode, model, num_micro)
    staged = mesh.STAGED["calls"]
    losses, replicated = [], []
    for x, y, w in zip(*batches):
        loss = step(model, train_state, shard_rows(grid, x), shard_rows(grid, y),
                    shard_rows(grid, w), 1.0)
        losses.append(float(loss))
        replicated.append(_digest(p for k, p in model.named_parameters()
                                  if ep_split_dim(k) is None))
    full = ep.gather_ep_state(model, grid.data) if mode == "ep" else model.state_dict()
    return {"losses": np.asarray(losses), "replicated": replicated, "step": train_state.step,
            "state": {k: v.detach().numpy().copy() for k, v in full.items()},
            "staged": mesh.STAGED["calls"] - staged}


def ep_grads(grid, state: dict, x: np.ndarray, y: np.ndarray, w: np.ndarray,
             bf16: bool = False) -> dict:
    """The EP step's gradients of this rank's leaves (its expert blocks),
    after the sum over the data group and the division by its size."""
    model = _vit(state, ViTConfig(num_experts=8, bf16=bf16))
    ep.shard_ep(model, grid.data)
    fn = make_forward_grads(ep.ep_train_forward(grid.data), grid, sharded=ep.is_expert_leaf)
    _, g = fn(model, shard_rows(grid, x), shard_rows(grid, y), shard_rows(grid, w))
    return {k: v.numpy().copy() for k, v in g.items()}


def ep_forward(grid, state: dict, x: np.ndarray, flash: bool = False) -> dict:
    """Log-probs and aux of this rank's rows through the EP forward."""
    model = _vit(state, MOE, flash)
    ep.shard_ep(model, grid.data)
    with torch.no_grad():
        logp, aux = ep.ep_vit_forward(model, shard_rows(grid, x), grid.data, flash)
    return {"logp": logp.numpy(), "aux": float(aux)}


def evaluate(grid, mode: str, state: dict, x: np.ndarray, y: np.ndarray, w: np.ndarray,
             cfg: dict) -> np.ndarray:
    """The mode's eval step totals over this rank's data group."""
    model = _vit(state, ViTConfig(**cfg))
    if mode == "ep":
        ep.shard_ep(model, grid.data)
        fn = ep.make_ep_eval_step(model.cfg, grid)
    else:
        fn = make_forward_eval_step(lambda m, x: m(x), grid.data)
    totals = fn(model, shard_rows(grid, x), shard_rows(grid, y), shard_rows(grid, w))
    return np.asarray([float(t) for t in totals])


def ep_save(grid, state: dict, path: str) -> None:
    """``vit_mnist --experts 8 --save-model``'s archive: the expert
    blocks gathered, written by rank 0."""
    model = _vit(state, MOE)
    ep.shard_ep(model, grid.data)
    full = ep.gather_ep_state(model, grid.data)
    if grid.coords == (0, 0, 0):
        save_params_tree(jax_vit_tree_from_torch(full), path)


def cnn_trajectory(grid, state: dict, batches: tuple, zero: bool, syncbn: bool) -> dict:
    """``mnist_ddp``'s step (dropout off) on this rank's rows, with ZeRO-1
    or replicated accumulators: losses, a digest after every step, the
    final state, and the accumulators per leaf (gathered under ZeRO)."""
    world = _world(grid)
    net = Net(use_bn=syncbn)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()
                         if syncbn or not k.startswith("bn")})
    train_state = make_train_state(net, zero=zero, world=world)
    step = make_train_step(dropout=False, world=world)
    losses, digests = [], []
    for x, y, w in zip(*batches):
        losses.append(float(step(net, train_state, shard_rows(grid, x), shard_rows(grid, y),
                                 shard_rows(grid, w), 1.0)))
        digests.append(_digest(net.state_dict().values()))
    params = dict(net.named_parameters())
    opt = (zero_opt_to_per_leaf(train_state.opt, params, grid.data) if zero
           else train_state.opt)
    return {"losses": np.asarray(losses), "digests": digests,
            "chunk": int(train_state.opt.square_avg.numel()) if zero else None,
            "state": {k: v.detach().numpy().copy() for k, v in net.state_dict().items()},
            "opt": [{k: v.numpy().copy() for k, v in tree.items()} for tree in opt]}


def zero_round_trip(grid, shapes: dict) -> dict:
    """Per-leaf accumulators -> this rank's chunks -> gathered per leaf."""
    rng = np.random.RandomState(3)
    trees = [{k: torch.from_numpy(rng.rand(*s).astype(np.float32)) for k, s in shapes.items()}
             for _ in range(2)]
    zero = per_leaf_opt_to_zero(AdadeltaState(*trees), grid.data)
    back = zero_opt_to_per_leaf(zero, trees[0], grid.data)
    return {"equal": all(torch.equal(a[k], b[k]) for a, b in zip(trees, back) for k in a),
            "chunk": int(zero.square_avg.numel())}


def cnn_fit(grid, flags: list, data_dir: str) -> str:
    """``mnist_ddp``'s run (the trainer's body, on this world) for
    ``flags`` on the IDX files in ``data_dir``; returns rank 0's lines."""
    import contextlib
    import io
    import os

    from pytorch_mnist_ddp_tpu_torch.mnist_ddp import build_parser
    from pytorch_mnist_ddp_tpu_torch.trainer import _fit

    os.environ["MNIST_DATA_DIR"] = data_dir
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        _fit(build_parser().parse_args(["--no-cuda", *flags]), "cpu", None, None, _world(grid))
    return out.getvalue()


def cnn_eval(grid, state: dict, x: np.ndarray, y: np.ndarray, w: np.ndarray) -> np.ndarray:
    net = Net()
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    totals = make_eval_step(world=_world(grid))(net, shard_rows(grid, x), shard_rows(grid, y),
                                                 shard_rows(grid, w))
    return np.asarray([float(t) for t in totals])


def _cnn(state: dict) -> Net:
    net = Net()
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return net


def cnn_mp_grads(grid, mode: str, state: dict, x: np.ndarray, y: np.ndarray,
                 w: np.ndarray) -> dict:
    """The ``--tp`` (``mode`` ``tp``, the model cut to this member's
    shards) or ``--pp`` step's loss and gradients on this rank, dropout
    off, before the update."""
    net = _cnn(state)
    if mode == "tp":
        tp.shard_state(net, grid.model)
        fn = tp.make_tp_grads(grid, dropout=False)
    else:
        fn = pp.make_pp_grads(grid, dropout=False)
    loss, g = fn(net, shard_rows(grid, x), shard_rows(grid, y), shard_rows(grid, w), 0)
    return {"loss": float(loss), "grads": {k: v.numpy().copy() for k, v in g.items()}}


def cnn_mp_trajectory(grid, mode: str, state: dict, batches: tuple, bf16: bool = False,
                      num_micro: int = 2) -> dict:
    """``mnist_ddp --tp``/``--pp`` steps (dropout off) on this rank's data
    shard of every global batch at lr 1.0: the losses, a digest of the
    leaves every rank holds whole after every step, and the final state
    (gathered under ``--tp``)."""
    net = _cnn(state)
    dtype = torch.bfloat16 if bf16 else torch.float32
    if mode == "tp":
        tp.shard_state(net, grid.model)
        step = tp.make_tp_train_step(grid, dropout=False, compute_dtype=dtype)
    else:
        step = pp.make_pp_train_step(grid, num_micro, dropout=False, compute_dtype=dtype)
    train_state = TrainState(opt=adadelta_init(dict(net.named_parameters())))
    losses, replicated = [], []
    for x, y, w in zip(*batches):
        losses.append(float(step(net, train_state, shard_rows(grid, x), shard_rows(grid, y),
                                 shard_rows(grid, w), 1.0)))
        replicated.append(_digest(p for k, p in net.named_parameters()
                                  if tp.split_dim(k) is None))
    full = tp.gather_replicated(net, grid.model) if mode == "tp" else net.state_dict()
    return {"losses": np.asarray(losses), "replicated": replicated, "step": train_state.step,
            "state": {k: v.detach().numpy().copy() for k, v in full.items()}}


def cnn_mp_eval(grid, mode: str, state: dict, x: np.ndarray, y: np.ndarray,
                w: np.ndarray) -> np.ndarray:
    """The ``--tp`` (sharded) or ``--pp`` (plain forward) eval totals over
    this rank's data group."""
    net = _cnn(state)
    if mode == "tp":
        tp.shard_state(net, grid.model)
        fn = tp.make_tp_eval_step(grid)
    else:
        fn = make_forward_eval_step(lambda m, x: m(x), grid.data)
    totals = fn(net, shard_rows(grid, x), shard_rows(grid, y), shard_rows(grid, w))
    return np.asarray([float(t) for t in totals])


def cnn_fit_saved(grid, flags: list, data_dir: str, save_path: str) -> dict:
    """``mnist_ddp`` (the trainer's body) for ``flags`` with
    ``--save-model`` into ``save_path``; rank 0's lines and the final model
    gathered whole here (under ``--tp``, collective)."""
    import contextlib
    import io
    import os

    from pytorch_mnist_ddp_tpu_torch.mnist_ddp import build_parser
    from pytorch_mnist_ddp_tpu_torch.trainer import _fit

    os.environ["MNIST_DATA_DIR"] = data_dir
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        net, _ = _fit(build_parser().parse_args(["--no-cuda", "--save-model", *flags]), "cpu",
                      save_path, None, _world(grid))
    full = tp.gather_replicated(net, grid.model)
    return {"lines": out.getvalue(), "state": {k: v.numpy().copy() for k, v in full.items()}}


def cnn_mid_epoch(grid, flags: list, data_dir: str, cursor: int, path: str) -> dict:
    """``mnist_ddp``'s data-parallel steps (dropout off) over epoch 1 of
    the IDX files in ``data_dir`` at ``flags``' batch, with a mid-epoch
    archive written by rank 0 at batch ``cursor`` (the JAX package's
    ``meta.*`` extras, this world's size); returns the final state and
    each batch's sample indices on this rank."""
    import os

    from pytorch_mnist_ddp_tpu_torch.mnist_ddp import build_parser
    from pytorch_mnist_ddp_tpu_torch.parallel.sampler import epoch_indices
    from pytorch_mnist_ddp_tpu_torch.trainer import make_loaders
    from pytorch_mnist_ddp_tpu_torch.utils.checkpoint import save_train_state

    os.environ["MNIST_DATA_DIR"] = data_dir
    args = build_parser().parse_args(["--no-cuda", *flags])
    world = _world(grid)
    net = Net(torch.Generator().manual_seed(split_streams(args.seed)["init"]))
    train_state = make_train_state(net)
    step = make_train_step(dropout=False, world=world)
    train_loader, _ = make_loaders(args, torch.device("cpu"), dist=world)
    for b, (x, y, w) in enumerate(train_loader.epoch(1)):
        if b == cursor and world.is_chief:
            extras = {"epoch_in_progress": 1, "batch_cursor": cursor, "seed": args.seed,
                      "global_batch": train_loader.global_batch, "world_size": world.world_size,
                      "steps_total": train_state.step,
                      "samples_total": train_state.step * train_loader.global_batch}
            save_train_state(dict(net.named_parameters()), train_state.opt, train_state.step,
                             path, epoch=0, extras=extras)
        step(net, train_state, x, y, w, args.lr)
    idx = epoch_indices(len(train_loader.labels), world.world_size, world.rank, 1, args.seed)
    return {"state": {k: v.detach().numpy().copy() for k, v in net.state_dict().items()},
            "indices": idx, "step": train_state.step}


def _world(grid):
    from pytorch_mnist_ddp_tpu_torch.parallel.distributed import DistState

    return DistState(distributed=grid.world.size > 1, rank=grid.world.rank,
                     world_size=grid.world.size)


# -- without a world ------------------------------------------------------------


def test_moe_vit_counts_the_jax_readme_parameters():
    """``--experts 8`` at ViTConfig()'s width: 305,050 parameters, the
    dense ViT's 71,946 with each block's MLP replaced by 8 experts and a
    gate."""
    assert sum(p.numel() for p in ViT(MOE).parameters()) == 305_050
    assert sum(p.numel() for p in ViT(ViTConfig()).parameters()) == 71_946


@pytest.mark.parametrize("count", [1, 2, 4, 8])
def test_expert_shards_gather_back(count):
    state = ViT(MOE, generator=torch.Generator().manual_seed(2)).state_dict()
    shards = [shard_vit_state(state, i, count, ep_split_dim) for i in range(count)]
    whole = gather_vit_state(shards, ep_split_dim)
    assert list(whole) == list(state)
    assert all(torch.equal(whole[k], state[k]) for k in state)
    assert shards[-1]["blocks.1.moe.w_in"].shape == (8 // count, 64, 128)
    assert shards[-1]["blocks.0.moe.b_out"].shape == (8 // count, 64)
    assert shards[-1]["blocks.0.moe.gate.weight"].shape == (8, 64)  # replicated


def test_world_group_of_one_is_the_single_device():
    from pytorch_mnist_ddp_tpu_torch.parallel.distributed import DistState

    group = world_group(DistState())
    assert group.size == 1 and group.pg is None
    assert zero_chunk(71946, 1) == 71946 and zero_chunk(1199882, 4) == 299971
