"""The port's ViT tensor parallelism (``--tp``) held against the JAX
package on the CPU, on the same numpy inputs and weights.

The port's ranks are processes of gloo worlds (``tests/test_torch_vit_ranks.py``
holds their programs), one world per grid shape, (data, model) = (1, 2),
(2, 2) and (1, 4); JAX's are the conftest's virtual CPU devices on meshes
of the same shapes, its ``make_vit_tp_*`` steps on ``shard_vit_tp_state``.
JAX's ``--flash`` runs as its own tests run it off the TPU (under
shard_map, the kernel's dense twin); the port's the kernel's plain
version.  Gates as in ``tests/test_torch_sp.py``: f32 log-probs within
1e-5 with identical argmax; 8-step trajectories within
``tests/test_trajectory.py``'s torch gates (losses rtol 2e-4, atol 2e-5;
parameters atol 5e-3); replicated leaves bit-equal on every rank after
every step, and each shard on the ranks that share it; eval totals, the
count exactly and the loss sum within rtol 1e-5; the gradients of
replicated and sharded leaves on their own within 1e-5 relative of JAX's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pytorch_mnist_ddp_tpu.models import vit as jvit
from pytorch_mnist_ddp_tpu.parallel import ddp as jax_ddp
from pytorch_mnist_ddp_tpu.parallel import tp_vit as jax_tp
from pytorch_mnist_ddp_tpu.parallel.mesh import make_mesh
from pytorch_mnist_ddp_tpu.utils import checkpoint as jax_checkpoint
from pytorch_mnist_ddp_tpu.utils.jax_compat import shard_map
from pytorch_mnist_ddp_tpu_torch.parallel.tp_vit import check_head_divisibility
from pytorch_mnist_ddp_tpu_torch.utils.convert import (
    jax_vit_tree_from_torch,
    shard_vit_state,
    torch_vit_state_from_jax,
)
from test_torch_launch import run_world
from test_torch_sp import (
    LOGP_TOL,
    LOSS_TOL,
    PARAM_ATOL,
    STEPS,
    _batches,
    _eval_batch,
    _params,
    _state,
    assert_grad_leaf,
    jax_grads,
)
from test_torch_vit_ranks import grid_tasks

SHAPES = {(1, 2): 2, (2, 2): 4, (1, 4): 4}
LEGS = {"tp": False, "tp_flash": True}


def _mesh(num_data, num_model):
    return make_mesh(num_data, num_model, devices=jax.devices()[:num_data * num_model])


def _tasks(shape, save_dir):
    num_data, num_model = shape
    state = _state(_params())
    x, y, w = _eval_batch(num_data)
    tasks = [("forward", "forward", dict(kind="tp", state=state, x=x))]
    if shape == (1, 4):
        return tasks
    tasks += [(f"traj_{leg}", "trajectory",
               dict(kind="tp", state=state, batches=_batches(num_data), flash=flash))
              for leg, flash in LEGS.items()]
    tasks.append(("eval", "evaluate", dict(kind="tp", state=state, x=x, y=y, w=w)))
    if shape == (1, 2):
        xs, ys, ws = _batches(1)
        tasks += [("save", "save", dict(kind="tp", state=state,
                                        path=str(save_dir / "vit_mnist.npz"))),
                  ("grads", "grads", dict(kind="tp", state=state, x=xs[-1], y=ys[-1], w=ws[-1]))]
    return tasks


@pytest.fixture(scope="module")
def save_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("tp_save")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, save_dir):
    return {shape: run_world(grid_tasks, n, tmp_path_factory.mktemp(f"tp{shape[0]}x{shape[1]}"),
                             [("model", shape[1])], _tasks(shape, save_dir))
            for shape, n in SHAPES.items()}


def _ranks(worlds, shape):
    ranks = worlds[shape]
    num_data, num_model = shape
    assert [r["coords"] for r in ranks] == [(d, 0, m) for d in range(num_data)
                                            for m in range(num_model)]
    return ranks


@pytest.mark.parametrize("num_model", [2, 4])
def test_tp_forward_logits_match_jax(worlds, num_model):
    cfg = jvit.ViTConfig()
    mesh = _mesh(1, num_model)
    x, _, _ = _eval_batch(1)
    params = jax_tp.shard_vit_tp_state(jax_ddp.make_train_state(_params()), mesh, cfg).params
    fwd = jax.jit(shard_map(lambda p, x: jax_tp._tp_vit_forward(p, x, cfg), mesh=mesh,
                            in_specs=(jax_tp.vit_tp_param_specs(cfg), P("data")),
                            out_specs=P("data")))
    want = np.asarray(fwd(params, jnp.asarray(x)))
    for r in _ranks(worlds, (1, num_model)):
        np.testing.assert_allclose(r["forward"], want, **LOGP_TOL)
        assert np.array_equal(r["forward"].argmax(1), want.argmax(1))


def _jax_trajectory(shape, flash):
    cfg = jvit.ViTConfig()
    mesh = _mesh(*shape)
    step = jax_tp.make_vit_tp_train_step(mesh, cfg, use_flash=flash)
    state = jax_tp.shard_vit_tp_state(jax_ddp.make_train_state(_params()), mesh, cfg)
    losses = []
    for x, y, w in zip(*_batches(shape[0])):
        state, per_shard = step(state, jnp.asarray(x), jnp.asarray(y, jnp.int32),
                                jnp.asarray(w), jnp.float32(1.0))
        losses.append(np.asarray(per_shard))
    return np.stack(losses), torch_vit_state_from_jax(jax.device_get(state.params))


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("leg", list(LEGS))
def test_tp_trajectory_matches_jax(worlds, shape, leg):
    """8 steps at lr 1.0 on the (data, model) grid against JAX's
    make_vit_tp_train_step; the final state gathered from the shards."""
    jlosses, jstate = _jax_trajectory(shape, LEGS[leg])
    ranks = _ranks(worlds, shape)
    key = f"traj_{leg}"
    for r in ranks:
        np.testing.assert_allclose(r[key]["losses"], jlosses[:, r["coords"][0]], **LOSS_TOL)
        for k, want in jstate.items():
            np.testing.assert_allclose(r[key]["state"][k], want.numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)
        assert r[key]["step"] == STEPS
    # Replicated leaves are equal on every rank, each shard on the ranks of
    # its model coordinate, after every step.
    assert all(r[key]["replicated"] == ranks[0][key]["replicated"] for r in ranks)
    for m in range(shape[1]):
        same = [r[key]["local"] for r in ranks if r["coords"][2] == m]
        assert all(s == same[0] for s in same)
    assert len({r[key]["local"][-1] for r in ranks}) == shape[1]


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_tp_eval_totals_match_jax(worlds, shape):
    cfg = jvit.ViTConfig()
    mesh = _mesh(*shape)
    x, y, w = _eval_batch(shape[0])
    params = jax_tp.shard_vit_tp_state(jax_ddp.make_train_state(_params()), mesh, cfg).params
    want = np.asarray(jax_tp.make_vit_tp_eval_step(mesh, cfg)(
        params, jnp.asarray(x), jnp.asarray(y, jnp.int32), jnp.asarray(w)))
    for r in _ranks(worlds, shape):
        np.testing.assert_allclose(r["eval"][0], want[0], rtol=1e-5)
        assert r["eval"][1] == want[1]


# Replicated leaves before, between and after the Megatron pairs (embed, a
# LayerNorm, a row-parallel layer's bias, the head) and sharded ones of a
# column- and a row-parallel layer.
GRAD_LEAVES = ("embed.weight", "blocks.0.ln1.weight", "blocks.1.proj.bias", "ln_f.bias",
               "head.weight", "blocks.0.qkv.weight", "blocks.1.mlp_out.weight")


@pytest.mark.parametrize("leaf", GRAD_LEAVES)
def test_replicated_and_sharded_gradients_match_jax_on_their_own(worlds, leaf):
    """Trap A over the model group: a replicated leaf that every member
    computes alike must not come out M times JAX's, nor a leaf before a
    column-parallel layer miss the other members' shares.  Each leaf on
    its own, on the (1, 2) grid, against the JAX step's gradient under
    shard_map (a sharded leaf: this member's slice of it)."""
    cfg = jvit.ViTConfig()
    want = jax_grads(lambda p, x: jax_tp._tp_vit_forward(p, x, cfg), _mesh(1, 2),
                     jax_tp.vit_tp_param_specs(cfg), *(a[-1] for a in _batches(1)))
    for r in _ranks(worlds, (1, 2)):
        mine = shard_vit_state({leaf: torch.from_numpy(want[leaf])}, r["coords"][2], 2)[leaf]
        assert_grad_leaf(r["grads"][leaf], mine.numpy(), (r["coords"], leaf))


@pytest.mark.parametrize("num_model", [2, 4])
def test_shards_are_the_slices_of_jax_shard_vit_tp_state(num_model):
    """Member m's shard of every leaf, in JAX's layout, is the piece JAX's
    shard_vit_tp_state places on the mesh's model device m."""
    cfg = jvit.ViTConfig()
    mesh = _mesh(1, num_model)
    params = _params()
    placed = jax_tp.shard_vit_tp_state(jax_ddp.make_train_state(params), mesh, cfg).params
    state = {k: v for k, v in torch_vit_state_from_jax(params).items()}
    devices = list(mesh.devices.flat)
    for m in range(num_model):
        mine = jax_vit_tree_from_torch(shard_vit_state(state, m, num_model))
        for path, leaf in jax.tree_util.tree_leaves_with_path(placed):
            piece = next(s for s in leaf.addressable_shards if s.device == devices[m])
            node = mine
            for key in path:
                node = node[key.key]
            assert node.shape == piece.data.shape, path
            assert np.array_equal(node, np.asarray(piece.data)), path


def test_save_model_gathers_jax_params_tree_byte_for_byte(worlds, save_dir):
    """Rank 0's vit_mnist.npz from two model shards is what JAX's CLI
    saves for the same params (a tree as a jitted step returns it, keys
    sorted): the same keys in the same order, dtypes, shapes and bytes."""
    _ranks(worlds, (1, 2))
    want_path = save_dir / "jax.npz"
    jax_checkpoint.save_params_tree(jax.tree.map(np.asarray, _params()), str(want_path))
    with np.load(save_dir / "vit_mnist.npz") as got, np.load(want_path) as want:
        assert list(got.keys()) == list(want.keys())
        for k in want.keys():
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), k


def test_head_divisibility_texts_are_jax():
    for cfg_kwargs, num_model in (({}, 3), ({"heads": 4, "mlp_dim": 130}, 4)):
        port_cfg = jvit.ViTConfig(**cfg_kwargs)
        with pytest.raises(ValueError) as port_err:
            check_head_divisibility(port_cfg, num_model)
        with pytest.raises(ValueError) as jax_err:
            jax_tp._check_head_divisibility(port_cfg, _mesh(1, num_model))
        assert str(port_err.value) == str(jax_err.value)
