"""The port's expert parallelism (``--experts``) held against the JAX
package on the CPU, on the same numpy inputs and weights.

The port's ranks are processes of gloo worlds of 2 and 4
(``tests/test_torch_family_ranks.py`` holds their programs), E = 8
experts, so 4 and 2 a rank; JAX's are 2 and 4 of the conftest's 8 virtual
CPU devices, meshes ``(W, 1)``, fed the ranks' rows in rank order.  Each
rank routes its own rows, so the reference for W ranks is W routing
groups, JAX's shard_map over the same W shards, not the one-device layer.

Gates:
- 8-step trajectories (lr 1.0; the last step's shards carry padding rows)
  within ``tests/test_trajectory.py``'s torch gates: losses rtol 2e-4,
  atol 2e-5, each rank's against its shard's; final parameters atol 5e-3
  (bf16: losses atol 2e-3, parameters 5e-3, ``test_torch_vit.py``'s);
  the leaves every rank holds whole bit-equal after every step;
- single leaves' gradients at step 0 (the gate kernel, an expert stack,
  an attention leaf) within 1e-5 of JAX's shard_map gradient, relative to
  the leaf's largest entry (1.4e-7 to 5.3e-7 measured on the CPU, torch 2.13.0+cpu, jax 0.9.0);
- eval totals: the correct count exactly, the loss sum within rtol 1e-5;
- ``--save-model``'s gathered tree byte-equal to the JAX package's
  archive of the same parameters;
- the divisibility refusals, with JAX's texts.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from pytorch_mnist_ddp_tpu.data import mnist as jax_mnist
from pytorch_mnist_ddp_tpu.data.transforms import normalize as jax_normalize
from pytorch_mnist_ddp_tpu.models import vit as jvit
from pytorch_mnist_ddp_tpu.ops.loss import nll_loss as jax_nll
from pytorch_mnist_ddp_tpu.parallel import ddp as jax_ddp
from pytorch_mnist_ddp_tpu.parallel import ep as jax_ep
from pytorch_mnist_ddp_tpu.parallel.mesh import make_mesh
from pytorch_mnist_ddp_tpu.utils import checkpoint as jax_checkpoint
from pytorch_mnist_ddp_tpu.utils.jax_compat import shard_map
from pytorch_mnist_ddp_tpu_torch.models.vit import ViTConfig
from pytorch_mnist_ddp_tpu_torch.parallel import ep
from pytorch_mnist_ddp_tpu_torch.utils.convert import torch_vit_state_from_jax
from test_torch_family_ranks import family_tasks
from test_torch_launch import run_world

STEPS, B, PAD = 8, 8, 2  # steps; rows per rank a step; the last step's padding rows
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_ATOL = 5e-3
BF16_LOSS_ATOL, BF16_PARAM_ATOL = 2e-3, 5e-3
GRAD_RTOL = 1e-5
JCFG = jvit.ViTConfig(num_experts=8)
MOE = dict(num_experts=8)
LEAVES = ("blocks.0.moe.gate.weight", "blocks.1.moe.w_in", "blocks.0.moe.b_out",
          "blocks.0.qkv.weight", "head.weight")


def _params(seed=9, **cfg):
    return jax.device_get(jvit.init_vit_params(jax.random.PRNGKey(seed), JCFG._replace(**cfg)))


def _state(params):
    return {k: v.numpy() for k, v in torch_vit_state_from_jax(params).items()}


def _batches(n: int):
    images, labels = jax_mnist.synthetic_mnist("train", STEPS * n * B)
    xs = jax_normalize(images).reshape(STEPS, n * B, 28, 28, 1)
    ys = labels.astype(np.int64).reshape(STEPS, n * B)
    ws = np.ones((STEPS, n, B), np.float32)
    ws[-1, :, B - PAD:] = 0.0
    xs[-1].reshape(n, B, 28, 28, 1)[:, B - PAD:] = 0.0
    return xs, ys, ws.reshape(STEPS, n * B)


def _eval_batch(n: int):
    images, labels = jax_mnist.synthetic_mnist("test", n * 12)
    w = np.ones((n, 12), np.float32)
    w[-1, -5:] = 0.0
    return jax_normalize(images), labels.astype(np.int64), w.reshape(-1)


def _tasks(n: int, path: str):
    state = _state(_params())
    batches = _batches(n)
    xs, ys, ws = batches
    x, y, w = _eval_batch(n)
    tasks = [("traj", "vit_trajectory", [], dict(mode="ep", state=state, batches=batches,
                                                 cfg=MOE)),
             ("grads", "ep_grads", [], dict(state=state, x=xs[-1], y=ys[-1], w=ws[-1])),
             ("eval", "evaluate", [], dict(mode="ep", state=state, x=x, y=y, w=w, cfg=MOE))]
    if n == 2:
        tasks += [
            ("traj_flash", "vit_trajectory", [], dict(mode="ep", state=state, batches=batches,
                                                       cfg=MOE, flash=True)),
            ("traj_bf16", "vit_trajectory", [], dict(
                mode="ep", state=state, batches=batches, cfg={**MOE, "bf16": True})),
            ("forward", "ep_forward", [], dict(state=state, x=x)),
            ("save", "ep_save", [], dict(state=state, path=path)),
        ]
    return tasks


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for n in (2, 4):
        tmp = tmp_path_factory.mktemp(f"ep{n}")
        out[n] = run_world(family_tasks, n, tmp, _tasks(n, str(tmp / "port.npz")))
        out[f"path{n}"] = tmp / "port.npz"
    return out


def _mesh(n):
    return make_mesh(num_data=n, devices=jax.devices()[:n])


def _jax_trajectory(n, bf16=False):
    cfg = JCFG._replace(bf16=bf16)
    mesh = _mesh(n)
    step = jax_ep.make_ep_train_step(mesh, cfg)
    state = jax_ep.shard_ep_state(jax_ddp.make_train_state(_params()), mesh, cfg)
    losses = []
    for x, y, w in zip(*_batches(n)):
        state, per_shard = step(state, jnp.asarray(x), jnp.asarray(y, jnp.int32),
                                jnp.asarray(w), jnp.float32(1.0))
        losses.append(np.asarray(per_shard))
    return np.stack(losses), torch_vit_state_from_jax(jax.device_get(state.params))


@pytest.mark.parametrize("n, leg", [(2, "traj"), (4, "traj"), (2, "traj_flash"),
                                    (2, "traj_bf16")])
def test_ep_trajectory_matches_jax(worlds, n, leg):
    bf16 = leg == "traj_bf16"
    jlosses, jstate = _jax_trajectory(n, bf16)
    ranks = worlds[n]
    loss_tol = dict(rtol=0, atol=BF16_LOSS_ATOL) if bf16 else LOSS_TOL
    for r in ranks:
        got = r[leg]
        assert got["step"] == STEPS
        np.testing.assert_allclose(got["losses"], jlosses[:, r["rank"]], err_msg=str(r["rank"]),
                                   **loss_tol)
    first = ranks[0][leg]
    assert all(r[leg]["replicated"] == first["replicated"] for r in ranks)
    assert len(set(first["replicated"])) == STEPS
    for r in ranks:  # every rank gathers the same whole model
        assert all(np.array_equal(r[leg]["state"][k], v) for k, v in first["state"].items())
    for k, want in jstate.items():
        np.testing.assert_allclose(first["state"][k], want.numpy(), rtol=0,
                                   atol=BF16_PARAM_ATOL if bf16 else PARAM_ATOL, err_msg=k)


@functools.lru_cache(maxsize=None)
def _jax_grads(n):
    """JAX's step gradient: the value_and_grad of each shard's objective
    under the EP shard_map (VMA sums the replicated leaves over the data
    axis), divided by the data degree; whole leaves, the port's layout."""
    mesh = _mesh(n)
    specs = jax_ep.ep_param_specs(JCFG)
    xs, ys, ws = _batches(n)

    def local(params, x, y, w):
        def loss_fn(p):
            logp, aux = jvit.vit_moe_forward(
                p, x, JCFG, moe_fn=lambda mp, h: jax_ep.moe_mlp_ep(mp, h, JCFG))
            return jax_nll(logp, y, w, reduction="mean") + jax_ep.AUX_LOSS_WEIGHT * aux

        return jax.tree.map(lambda g: g / n, jax.grad(loss_fn)(params))

    grads = jax.jit(shard_map(local, mesh=mesh, in_specs=(specs, P("data"), P("data"),
                                                          P("data")), out_specs=specs))(
        _params(), jnp.asarray(xs[-1]), jnp.asarray(ys[-1], jnp.int32), jnp.asarray(ws[-1]))
    return {k: v.numpy() for k, v in torch_vit_state_from_jax(jax.device_get(grads)).items()}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("leaf", LEAVES)
def test_single_leaf_gradients_match_jax(worlds, n, leaf):
    """A wrong hop layout still trains (experts see other ranks' tokens),
    a wrong gradient rule makes a leaf W times too large: each leaf on its
    own against JAX's.  Expert leaves are each rank's block, concatenated
    in rank order."""
    want = _jax_grads(n)[leaf]
    ranks = worlds[n]
    if ep.is_expert_leaf(leaf):
        got = np.concatenate([r["grads"][leaf] for r in ranks])
    else:
        got = ranks[0]["grads"][leaf]
        assert all(np.array_equal(r["grads"][leaf], got) for r in ranks)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    print(f"{leaf} at {n} ranks: {err:.2e} of the leaf's largest entry")
    assert err <= GRAD_RTOL, (leaf, err)


@pytest.mark.parametrize("n", [2, 4])
def test_ep_eval_totals_match_jax(worlds, n):
    x, y, w = _eval_batch(n)
    mesh = _mesh(n)
    params = jax_ep.shard_ep_state(jax_ddp.make_train_state(_params()), mesh, JCFG).params
    want = np.asarray(jax_ep.make_ep_eval_step(mesh, JCFG)(
        params, jnp.asarray(x), jnp.asarray(y, jnp.int32), jnp.asarray(w)))
    for r in worlds[n]:
        np.testing.assert_allclose(r["eval"][0], want[0], rtol=1e-5)
        assert r["eval"][1] == want[1]


def test_ep_forward_log_probs_match_jax(worlds):
    """Two routing groups, the all-to-alls real: log-probs within 1e-5 with
    equal argmax, the group-mean aux within 1e-6."""
    x, _, _ = _eval_batch(2)
    mesh = _mesh(2)
    specs = jax_ep.ep_param_specs(JCFG)
    fwd = jax.jit(shard_map(
        lambda p, x: jvit.vit_moe_forward(p, x, JCFG,
                                          moe_fn=lambda mp, h: jax_ep.moe_mlp_ep(mp, h, JCFG)),
        mesh=mesh, in_specs=(specs, P("data")), out_specs=(P("data"), P())))
    logp, aux = fwd(_params(), jnp.asarray(x))
    got = np.concatenate([r["forward"]["logp"] for r in worlds[2]])
    np.testing.assert_allclose(got, np.asarray(logp), rtol=1e-5, atol=1e-5)
    assert np.array_equal(got.argmax(1), np.asarray(logp).argmax(1))
    for r in worlds[2]:
        np.testing.assert_allclose(r["forward"]["aux"], float(aux), rtol=1e-6, atol=1e-6)


def test_save_model_gathers_the_jax_archive(worlds, tmp_path):
    """rank 0's archive of the expert-sharded model is byte for byte the
    JAX package's save_params_tree of the same parameters."""
    jpath = str(tmp_path / "jax.npz")
    jax_checkpoint.save_params_tree(_params(), jpath)
    with np.load(worlds["path2"]) as got, np.load(jpath) as want:
        assert list(got.keys()) == list(want.keys())
        assert all(got[k].tobytes() == want[k].tobytes() and got[k].dtype == want[k].dtype
                   for k in want.keys())


@pytest.mark.parametrize("experts, n", [(6, 4), (8, 3), (0, 2)])
def test_expert_divisibility_refusals_are_jax_texts(experts, n):
    mesh = make_mesh(num_data=n, devices=jax.devices()[:n])
    with pytest.raises(ValueError) as want:
        jax_ep._check_expert_divisibility(JCFG._replace(num_experts=experts), mesh)
    with pytest.raises(ValueError) as got:
        ep.check_expert_divisibility(ViTConfig(num_experts=experts), n)
    assert str(got.value) == str(want.value)
