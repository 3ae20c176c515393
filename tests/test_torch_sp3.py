"""The port's 3-D ViT parallelism (``--sp --tp``) held against the JAX
package on the CPU: a (data, seq, model) = (1, 2, 2) grid of four gloo
ranks (``tests/test_torch_vit_ranks.py``) against JAX's ``make_sp3_*``
on a mesh of the same shape, same weights and inputs.  Gates as in
``tests/test_torch_sp.py``, the gradients of single leaves as in
``tests/test_torch_tp_vit.py``.
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
from pytorch_mnist_ddp_tpu.parallel import sp3 as jax_sp3
from pytorch_mnist_ddp_tpu.parallel import tp_vit as jax_tp
from pytorch_mnist_ddp_tpu.utils.jax_compat import shard_map
from pytorch_mnist_ddp_tpu_torch.utils.convert import shard_vit_state, torch_vit_state_from_jax
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
from test_torch_tp_vit import GRAD_LEAVES
from test_torch_vit_ranks import grid_tasks

SHAPE = (1, 2, 2)
LEGS = {"sp3": False, "sp3_flash": True}


def _mesh():
    return jax_sp3.make_3d_mesh(*SHAPE, devices=jax.devices()[:4])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    state = _state(_params())
    x, y, w = _eval_batch(1)
    tasks = [("forward", "forward", dict(kind="sp3", state=state, x=x)),
             ("eval", "evaluate", dict(kind="sp3", state=state, x=x, y=y, w=w))]
    tasks += [(f"traj_{leg}", "trajectory",
               dict(kind="sp3", state=state, batches=_batches(1), flash=flash))
              for leg, flash in LEGS.items()]
    xs, ys, ws = _batches(1)
    tasks.append(("grads", "grads", dict(kind="sp3", state=state, x=xs[-1], y=ys[-1], w=ws[-1])))
    out = run_world(grid_tasks, 4, tmp_path_factory.mktemp("sp3"),
                    [("seq", 2), ("model", 2)], tasks)
    assert [r["coords"] for r in out] == [(0, s, m) for s in range(2) for m in range(2)]
    return out


def _placed():
    cfg = jvit.ViTConfig()
    return jax_sp3.shard_sp3_state(jax_ddp.make_train_state(_params()), _mesh(), cfg)


def test_sp3_forward_logits_match_jax(ranks):
    cfg = jvit.ViTConfig()
    x, _, _ = _eval_batch(1)
    fwd = jax.jit(shard_map(lambda p, x: jax_sp3._sp3_vit_forward(p, x, cfg), mesh=_mesh(),
                            in_specs=(jax_tp.vit_tp_param_specs(cfg), P("data")),
                            out_specs=P("data")))
    want = np.asarray(fwd(_placed().params, jnp.asarray(x)))
    for r in ranks:
        np.testing.assert_allclose(r["forward"], want, **LOGP_TOL)
        assert np.array_equal(r["forward"].argmax(1), want.argmax(1))


@pytest.mark.parametrize("leg", list(LEGS))
def test_sp3_trajectory_matches_jax(ranks, leg):
    """8 steps at lr 1.0: the ring inside each model shard's heads, the
    head counted once over seq, the gradient sum over seq only."""
    cfg = jvit.ViTConfig()
    step = jax_sp3.make_sp3_train_step(_mesh(), cfg, use_flash=LEGS[leg])
    state = _placed()
    losses = []
    for x, y, w in zip(*_batches(1)):
        state, per_shard = step(state, jnp.asarray(x), jnp.asarray(y, jnp.int32),
                                jnp.asarray(w), jnp.float32(1.0))
        losses.append(np.asarray(per_shard))
    jlosses = np.stack(losses)
    jstate = torch_vit_state_from_jax(jax.device_get(state.params))
    key = f"traj_{leg}"
    for r in ranks:
        assert r[key]["step"] == STEPS
        np.testing.assert_allclose(r[key]["losses"], jlosses[:, 0], **LOSS_TOL)
        for k, want in jstate.items():
            np.testing.assert_allclose(r[key]["state"][k], want.numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)
    assert all(r[key]["replicated"] == ranks[0][key]["replicated"] for r in ranks)
    for m in range(2):
        same = [r[key]["local"] for r in ranks if r["coords"][2] == m]
        assert same[0] == same[1]


def test_sp3_eval_totals_match_jax(ranks):
    cfg = jvit.ViTConfig()
    x, y, w = _eval_batch(1)
    want = np.asarray(jax_sp3.make_sp3_eval_step(_mesh(), cfg)(
        _placed().params, jnp.asarray(x), jnp.asarray(y, jnp.int32), jnp.asarray(w)))
    for r in ranks:
        np.testing.assert_allclose(r["eval"][0], want[0], rtol=1e-5)
        assert r["eval"][1] == want[1]


@pytest.mark.parametrize("leaf", GRAD_LEAVES)
def test_replicated_and_sharded_gradients_match_jax_on_their_own(ranks, leaf):
    """Trap A over both minor axes: the head after the pool's sum over
    seq, the replicated leaves around the Megatron pairs of the model
    group, and the sharded ones, each leaf on its own against the JAX 3-D
    step's gradient under shard_map (a sharded leaf: this member's
    slice)."""
    cfg = jvit.ViTConfig()
    want = jax_grads(lambda p, x: jax_sp3._sp3_vit_forward(p, x, cfg), _mesh(),
                     jax_tp.vit_tp_param_specs(cfg), *(a[-1] for a in _batches(1)))
    for r in ranks:
        mine = shard_vit_state({leaf: torch.from_numpy(want[leaf])}, r["coords"][2], 2)[leaf]
        assert_grad_leaf(r["grads"][leaf], mine.numpy(), (r["coords"], leaf))
