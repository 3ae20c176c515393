"""The CNN's model-axis modes (``mnist_ddp.py --tp N``, ``--pp``,
``--pp-microbatches``) held against the JAX package on the CPU, and their
refusals against the JAX trainer's.

The port's grids are ranks of one gloo world of 4 (``tests/test_torch_family_ranks.py``
holds the programs): 2 data shards x 2 model members for ``--tp 2`` and 2
data shards x 2 stages for ``--pp``.  JAX's are ``(2, 2)`` meshes of the
conftest's virtual CPU devices.

Gates:
- each rank's gradient leaves, dropout off, within 1e-5 of JAX's
  (``make_tp_train_step``'s / ``make_pp_train_step``'s value_and_grad
  under shard_map), relative to the leaf's largest entry; sharded leaves
  against their slice;
- STEPS-step trajectories (lr 1.0, padding rows in the last step's
  shards) within ``tests/test_trajectory.py``'s gates (losses rtol 2e-4,
  atol 2e-5, each data shard's; parameters atol 5e-3); ``--bf16`` with
  parameters at atol 5e-3 and losses at the repo's bf16 gate (rtol 2^-7,
  atol 2^-8, as the flash kernel's bf16 outputs): after step 1's lr-1.0
  update the losses jump to 3.8-5.3 and read 1.0e-3-3.5e-3 relative
  (``--tp``) and 2.1e-3 (``--pp``) from JAX's, which is as far as JAX's
  own f32 run is from its bf16 one (7.3e-3-7.8e-3); the leaves every rank
  holds whole bit-equal on every rank after every step;
- eval totals: the correct count exactly, the loss sum within rtol 1e-5;
- ``--tp 2 --save-model`` through the trainer writes the gathered state.
"""

from __future__ import annotations

import struct
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pytorch_mnist_ddp_tpu.data import mnist as jax_mnist
from pytorch_mnist_ddp_tpu.data.transforms import normalize as jax_normalize
from pytorch_mnist_ddp_tpu.models.net import init_params
from pytorch_mnist_ddp_tpu.ops.loss import nll_loss as jax_nll
from pytorch_mnist_ddp_tpu.parallel import ddp as jax_ddp
from pytorch_mnist_ddp_tpu.parallel import pp as jax_pp
from pytorch_mnist_ddp_tpu.parallel import tp as jax_tp
from pytorch_mnist_ddp_tpu.parallel.mesh import make_mesh
from pytorch_mnist_ddp_tpu.parallel.pipeline import make_pipeline_loss
from pytorch_mnist_ddp_tpu.utils.jax_compat import shard_map
from pytorch_mnist_ddp_tpu_torch.mnist_ddp import build_parser
from pytorch_mnist_ddp_tpu_torch.parallel import tp
from pytorch_mnist_ddp_tpu_torch.parallel.distributed import DistState
from pytorch_mnist_ddp_tpu_torch.trainer import _model_axis
from pytorch_mnist_ddp_tpu_torch.utils.checkpoint import load_resume_state
from pytorch_mnist_ddp_tpu_torch.utils.convert import torch_state_from_jax
from test_torch_family_ranks import family_tasks
from test_torch_launch import run_world
from test_torch_resume import assert_jax_text
from test_torch_sp import assert_grad_leaf

STEPS, B, PAD = 4, 8, 2  # steps; rows per data shard a step; the last step's padding
NUM_DATA = 2
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_ATOL = 5e-3
BF16_ATOL = 5e-3
BF16_LOSS_TOL = dict(rtol=2.0 ** -7, atol=2.0 ** -8)
LEGS = {"tp": ("tp", False), "tp_bf16": ("tp", True), "pp": ("pp", False),
        "pp_bf16": ("pp", True)}
FIT_LIMIT = 64  # the trainer's run: one step of 2 shards x 32 rows


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread in this module: the suite runs several workers
    at once, and their threads would otherwise contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params():
    return jax.device_get(init_params(jax.random.PRNGKey(5)))


def _state():
    return {k: v.numpy() for k, v in torch_state_from_jax(_params()).items()}


def _batches():
    images, labels = jax_mnist.synthetic_mnist("train", STEPS * NUM_DATA * B)
    xs = jax_normalize(images).reshape(STEPS, NUM_DATA * B, 28, 28, 1)
    ys = labels.astype(np.int64).reshape(STEPS, NUM_DATA * B)
    ws = np.ones((STEPS, NUM_DATA, B), np.float32)
    ws[-1, :, B - PAD:] = 0.0
    xs[-1].reshape(NUM_DATA, B, 28, 28, 1)[:, B - PAD:] = 0.0
    return xs, ys, ws.reshape(STEPS, NUM_DATA * B)


def _eval_batch():
    images, labels = jax_mnist.synthetic_mnist("test", NUM_DATA * 12)
    w = np.ones((NUM_DATA, 12), np.float32)
    w[-1, -5:] = 0.0
    return jax_normalize(images), labels.astype(np.int64), w.reshape(-1)


def _write_idx(root, n: int) -> None:
    for split, prefix in (("train", "train"), ("test", "t10k")):
        images, labels = jax_mnist.synthetic_mnist(split, n)
        (root / f"{prefix}-images-idx3-ubyte").write_bytes(
            struct.pack(">iiii", 2051, *images.shape) + images.tobytes())
        (root / f"{prefix}-labels-idx1-ubyte").write_bytes(
            struct.pack(">ii", 2049, len(labels)) + labels.tobytes())


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every task on one gloo world of 4 ranks."""
    tmp = tmp_path_factory.mktemp("cnn_mp")
    (tmp / "idx").mkdir()
    _write_idx(tmp / "idx", FIT_LIMIT)
    xs, ys, ws = _batches()
    model_axis = [("model", 2)]
    tasks = [(f"grads_{mode}", "cnn_mp_grads", model_axis,
              dict(mode=mode, state=_state(), x=xs[-1], y=ys[-1], w=ws[-1]))
             for mode in ("tp", "pp")]
    tasks += [(leg, "cnn_mp_trajectory", model_axis,
               dict(mode=mode, state=_state(), batches=(xs, ys, ws), bf16=bf16))
              for leg, (mode, bf16) in LEGS.items()]
    tasks += [(f"eval_{mode}", "cnn_mp_eval", model_axis,
               dict(mode=mode, state=_state(), x=e[0], y=e[1], w=e[2]))
              for mode, e in (("tp", _eval_batch()), ("pp", _eval_batch()))]
    tasks.append(("fit_tp", "cnn_fit_saved", model_axis,
                  dict(flags=["--tp", "2", "--epochs", "1", "--batch-size", "32",
                              "--train-limit", str(FIT_LIMIT)],
                       data_dir=str(tmp / "idx"), save_path=str(tmp / "tp.pt"))))
    return run_world(family_tasks, 4, tmp, tasks), tmp


def _mesh():
    return make_mesh(num_data=NUM_DATA, num_model=2, devices=jax.devices()[:4])


def _jax_tp_grads(x, y, w) -> dict:
    def local(p, x, y, w):
        def loss_fn(p):
            return jax_nll(jax_tp._tp_forward(p, x, False, jax.random.PRNGKey(0)), y, w,
                           reduction="mean")

        return jax.tree.map(lambda g: g / NUM_DATA, jax.grad(loss_fn)(p))

    specs = jax_tp.param_specs()
    grads = jax.jit(shard_map(local, mesh=_mesh(),
                              in_specs=(specs, P("data"), P("data"), P("data")),
                              out_specs=specs))(
        _params(), jnp.asarray(x), jnp.asarray(y, jnp.int32), jnp.asarray(w))
    return jax.device_get(grads)


def _jax_pp_grads(x, y, w, num_micro: int = 2) -> dict:
    """``make_pp_train_step``'s local step without the update, dropout off."""
    def stage0(p, x_mb, key, j):
        return jax_pp._stage0_fwd(p, x_mb, key, False)

    def stage1(p, act, y_mb, w_mb, key, j):
        return jax_pp._stage1_loss_sum(p, act, y_mb, w_mb, key, False)

    pipeline_loss = make_pipeline_loss(stage0, stage1, num_micro)

    def local(p, x, y, w):
        mb = x.shape[0] // num_micro
        key = jax.random.PRNGKey(0)
        denom = jnp.maximum(w.sum(), 1.0)

        def loss_fn(p):
            return pipeline_loss(p, x.reshape(num_micro, mb, *x.shape[1:]),
                                 y.reshape(num_micro, mb), w.reshape(num_micro, mb), key) / denom

        return jax.lax.pmean(jax.grad(loss_fn)(p), "data")

    grads = jax.jit(shard_map(local, mesh=_mesh(),
                              in_specs=(P(), P("data"), P("data"), P("data")), out_specs=P(),
                              check_vma=False))(
        _params(), jnp.asarray(x), jnp.asarray(y, jnp.int32), jnp.asarray(w))
    return jax.device_get(grads)


def _by_rank(ranks):
    return {r["rank"]: r for r in ranks[0]}


@pytest.mark.parametrize("mode", ["tp", "pp"])
def test_gradient_leaves_match_jax(ranks, mode):
    """Each rank's gradient of every leaf, on its own, within 1e-5 of
    JAX's: whole leaves, and each ``--tp`` member's slice of the sharded
    ones."""
    xs, ys, ws = _batches()
    jax_fn = _jax_tp_grads if mode == "tp" else _jax_pp_grads
    want = {k: v.numpy() for k, v in torch_state_from_jax(jax_fn(xs[-1], ys[-1], ws[-1])).items()}
    for rank, r in _by_rank(ranks).items():
        got = r[f"grads_{mode}"]["grads"]
        assert sorted(got) == sorted(want)
        for k, g in got.items():
            dim = tp.split_dim(k) if mode == "tp" else None
            w = want[k] if dim is None else np.split(want[k], 2, axis=dim)[rank % 2]
            assert_grad_leaf(g, w, (rank, k))


def _jax_trajectory(mode: str, bf16: bool):
    mesh = _mesh()
    dtype = jnp.bfloat16 if bf16 else jnp.float32
    state = jax_ddp.make_train_state(_params())
    if mode == "tp":
        step = jax_tp.make_tp_train_step(mesh, dropout=False, compute_dtype=dtype)
        state = jax_tp.shard_state(state, mesh)
    else:
        step = jax_pp.make_pp_train_step(mesh, num_micro=2, dropout=False, compute_dtype=dtype)
        state = jax_ddp.replicate_params(state, mesh)
    losses = []
    for x, y, w in zip(*_batches()):
        state, per_shard = step(state, jnp.asarray(x), jnp.asarray(y, jnp.int32),
                                jnp.asarray(w), jax.random.PRNGKey(0), jnp.float32(1.0))
        losses.append(np.asarray(per_shard))
    return np.stack(losses), torch_state_from_jax(jax.device_get(state.params))


@pytest.mark.parametrize("leg", list(LEGS))
def test_trajectory_matches_jax(ranks, leg):
    mode, bf16 = LEGS[leg]
    jlosses, want = _jax_trajectory(mode, bf16)
    loss_tol = BF16_LOSS_TOL if bf16 else LOSS_TOL
    by_rank = _by_rank(ranks)
    for rank, r in by_rank.items():
        got = r[leg]
        assert got["step"] == STEPS
        np.testing.assert_allclose(got["losses"], jlosses[:, rank // 2], err_msg=str(rank),
                                   **loss_tol)
        for k, v in want.items():
            np.testing.assert_allclose(got["state"][k], v.numpy(), rtol=0,
                                       atol=BF16_ATOL if bf16 else PARAM_ATOL, err_msg=k)
    first = by_rank[0][leg]
    assert all(r[leg]["replicated"] == first["replicated"] for r in by_rank.values())
    assert len(set(first["replicated"])) == STEPS
    # both members of a data shard end on the same gathered state
    assert all(np.array_equal(first["state"][k], r[leg]["state"][k])
               for r in by_rank.values() for k in first["state"])


@pytest.mark.parametrize("mode", ["tp", "pp"])
def test_eval_totals_match_jax(ranks, mode):
    x, y, w = _eval_batch()
    mesh = _mesh()
    params = _params()
    if mode == "tp":
        fn = jax_tp.make_tp_eval_step(mesh)
        params = jax_tp.shard_state(jax_ddp.make_train_state(params), mesh).params
    else:
        fn = jax_ddp.make_eval_step(mesh)
        params = jax_ddp.replicate_params(jax_ddp.make_train_state(params), mesh).params
    want = np.asarray(fn(params, jnp.asarray(x), jnp.asarray(y, jnp.int32), jnp.asarray(w)))
    for r in ranks[0]:
        np.testing.assert_allclose(r[f"eval_{mode}"][0], want[0], rtol=1e-5)
        assert r[f"eval_{mode}"][1] == want[1]


def test_tp_save_model_writes_the_gathered_state(ranks):
    """``mnist_ddp --tp 2 --save-model`` on the 4 ranks: one chief's lines
    (one step, 2 shards of 32 rows: 64 samples a step), and the file the
    gathered state under the distributed ``module.`` keys."""
    results, tmp = ranks
    by_rank = {r["rank"]: r for r in results}
    lines = by_rank[0]["fit_tp"]["lines"]
    assert "Train Epoch: 1 [0/64 (0%)]" in lines and "Test set:" in lines
    assert all(r["fit_tp"]["lines"] == "" for k, r in by_rank.items() if k)
    saved = torch.load(tmp / "tp.pt", weights_only=True)
    assert list(saved) == [f"module.{k}" for k in by_rank[0]["fit_tp"]["state"]]
    for k, v in by_rank[0]["fit_tp"]["state"].items():
        assert torch.equal(saved[f"module.{k}"], torch.from_numpy(v)), k
    assert saved["module.fc1.weight"].shape == (128, 9216)
    state, _ = load_resume_state(str(tmp / "tp.pt"), syncbn=False)  # --resume reads it
    assert state["fc2.weight"].shape == (10, 128)


# -- refusals --------------------------------------------------------------------

REFUSED = {
    "tp_and_pp": ["--tp", "2", "--pp"],
    "pallas_opt": ["--tp", "2", "--pallas-opt"],
    "syncbn": ["--pp", "--syncbn"],
    "zero": ["--tp", "2", "--zero"],
    "conv_impl": ["--pp", "--conv-impl", "im2col"],
    "save_state": ["--tp", "2", "--save-state", "s.npz"],
    "resume_state": ["--pp", "--resume-state", "s.npz"],
}


@pytest.mark.parametrize("case", list(REFUSED) + ["world_of_one"])
def test_model_axis_refusals_are_the_jax_trainers(case):
    """Every refusal of trainer.py:406-443 and :477-480 that these flags
    reach, with the JAX trainer's text (read from its source)."""
    if case == "world_of_one":
        args, world = build_parser().parse_args(["--tp", "2"]), DistState()
    else:
        args = build_parser().parse_args(REFUSED[case])
        world = DistState(distributed=True, world_size=4)
    with pytest.raises(ValueError) as err:
        _model_axis(args, world)
    assert_jax_text(str(err.value))
    assert ("--tp/--pp need a multi-device mesh" in str(err.value)) == (case == "world_of_one")


def test_model_axis_takes_tp_and_pp_with_the_jax_defaults():
    args = build_parser().parse_args([])
    assert (args.tp, args.pp, args.pp_microbatches) == (1, False, 2)
    world = DistState(distributed=True, world_size=4)
    assert _model_axis(args, world) == (1, False)
    assert _model_axis(build_parser().parse_args(["--tp", "2", "--bf16"]), world) == (2, False)
    assert _model_axis(build_parser().parse_args(["--pp", "--pp-microbatches", "4"]),
                       world) == (1, True)
    assert _model_axis(types.SimpleNamespace(), DistState()) == (1, False)
