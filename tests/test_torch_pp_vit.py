"""The port's ViT pipeline (``--pp``, ``--pp-microbatches``,
``--pp-stages``) held against the JAX package on the CPU, and the new
modes' flag truth table against the JAX CLI's.

The port's stages are ranks of gloo worlds (``tests/test_torch_family_ranks.py``
holds their programs): 2 ranks as 2 stages, 4 ranks as 2 data shards of
2 stages and as 4 stages; JAX's are meshes ``(D, S)`` of the conftest's
8 virtual CPU devices.

Gates:
- ``stage_bounds`` equal to JAX's ``_stage_bounds`` at depth 1-8, S 2-4;
- 8-step trajectories (lr 1.0, padding rows in the last step's shards)
  at S = 2 with M = 1, 2, 4 microbatches, D x S = 2 x 2, and S = 4 at
  depth 4, within the trajectory gates (losses rtol 2e-4, atol 2e-5, each
  data shard's; parameters atol 5e-3); ``--bf16`` (the boundary in bf16)
  at the bf16 gates (losses atol 2e-3, parameters 5e-3); every rank's
  model bit-equal after every step;
- the loss every stage returns is the last stage's, bit for bit (rank 0,
  stage 0, prints it);
- eval totals: the correct count exactly, the loss sum within rtol 1e-5;
- the guards, with JAX's texts; and every combination of the mode flags
  resolving as the JAX CLI resolves it, or refused with its text.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_mnist as jax_cli  # the JAX package's CLI (no JAX import at module level)
from pytorch_mnist_ddp_tpu.data import mnist as jax_mnist
from pytorch_mnist_ddp_tpu.data.transforms import normalize as jax_normalize
from pytorch_mnist_ddp_tpu.models import vit as jvit
from pytorch_mnist_ddp_tpu.parallel import ddp as jax_ddp
from pytorch_mnist_ddp_tpu.parallel import pp_vit as jax_pp
from pytorch_mnist_ddp_tpu.parallel.mesh import make_mesh
from pytorch_mnist_ddp_tpu_torch import vit_mnist
from pytorch_mnist_ddp_tpu_torch.models.vit import ViT, ViTConfig
from pytorch_mnist_ddp_tpu_torch.parallel import pp_vit
from pytorch_mnist_ddp_tpu_torch.parallel.mesh import Group, RankGrid
from pytorch_mnist_ddp_tpu_torch.utils.convert import torch_vit_state_from_jax
from test_torch_family_ranks import family_tasks
from test_torch_launch import run_world

STEPS, B, PAD = 8, 8, 2  # steps; rows per data shard a step; the last step's padding
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_ATOL = 5e-3
BF16_LOSS_ATOL, BF16_PARAM_ATOL = 2e-3, 5e-3
# leg: (world size, data shards, stages, microbatches, depth, bf16)
LEGS = {"s2_m1": (2, 1, 2, 1, 2, False), "s2_m2": (2, 1, 2, 2, 2, False),
        "s2_m4": (2, 1, 2, 4, 2, False), "bf16_s2_m2": (2, 1, 2, 2, 2, True),
        "d2_s2_m2": (4, 2, 2, 2, 2, False), "s4_depth4": (4, 1, 4, 2, 4, False)}


def _params(depth=2):
    return jax.device_get(jvit.init_vit_params(jax.random.PRNGKey(11),
                                               jvit.ViTConfig(depth=depth)))


def _state(depth=2):
    return {k: v.numpy() for k, v in torch_vit_state_from_jax(_params(depth)).items()}


def _batches(num_data: int):
    images, labels = jax_mnist.synthetic_mnist("train", STEPS * num_data * B)
    xs = jax_normalize(images).reshape(STEPS, num_data * B, 28, 28, 1)
    ys = labels.astype(np.int64).reshape(STEPS, num_data * B)
    ws = np.ones((STEPS, num_data, B), np.float32)
    ws[-1, :, B - PAD:] = 0.0
    xs[-1].reshape(num_data, B, 28, 28, 1)[:, B - PAD:] = 0.0
    return xs, ys, ws.reshape(STEPS, num_data * B)


def _eval_batch(num_data: int):
    images, labels = jax_mnist.synthetic_mnist("test", num_data * 12)
    w = np.ones((num_data, 12), np.float32)
    w[-1, -5:] = 0.0
    return jax_normalize(images), labels.astype(np.int64), w.reshape(-1)


def _tasks(world_size: int):
    tasks = [(leg, "vit_trajectory", [("model", s)],
              dict(mode="pp", state=_state(depth), batches=_batches(d), num_micro=m,
                   cfg=dict(depth=depth, bf16=bf16)))
             for leg, (w, d, s, m, depth, bf16) in LEGS.items() if w == world_size]
    x, y, w = _eval_batch(world_size // 2)
    tasks.append(("eval", "evaluate", [("model", 2)],
                  dict(mode="pp", state=_state(), x=x, y=y, w=w, cfg={})))
    return tasks


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {n: run_world(family_tasks, n, tmp_path_factory.mktemp(f"pp{n}"), _tasks(n))
            for n in (2, 4)}


def _mesh(num_data, num_stages):
    return make_mesh(num_data=num_data, num_model=num_stages,
                     devices=jax.devices()[:num_data * num_stages])


@pytest.mark.parametrize("depth", range(1, 9))
@pytest.mark.parametrize("stages", [2, 3, 4])
def test_stage_bounds_match_jax(depth, stages):
    assert pp_vit.stage_bounds(depth, stages) == jax_pp._stage_bounds(depth, stages)


@pytest.mark.parametrize("leg", list(LEGS))
def test_pp_trajectory_matches_jax(worlds, leg):
    world_size, num_data, stages, micro, depth, bf16 = LEGS[leg]
    cfg = jvit.ViTConfig(depth=depth, bf16=bf16)
    mesh = _mesh(num_data, stages)
    step = jax_pp.make_vit_pp_train_step(mesh, cfg, num_micro=micro)
    state = jax_ddp.replicate_params(jax_ddp.make_train_state(_params(depth)), mesh)
    jlosses = []
    for x, y, w in zip(*_batches(num_data)):
        state, per_shard = step(state, jnp.asarray(x), jnp.asarray(y, jnp.int32),
                                jnp.asarray(w), jnp.float32(1.0))
        jlosses.append(np.asarray(per_shard))
    jlosses = np.stack(jlosses)
    ranks = worlds[world_size]
    loss_tol = dict(rtol=0, atol=BF16_LOSS_ATOL) if bf16 else LOSS_TOL
    for r in ranks:
        got = r[leg]
        d = r["rank"] // stages
        assert got["step"] == STEPS and got["staged"] == 0  # CPU tensors: no host staging
        np.testing.assert_allclose(got["losses"], jlosses[:, d], err_msg=str(r["rank"]),
                                   **loss_tol)
        # every stage holds its data shard's loss: the last stage's, summed
        last = ranks[d * stages + stages - 1][leg]["losses"]
        assert np.array_equal(got["losses"], last)
    first = ranks[0][leg]
    assert all(r[leg]["replicated"] == first["replicated"] for r in ranks)
    assert len(set(first["replicated"])) == STEPS
    want = torch_vit_state_from_jax(jax.device_get(state.params))
    for k, v in want.items():
        np.testing.assert_allclose(first["state"][k], v.numpy(), rtol=0,
                                   atol=BF16_PARAM_ATOL if bf16 else PARAM_ATOL, err_msg=k)


@pytest.mark.parametrize("world_size", [2, 4])
def test_pp_eval_totals_match_jax(worlds, world_size):
    """The data-parallel eval on whole parameters, summed over data only:
    every stage of a data shard holds the same totals."""
    num_data = world_size // 2
    x, y, w = _eval_batch(num_data)
    mesh = _mesh(num_data, 2)
    want = np.asarray(jax_pp.make_vit_eval_step(mesh, jvit.ViTConfig())(
        jax_ddp.replicate_params(_params(), mesh), jnp.asarray(x), jnp.asarray(y, jnp.int32),
        jnp.asarray(w)))
    for r in worlds[world_size]:
        np.testing.assert_allclose(r["eval"][0], want[0], rtol=1e-5)
        assert r["eval"][1] == want[1]


def test_bf16_boundary_is_bf16():
    """Stage 0's output, the boundary, is bfloat16 under --bf16 (JAX's
    engine sends the activation at its own dtype)."""
    model = ViT(ViTConfig(bf16=True))
    first = pp_vit.stage_fns(model.cfg, 2)[0]
    act = first(model, torch.zeros(4, 28, 28, 1))
    assert act.dtype == torch.bfloat16 and act.shape == (4, 16, 64)


def _fake_grid(stages):
    return RankGrid(shape=(1, 1, stages), model=Group(tuple(range(stages)), 0))


def _refusal(fn, *args):
    with pytest.raises((ValueError, SystemExit)) as err:
        fn(*args)
    return str(err.value)


@pytest.mark.parametrize("case", ["one_stage", "depth_below_stages", "microbatches"])
def test_pp_guards_are_jax_texts(case):
    cfg, stages, micro = {"one_stage": (2, 1, 2), "depth_below_stages": (1, 2, 2),
                          "microbatches": (2, 2, 3)}[case]
    jcfg = jvit.ViTConfig(depth=cfg)
    mesh = _mesh(1, stages)
    if case == "microbatches":
        x = jnp.zeros((8, 28, 28, 1))
        jstep = jax_pp.make_vit_pp_train_step(mesh, jcfg, num_micro=micro)
        state = jax_ddp.replicate_params(jax_ddp.make_train_state(_params()), mesh)
        want = _refusal(jstep, state, x, jnp.zeros(8, jnp.int32), jnp.ones(8), 1.0)
        step = pp_vit.make_vit_pp_train_step(ViTConfig(), _fake_grid(stages), micro)
        got = _refusal(step, None, None, torch.zeros(8, 28, 28, 1), torch.zeros(8), torch.ones(8),
                       1.0)
    else:
        want = _refusal(jax_pp.make_vit_pp_train_step, mesh, jcfg, micro)
        got = _refusal(pp_vit.make_vit_pp_train_step, ViTConfig(depth=cfg), _fake_grid(stages),
                       micro)
    assert got == want


MODE_FLAGS = [
    [*mode, *stages, *flash, *remat]
    for mode in ([], ["--pp"], ["--experts", "8"], ["--zero"], ["--pp", "--experts", "8"],
                 ["--zero", "--pp"], ["--zero", "--experts", "4"], ["--pp", "--sp", "2"],
                 ["--pp", "--tp", "2"], ["--experts", "8", "--sp", "2"],
                 ["--experts", "8", "--tp", "2"], ["--zero", "--sp", "2"],
                 ["--zero", "--tp", "2"], ["--pp", "--sp", "1", "--allow-degree-1"])
    for stages in ([], ["--pp-stages", "1"], ["--pp-stages", "4"])
    for flash in ([], ["--flash"])
    for remat in ([], ["--remat"])
]


@pytest.mark.parametrize("flags", MODE_FLAGS, ids=lambda f: " ".join(f) or "none")
def test_new_mode_flags_are_the_jax_truth_table(flags):
    """--pp, --pp-stages, --experts and --zero against each other, --sp,
    --tp, --flash and --remat: the same resolution as the JAX CLI's, or
    the same refusal text."""
    def resolve(cli):
        args = cli.build_parser().parse_args(flags)
        try:
            return cli.resolve_mode_flags(args), args.sp, args.tp
        except SystemExit as e:
            return str(e)

    assert resolve(vit_mnist) == resolve(jax_cli)


@pytest.mark.parametrize("flags, dest, value", [
    (["--pp"], "pp", True), (["--pp-microbatches", "4"], "pp_microbatches", 4),
    (["--pp-stages", "3"], "pp_stages", 3), (["--experts", "8"], "experts", 8),
    (["--zero"], "zero", True)])
def test_new_flags_take_the_jax_defaults(flags, dest, value):
    got, want = vit_mnist.build_parser(), jax_cli.build_parser()
    assert getattr(got.parse_args(flags), dest) == getattr(want.parse_args(flags), dest) == value
    assert getattr(got.parse_args([]), dest) == getattr(want.parse_args([]), dest)


# -- the CLI through the launcher -------------------------------------------------

CLI_MODES = {"experts_flash": ["--experts", "8", "--flash"], "zero_flash": ["--zero", "--flash"],
             "pp": ["--pp"]}


def _jax_first_loss(flags: list) -> float:
    """The loss rank 0 prints first: its data shard's rows of the first
    global batch, the port's initial weights (``--seed 1``) carried into
    the JAX package's forward, before any update."""
    import pytorch_mnist_ddp_tpu_torch.utils.rng as port_rng
    from pytorch_mnist_ddp_tpu.ops.loss import nll_loss as jax_nll
    from pytorch_mnist_ddp_tpu_torch.data.loader import DataLoader
    from pytorch_mnist_ddp_tpu_torch.utils.convert import jax_vit_tree_from_torch

    experts = 8 if "--experts" in flags else 0
    num_data = 1 if "--pp" in flags else 2
    images, labels = jax_mnist.synthetic_mnist("train")
    loader = DataLoader(images, labels, 64, torch.device("cpu"), shuffle=True, seed=1, shard=0,
                        num_shards=num_data)
    x, y, w = next(iter(loader.epoch(1)))
    model = ViT(ViTConfig(num_experts=experts),
                generator=torch.Generator().manual_seed(port_rng.split_streams(1)["init"]))
    params = jax_vit_tree_from_torch(model.state_dict())
    cfg = jvit.ViTConfig(num_experts=experts)
    xj = jnp.asarray(x.numpy())
    logp = (jvit.vit_moe_forward(params, xj, cfg)[0] if experts
            else jvit.vit_forward(params, xj, cfg))
    return float(jax_nll(logp, jnp.asarray(y.numpy(), jnp.int32), jnp.asarray(w.numpy()),
                         reduction="mean"))


@pytest.mark.parametrize("mode", list(CLI_MODES))
def test_launcher_two_ranks_print_the_jax_lines(tmp_path, mode):
    """Two gloo ranks through the port's launcher: one chief's lines in the
    JAX CLI's format, byte for byte, the first loss within the trajectory
    gates of the JAX package's on the same rows and weights."""
    import os
    import re
    import socket
    import subprocess
    import sys

    from pytorch_mnist_ddp_tpu.utils import logging as jax_logging

    root = __import__("pathlib").Path(__file__).resolve().parents[1]
    drop = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "SLURM_PROCID", "MASTER_ADDR", "MASTER_PORT",
            "MNIST_DATA_DIR")
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(PYTHONPATH=str(root), OMP_NUM_THREADS="1")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.parallel.launch",
         "--nproc_per_node=2", f"--master_port={port}", "-m",
         "pytorch_mnist_ddp_tpu_torch.vit_mnist", "--no-cuda", "--dry-run", "--epochs", "1",
         *CLI_MODES[mode], "--save-model"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    loss = float(re.search(r"^Train Epoch: .*Loss: (\S+)$", out, re.M).group(1))
    avg, correct = re.search(r"^Test set: Average loss: (\S+), Accuracy: (\d+)/", out,
                             re.M).groups()
    elapsed = re.search(r"^Total cost time:(\S+) ms$", out, re.M).group(1)
    num_batches = 938 if mode == "pp" else 469  # the global batch: 64 x data shards
    want = ("MNIST IDX files unavailable (no local copy, download failed); "
            "using deterministic synthetic MNIST-like data\n")
    want += jax_logging.train_log_line(1, 0, 60000, 0, num_batches, loss) + "\n"
    want += jax_logging.test_summary_lines(float(avg), int(correct), 10000) + "\n"
    want += jax_logging.total_time_line(float(elapsed)) + "\n"
    assert out == want
    np.testing.assert_allclose(loss, _jax_first_loss(CLI_MODES[mode]), **LOSS_TOL)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["vit_mnist.npz"]
