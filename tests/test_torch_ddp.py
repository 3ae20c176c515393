"""The port's data-parallel training (``mnist_ddp.py``) held against the
JAX package on the CPU, on the same numpy inputs.

The port's ranks are processes of a gloo world (``test_torch_launch.py``
runs them); the JAX package's are the devices of one process's mesh
(``tests/conftest.py``'s 8 virtual CPU devices).  That process draws a
global batch as one slab sharded over the mesh, so the JAX step here gets
the port ranks' batches concatenated in rank order: device d holds what
rank d holds.

- Per-rank loader batches (x, y, w) equal JAX ``DataLoader(process_rank=r,
  process_count=N)``'s, the last partial batch and eval's masked padding
  duplicates included (x within 1e-6, as ``test_torch_train.py`` holds
  them).
- 8 data-parallel steps, dropout off, plain and ``--pallas-opt``, at N = 2
  and 4, within the trajectory gates of ``test_torch_train.py`` (losses
  rtol 2e-4, atol 2e-5, each rank's against its device's; parameters atol
  5e-3), the ranks' models ``torch.equal`` after every step; the last step
  has padding rows, so each rank's masked mean runs on fewer rows.
- Distributed eval totals: the correct count exactly, the loss sum within
  rtol 1e-5.
- The CLI: without the environment it prints the notice, writes
  ``mnist_cnn_.pt`` and ends on ``mnist.py``'s bits; through the launcher
  a two-rank world prints two banners and one chief's lines, byte for
  byte the JAX helpers' format, and saves ``module.`` keys.
"""

from __future__ import annotations

import os
import pathlib
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu.data import mnist as jax_mnist
from pytorch_mnist_ddp_tpu.data.loader import DataLoader as JaxLoader
from pytorch_mnist_ddp_tpu.data.transforms import normalize as jax_normalize
from pytorch_mnist_ddp_tpu.models.net import init_params
from pytorch_mnist_ddp_tpu.parallel import ddp as jax_ddp
from pytorch_mnist_ddp_tpu.parallel import distributed as jax_dist
from pytorch_mnist_ddp_tpu.parallel.mesh import make_mesh
from pytorch_mnist_ddp_tpu.utils import logging as jax_logging
from pytorch_mnist_ddp_tpu.utils.checkpoint import load_state_dict, params_from_state_dict
from pytorch_mnist_ddp_tpu_torch.data.loader import DataLoader
from pytorch_mnist_ddp_tpu_torch.mnist_ddp import build_parser as ddp_parser
from pytorch_mnist_ddp_tpu_torch.parallel import distributed as port_dist
from pytorch_mnist_ddp_tpu_torch.parallel.distributed import DistState
from pytorch_mnist_ddp_tpu_torch.trainer import _resume_cursor, train_one_epoch
from pytorch_mnist_ddp_tpu_torch.utils import logging as port_logging
from pytorch_mnist_ddp_tpu_torch.utils.checkpoint import load_inference_state
from pytorch_mnist_ddp_tpu_torch.utils.convert import torch_state_from_jax
from pytorch_mnist_ddp_tpu_torch.utils.rng import fold_replica_step, fold_step
from test_torch_launch import run_world, train_ranks
from test_torch_resume import _jax_patterns, assert_jax_text

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_DISTRIBUTED = ROOT / "pytorch_mnist_ddp_tpu" / "parallel" / "distributed.py"
STEPS, B = 8, 16  # optimizer steps; rows per rank and step
PAD = 4  # the last step's padding rows on every rank
RUNS = (("plain", False, False), ("pallas_opt", True, False))


# -- loaders ---------------------------------------------------------------

@pytest.mark.parametrize("world_size", [2, 3, 4])
@pytest.mark.parametrize("split", ["train", "eval"])
def test_rank_batches_match_jax_process_batches(world_size, split):
    """n = 203 leaves a partial last batch and, past 2 ranks, padding
    duplicates, which eval weighs 0 and train keeps."""
    n, batch = 203, 24
    images, labels = jax_mnist.synthetic_mnist("train", n)
    evaluating = split == "eval"
    for rank in range(world_size):
        port = DataLoader(images, labels, batch, torch.device("cpu"), shuffle=not evaluating,
                          seed=5, rank=rank, world_size=world_size, mask_padding=evaluating)
        ref = JaxLoader(images, labels, batch * world_size, mesh=None, shuffle=not evaluating,
                        seed=5, process_rank=rank, process_count=world_size,
                        mask_padding=evaluating)
        assert len(port) == len(ref) == -(-(-(-n // world_size)) // batch)
        assert port.dataset_len == n
        got, want = list(port.epoch(3)), list(ref._host_batches(3))
        assert len(got) == len(want)
        for (x, y, w), (jx, jy, jw) in zip(got, want):
            np.testing.assert_allclose(x.numpy(), jx, rtol=0, atol=1e-6)
            assert np.array_equal(y.numpy(), jy) and np.array_equal(w.numpy(), jw)
        weights = sum(float(w.sum()) for _, _, w in got)
        positions = range(rank, -(-n // world_size) * world_size, world_size)
        # Eval weighs the padding duplicates (positions past n) 0.
        assert weights == (sum(p < n for p in positions) if evaluating else len(positions))


def test_eval_weights_count_each_sample_once_over_the_ranks():
    n = 203
    images, labels = jax_mnist.synthetic_mnist("test", n)
    total = 0.0
    for rank in range(4):
        loader = DataLoader(images, labels, 7, torch.device("cpu"), shuffle=False, rank=rank,
                            world_size=4, mask_padding=True)
        total += sum(float(w.sum()) for _, _, w in loader.epoch(0))
    assert total == n


# -- the data-parallel step --------------------------------------------------

def _global_batches(world_size: int):
    images, labels = jax_mnist.synthetic_mnist("train", STEPS * world_size * B)
    xs = jax_normalize(images).reshape(STEPS, world_size * B, 28, 28, 1)
    ys = labels.astype(np.int64).reshape(STEPS, world_size * B)
    ws = np.ones((STEPS, world_size, B), np.float32)
    ws[-1, :, B - PAD:] = 0.0  # a final partial batch: equal real rows per rank
    xs[-1].reshape(world_size, B, 28, 28, 1)[:, B - PAD:] = 0.0
    return xs, ys, ws.reshape(STEPS, world_size * B)


def _eval_batch(world_size: int):
    images, labels = jax_mnist.synthetic_mnist("test", world_size * 25)
    w = np.ones((world_size, 25), np.float32)
    w[-1, -3:] = 0.0  # the last rank's padding duplicates
    return jax_normalize(images), labels.astype(np.int64), w.reshape(-1)


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(init_params(jax.random.PRNGKey(11)))


@pytest.fixture(scope="module")
def port_runs(jax_params, tmp_path_factory):
    """Both optimizer paths at N = 2 (and the eval step) and N = 4, one
    gloo world each."""
    state = {k: v.numpy() for k, v in torch_state_from_jax(jax_params).items()}
    out = {}
    for n in (2, 4):
        tmp = tmp_path_factory.mktemp(f"world{n}")
        out[n] = run_world(train_ranks, n, tmp, state, _global_batches(n), RUNS,
                           _eval_batch(n) if n == 2 else None)
    return out


def _jax_run(params, world_size: int, pallas_opt: bool):
    mesh = make_mesh(num_data=world_size, devices=jax.devices()[:world_size])
    step = jax_ddp.make_train_step(mesh, dropout=False, use_pallas=pallas_opt)
    state = jax_ddp.replicate_params(jax_ddp.make_train_state(params, use_pallas=pallas_opt),
                                     mesh)
    losses = []
    for x, y, w in zip(*_global_batches(world_size)):
        state, per_shard = step(state, jnp.asarray(x), jnp.asarray(y, jnp.int32),
                                jnp.asarray(w), jax.random.PRNGKey(0), jnp.float32(1.0))
        losses.append(np.asarray(per_shard))
    return np.stack(losses), torch_state_from_jax(jax.device_get(state.params))


@pytest.mark.parametrize("world_size", [2, 4])
@pytest.mark.parametrize("run", ["plain", "pallas_opt"])
def test_dp_trajectory_matches_jax_mesh(jax_params, port_runs, world_size, run, monkeypatch):
    pallas_opt = run == "pallas_opt"
    if pallas_opt:
        monkeypatch.setenv("TPU_MNIST_PALLAS_INTERPRET", "1")
    jlosses, jstate = _jax_run(jax_params, world_size, pallas_opt)
    ranks = [r[run] for r in port_runs[world_size]]
    for rank, got in enumerate(ranks):
        assert got["step"] == STEPS
        np.testing.assert_allclose(got["losses"], jlosses[:, rank], rtol=2e-4, atol=2e-5,
                                   err_msg=f"rank {rank}")
    # The ranks' models are equal after every step, bit for bit.
    assert all(r["digests"] == ranks[0]["digests"] for r in ranks)
    assert len(set(ranks[0]["digests"])) == STEPS  # and every step moved them
    for k, want in jstate.items():
        np.testing.assert_allclose(ranks[0]["state"][k].numpy(), want.numpy(), rtol=0,
                                   atol=5e-3, err_msg=k)
    assert ranks[0]["losses"][-1] < ranks[0]["losses"][0]


def test_distributed_eval_totals_match_jax(jax_params, port_runs):
    x, y, w = _eval_batch(2)
    mesh = make_mesh(num_data=2, devices=jax.devices()[:2])
    want = np.asarray(jax_ddp.make_eval_step(mesh)(
        jax_params, jnp.asarray(x), jnp.asarray(y, jnp.int32), jnp.asarray(w)))
    totals = [r["eval"] for r in port_runs[2]]
    assert totals[0] == totals[1]  # every rank holds the totals
    np.testing.assert_allclose(totals[0][0], want[0], rtol=1e-5)
    assert totals[0][1] == want[1]


def test_dropout_streams_per_step_and_rank():
    """A world of one draws mnist.py's stream; ranks of a larger world
    draw streams of their own."""
    assert fold_replica_step(7, 3) == fold_replica_step(7, 3, 0, 1) == fold_step(7, 3)
    seeds = {fold_replica_step(7, 3, r, 4) for r in range(4)}
    assert len(seeds) == 4 and fold_step(7, 3) not in seeds
    assert fold_replica_step(7, 4, 0, 4) not in seeds


def test_chief_logs_the_global_sample_counter(capsys):
    """Rank 0 of 2 prints ``world_size * batch_idx * batch_size`` over the
    whole set; rank 1 prints nothing."""
    images, labels = jax_mnist.synthetic_mnist("train", 640)
    losses = iter(range(100))

    def step(model, state, x, y, w, lr):
        return torch.tensor(float(next(losses)))

    for rank in (0, 1):
        loader = DataLoader(images, labels, 64, torch.device("cpu"), rank=rank, world_size=2)
        train_one_epoch(step, None, None, loader, 1, 1.0, log_interval=2,
                        dist=DistState(distributed=True, rank=rank, world_size=2))
    want = "".join(jax_logging.train_log_line(1, 2 * b * 64, 640, b, 5, float(i)) + "\n"
                   for i, b in ((0, 0), (2, 2), (4, 4)))
    assert capsys.readouterr().out == want


# -- texts and the environment -------------------------------------------------

JAX_DIST_MESSAGES, _ = _jax_patterns(JAX_DISTRIBUTED)


def test_world_of_one_notice_matches_jax(monkeypatch, capsys):
    for name in ("RANK", "WORLD_SIZE", "SLURM_PROCID", "NPROC_PER_NODE"):
        monkeypatch.delenv(name, raising=False)
    jax_state = jax_dist.init_distributed_mode()
    jax_out = capsys.readouterr().out
    port_state = port_dist.init_distributed_mode(device="cpu")
    assert capsys.readouterr().out == jax_out == jax_logging.NOT_DISTRIBUTED_NOTICE + "\n"
    assert port_state.distributed == jax_state.distributed is False
    assert port_state.is_chief and jax_state.is_chief
    for args in ((0, "env://", 0, 4), (3, "tcp://h:1", 1, 8)):
        assert port_logging.distributed_init_banner(*args) == \
            jax_logging.distributed_init_banner(*args)
    assert port_logging.NOT_DISTRIBUTED_NOTICE == jax_logging.NOT_DISTRIBUTED_NOTICE


@pytest.mark.parametrize("present", ["MASTER_ADDR", "MASTER_PORT"])
def test_half_set_master_text_is_jax(monkeypatch, present):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    monkeypatch.setenv(present, "1")
    with pytest.raises(ValueError) as port_err:
        port_dist._coordinator_address("env://")
    with pytest.raises(ValueError) as jax_err:
        jax_dist._coordinator_address("env://")
    assert str(port_err.value) == str(jax_err.value)


def test_rendezvous_failure_text_is_jax(monkeypatch, tmp_path):
    def refuse(*args, **kwargs):
        raise RuntimeError("Wait timeout")

    monkeypatch.setattr(port_dist.dist, "init_process_group", refuse)
    with pytest.raises(RuntimeError) as err:
        port_dist.initialize_with_retry("tcp://127.0.0.1:1", 2, 1, "gloo", timeout_s=2,
                                        attempts=2)
    msg = str(err.value)
    assert any(p.fullmatch(msg) for p in JAX_DIST_MESSAGES), msg
    assert msg.startswith("rendezvous at '127.0.0.1:1' failed after 2 attempt(s) x 1s")


def test_mid_epoch_archive_of_another_world_is_refused_naming_both():
    """Saved at 4 ranks of 8 (global batch 32), resumed at 2 ranks of 16:
    the same global batch, another world: refused with the JAX trainer's
    whole text, which names --resume-reshard; with that flag the cursor
    stands."""
    args = ddp_parser().parse_args(["--batch-size", "16"])
    extras = {"epoch_in_progress": 1, "batch_cursor": 3, "seed": 1, "global_batch": 32,
              "world_size": 4}
    with pytest.raises(ValueError, match="world size 4; this run's world size is 2") as err:
        _resume_cursor("s.npz", extras, 0, args, 2)
    assert_jax_text(str(err.value))
    assert "pass --resume-reshard to accept it" in str(err.value)
    assert _resume_cursor("s.npz", {**extras, "world_size": 2}, 0, args, 2) == 3
    reshard = ddp_parser().parse_args(["--batch-size", "16", "--resume-reshard"])
    assert _resume_cursor("s.npz", extras, 0, reshard, 2) == 3
    with pytest.raises(ValueError, match="global batch 32; this run's 48"):
        _resume_cursor("s.npz", extras, 0, args, 3)


# -- the CLI -----------------------------------------------------------------

def _env() -> dict:
    """The CLIs' environment: no world, the synthetic set, and one thread:
    with several, the CPU's reductions may split differently from run to
    run when the host is busy, and two runs compared bit for bit differ."""
    drop = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "SLURM_PROCID", "MASTER_ADDR", "MASTER_PORT",
            "MNIST_DATA_DIR")
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return env


def _cli(module: str, args: list[str], cwd) -> str:
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=cwd, env=_env(),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_without_env_mnist_ddp_is_mnist_with_the_notice(tmp_path):
    flags = ["--no-cuda", "--dry-run", "--epochs", "2", "--train-limit", "256", "--save-model",
             "--pallas-opt"]
    (tmp_path / "ddp").mkdir()
    (tmp_path / "one").mkdir()
    ddp_out = _cli("pytorch_mnist_ddp_tpu_torch.mnist_ddp", flags, tmp_path / "ddp")
    one_out = _cli("pytorch_mnist_ddp_tpu_torch.mnist", flags, tmp_path / "one")
    lines = ddp_out.splitlines(keepends=True)
    assert lines[0] == jax_logging.NOT_DISTRIBUTED_NOTICE + "\n"
    assert re.fullmatch(r"Total cost time:\d+\.\d+ ms\n", lines[-1])
    assert "".join(lines[1:-1]) == one_out
    assert sorted(p.name for p in (tmp_path / "ddp").iterdir()) == ["mnist_cnn_.pt"]
    got = torch.load(tmp_path / "ddp" / "mnist_cnn_.pt", weights_only=True)
    want = torch.load(tmp_path / "one" / "mnist_cnn.pt", weights_only=True)
    assert list(got) == list(want)  # no module. prefix out of distributed mode
    assert all(torch.equal(got[k], want[k]) for k in want)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launcher_two_rank_gloo_world_prints_one_chief(tmp_path):
    out = _cli("pytorch_mnist_ddp_tpu_torch.parallel.launch",
               ["--nproc_per_node=2", f"--master_port={_free_port()}", "-m",
                "pytorch_mnist_ddp_tpu_torch.mnist_ddp", "--no-cuda", "--dry-run", "--epochs", "1",
                "--train-limit", "640", "--save-model"], tmp_path)
    for rank in (0, 1):
        assert out.count(jax_logging.distributed_init_banner(rank, "env://", rank, 2)) == 1
    assert len(re.findall(r"Total cost time:\d+\.\d+ ms", out)) == 2
    train = re.findall(r"^Train Epoch: .*$", out, re.M)
    tests = re.findall(r"^Test set: Average loss: (\S+), Accuracy: (\d+)/(\d+) .*$", out, re.M)
    assert len(train) == len(tests) == 1
    loss = float(train[0].rsplit("Loss: ", 1)[1])
    # 320 samples a rank at batch 64: 5 batches; the dry run takes one.
    assert train[0] == jax_logging.train_log_line(1, 0, 640, 0, 5, loss)
    avg, correct, n = tests[0]
    want = jax_logging.test_summary_lines(float(avg), int(correct), 640)
    assert want in out and n == "640"
    path = str(tmp_path / "mnist_cnn.pt")
    raw = torch.load(path, weights_only=True)
    assert all(k.startswith("module.") for k in raw) and len(raw) == 8
    port = load_inference_state(path)
    jax_side = torch_state_from_jax(params_from_state_dict(load_state_dict(path)))
    assert all(torch.equal(port[k], jax_side[k]) for k in port)
