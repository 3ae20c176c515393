"""The port's world formation and launcher, and the rank programs of the
gloo worlds that ``tests/test_torch_ddp.py`` and
``tests/test_torch_syncbn.py`` hold against the JAX package.

This file imports no JAX: each rank of a world is a spawned process that
imports this module, and a rank that imported JAX would take seconds
longer to start.  A world forms over ``file://`` rendezvous in the test's
own directory (several test workers run at once), every rank uses one
thread, and the parent gives the whole world 120 s before it stops the
ranks and fails.
"""

from __future__ import annotations

import hashlib
import multiprocessing
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu_torch.models.net import Net, SyncBatchNorm
from pytorch_mnist_ddp_tpu_torch.parallel import distributed as port_dist
from pytorch_mnist_ddp_tpu_torch.parallel import launch
from pytorch_mnist_ddp_tpu_torch.parallel.ddp import (
    make_eval_step,
    make_train_state,
    make_train_step,
)
from pytorch_mnist_ddp_tpu_torch.utils.logging import NOT_DISTRIBUTED_NOTICE

ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD_TIMEOUT_S = 120.0


# -- running a gloo world ---------------------------------------------------

def _rank_main(program, rank: int, world_size: int, init_file: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank))
    args = torch.load(os.path.join(out_dir, "args.pt"), weights_only=False)
    world = port_dist.init_distributed_mode(f"file://{init_file}", rdzv_timeout_s=60,
                                            device="cpu")
    try:
        result = program(world, *args)
    finally:
        port_dist.destroy_distributed()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


def run_world(program, world_size: int, tmp_path: pathlib.Path, *args) -> list:
    """``program(world, *args)`` on each rank of a gloo world of
    ``world_size`` CPU processes; returns each rank's result, in rank
    order.  ``program`` is a function of a test module.  ``args`` reach
    the ranks through a file: through the start pipe, arguments past its
    buffer would hold each start until the rank before had imported torch."""
    ctx = multiprocessing.get_context("spawn")
    out_dir = tmp_path / f"world{world_size}-{program.__name__}"
    out_dir.mkdir()
    torch.save(args, out_dir / "args.pt")
    procs = [ctx.Process(target=_rank_main, args=(program, r, world_size,
                                                  str(out_dir / "rdzv"), str(out_dir)))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    for p in procs:
        p.join(timeout=max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(timeout=10)
    assert not alive, f"{len(alive)} rank(s) of {program.__name__} still running after " \
                      f"{WORLD_TIMEOUT_S} s"
    assert [p.exitcode for p in procs] == [0] * world_size, [p.exitcode for p in procs]
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(world_size)]


def _digest(model: torch.nn.Module) -> str:
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        h.update(k.encode())
        h.update(v.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


# -- rank programs ------------------------------------------------------------

def train_ranks(world, state: dict, batches: tuple, runs: tuple,
                eval_batch: tuple | None = None) -> dict:
    """For each ``(name, pallas_opt, syncbn)`` of ``runs``: the model from
    ``state`` (numpy, torch layout) through the data-parallel step on
    this rank's slice of every global batch ``(xs, ys, ws)`` [steps, N*b],
    dropout off.  Returns per run the losses, a digest of the model after
    every step, and the final state; with ``eval_batch`` also the eval
    step's totals on it from ``state`` (``"eval"``)."""
    xs, ys, ws = batches
    b = xs.shape[1] // world.world_size
    rows = slice(world.rank * b, (world.rank + 1) * b)
    out = {}
    if eval_batch is not None:
        out["eval"] = eval_ranks(world, state, *eval_batch)
    for name, pallas_opt, syncbn in runs:
        net = Net(use_bn=syncbn)
        net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()
                             if syncbn or not k.startswith("bn")})
        train_state = make_train_state(net, use_pallas=pallas_opt)
        step = make_train_step(dropout=False, use_pallas=pallas_opt, world=world)
        losses, digests = [], []
        for x, y, w in zip(xs, ys, ws):
            loss = step(net, train_state, torch.from_numpy(x[rows]), torch.from_numpy(y[rows]),
                        torch.from_numpy(w[rows]), 1.0)
            losses.append(float(loss))
            digests.append(_digest(net))
        out[name] = {"losses": losses, "digests": digests, "step": train_state.step,
                     "state": {k: v.clone() for k, v in net.state_dict().items()}}
    return out


def bn_ranks(world, x: np.ndarray, mask: np.ndarray, cot: np.ndarray, params: dict,
             sync: bool = True) -> dict:
    """One train-mode forward of a :class:`SyncBatchNorm` (``params``:
    weight, bias, running_mean, running_var) on this rank's slice of
    ``x`` [N*b, C, H, W] with its ``mask`` and ``sync``, and the backward
    of ``sum(y * cot)``: the output, the gradients of x, weight and bias,
    and the running averages after."""
    b = len(x) // world.world_size
    rows = slice(world.rank * b, (world.rank + 1) * b)
    bn = SyncBatchNorm(x.shape[1])
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    xr = torch.from_numpy(x[rows]).requires_grad_()
    y = bn(xr, torch.from_numpy(mask[rows]), sync=sync)
    (y * torch.from_numpy(cot[rows])).sum().backward()
    return {"y": y.detach(), "dx": xr.grad, "dweight": bn.weight.grad, "dbias": bn.bias.grad,
            "running_mean": bn.running_mean, "running_var": bn.running_var}


def eval_ranks(world, state: dict, x: np.ndarray, y: np.ndarray, w: np.ndarray,
               syncbn: bool = False) -> tuple[float, float]:
    """The distributed eval step's totals on this rank's slice."""
    net = Net(use_bn=syncbn)
    net.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    b = len(x) // world.world_size
    rows = slice(world.rank * b, (world.rank + 1) * b)
    loss_sum, correct = make_eval_step(world=world)(
        net, torch.from_numpy(x[rows]), torch.from_numpy(y[rows]), torch.from_numpy(w[rows]))
    return float(loss_sum), float(correct)


# -- world formation ----------------------------------------------------------

@pytest.fixture
def clean_env(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "SLURM_PROCID", "SLURM_NTASKS",
                 "SLURM_LOCALID", "MASTER_ADDR", "MASTER_PORT", "RDZV_TIMEOUT_S",
                 "RDZV_ATTEMPTS"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_no_env_is_a_world_of_one(clean_env, capsys):
    state = port_dist.init_distributed_mode(device="cpu")
    assert state == port_dist.DistState()
    assert not state.distributed and state.is_chief and state.world_size == 1
    assert capsys.readouterr().out == NOT_DISTRIBUTED_NOTICE + "\n"


@pytest.mark.parametrize("present", ["MASTER_ADDR", "MASTER_PORT"])
def test_half_set_master_address_names_the_missing_variable(clean_env, present):
    clean_env.setenv("RANK", "0")
    clean_env.setenv("WORLD_SIZE", "2")
    clean_env.setenv(present, "29999" if present == "MASTER_PORT" else "127.0.0.1")
    missing = "MASTER_PORT" if present == "MASTER_ADDR" else "MASTER_ADDR"
    with pytest.raises(ValueError, match=f"{present} is set but {missing} is not"):
        port_dist.init_distributed_mode(device="cpu")


def test_env_without_master_address_is_refused(clean_env):
    clean_env.setenv("RANK", "0")
    clean_env.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="neither MASTER_ADDR nor MASTER_PORT"):
        port_dist.init_distributed_mode(device="cpu")


@pytest.mark.parametrize("env", [{"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"},
                                 {"SLURM_PROCID": "0", "SLURM_NTASKS": "1"}],
                         ids=["rank_env", "slurm"])
def test_a_world_of_one_forms_and_prints_the_banner(clean_env, capsys, tmp_path, env):
    for k, v in env.items():
        clean_env.setenv(k, v)
    url = f"file://{tmp_path / 'rdzv'}"
    try:
        state = port_dist.init_distributed_mode(url, rdzv_timeout_s=20, device="cpu")
        assert torch.distributed.get_backend() == "gloo"
        assert torch.distributed.get_world_size() == 1
    finally:
        port_dist.destroy_distributed()
    assert state == port_dist.DistState(distributed=True, dist_url=url)
    assert not torch.distributed.is_initialized()
    assert capsys.readouterr().out == (
        f"| distributed init (rank 0): {url}, local rank:0, world size:1\n")


def test_missing_peer_fails_within_the_rendezvous_budget(clean_env, tmp_path):
    """Rank 0 of 2 alone: both attempts time out, and the error names the
    address, the rank and the world, within the budget plus a second."""
    clean_env.setenv("RANK", "0")
    clean_env.setenv("WORLD_SIZE", "2")
    clean_env.setenv("RDZV_TIMEOUT_S", "4")
    url = f"file://{tmp_path / 'rdzv'}"
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="a peer never arrived") as err:
        port_dist.init_distributed_mode(url, device="cpu")
    elapsed = time.monotonic() - t0
    assert elapsed < 4 + 1.5, elapsed
    msg = str(err.value)
    assert f"rendezvous at {url!r} failed after 2 attempt(s) x 2s (budget 4s)" in msg
    assert "as process 0 of 2" in msg and "every rank 0..1 is running" in msg
    assert not torch.distributed.is_initialized()


def test_local_rank_past_the_cards_raises_naming_both(clean_env, monkeypatch):
    clean_env.setenv("RANK", "1")
    clean_env.setenv("WORLD_SIZE", "2")
    clean_env.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(port_dist, "resolve_device", lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(port_dist.torch.cuda, "device_count", lambda: 1)

    def never(*args, **kwargs):
        raise AssertionError("no card may be selected, no world formed")

    monkeypatch.setattr(port_dist.torch.cuda, "set_device", never)
    monkeypatch.setattr(port_dist, "initialize_with_retry", never)
    with pytest.raises(RuntimeError, match=r"LOCAL_RANK=1 but this host has 1 CUDA device"):
        port_dist.init_distributed_mode()


def test_without_a_card_a_rank_raises_before_any_rendezvous(clean_env, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the no-card contract is moot")
    clean_env.setenv("RANK", "0")
    clean_env.setenv("WORLD_SIZE", "2")
    monkeypatch.setattr(port_dist, "initialize_with_retry",
                        lambda *a, **k: pytest.fail("rendezvous without a card"))
    with pytest.raises(RuntimeError, match="CUDA"):
        port_dist.init_distributed_mode()


# -- the launcher ---------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_child_env_follows_torch_distributed_launch():
    args = launch.build_parser().parse_args(
        ["--nproc_per_node", "4", "--nnodes", "2", "--node_rank", "1", "--master_addr",
         "10.0.0.1", "--master_port", "1234", "--rdzv-timeout-s", "9", "-m", "pkg.mod",
         "--epochs", "3"])
    assert (args.module, args.program, args.program_args) == (True, "pkg.mod", ["--epochs", "3"])
    env = launch._child_env(args, 2)
    assert {k: env[k] for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                                "MASTER_PORT", "RDZV_TIMEOUT_S", "RDZV_ATTEMPTS")} == {
        "RANK": "6", "WORLD_SIZE": "8", "LOCAL_RANK": "2", "MASTER_ADDR": "10.0.0.1",
        "MASTER_PORT": "1234", "RDZV_TIMEOUT_S": "9.0", "RDZV_ATTEMPTS": "2"}


@pytest.mark.parametrize(
    "flag,dest,value",
    [("--restart-budget=1", "restart_budget", 1), ("--grace-s=1", "grace_s", 1.0),
     ("--backoff-base-s=1", "backoff_base_s", 1.0), ("--backoff-max-s=1", "backoff_max_s", 1.0),
     ("--backoff-seed=1", "backoff_seed", 1), ("--heartbeat-timeout-s=1", "heartbeat_timeout_s",
                                               1.0),
     ("--telemetry-dir=x", "telemetry_dir", "x"), ("--nprocs=2", "nprocs", 2),
     ("--backend=cpu", "backend", "cpu")],
)
def test_launcher_accepts_the_supervision_flags(flag, dest, value):
    """The JAX launcher's supervision flags, with its defaults."""
    assert getattr(launch.build_parser().parse_args([flag, "script.py"]), dest) == value
    d = launch.build_parser().parse_args(["script.py"])
    assert (d.restart_budget, d.grace_s, d.backoff_base_s, d.backoff_max_s, d.backoff_seed,
            d.heartbeat_timeout_s, d.telemetry_dir, d.nprocs, d.backend) == (
        0, 10.0, 0.5, 30.0, 0, 0.0, None, 1, None)


def test_nprocs_times_nproc_per_node_ranks_one_card_each():
    """The module docstring's decision: --nprocs N --nproc_per_node M
    starts N*M processes on the node, one card each, the world the JAX
    launcher forms from N processes of M devices."""
    args = launch.build_parser().parse_args(
        ["--nprocs", "2", "--nproc_per_node", "2", "--master_port", "1234", "x.py"])
    assert launch.local_ranks(args) == 4
    envs = [launch._child_env(args, r, restart_count=1) for r in range(4)]
    assert [(e["RANK"], e["LOCAL_RANK"], e["WORLD_SIZE"]) for e in envs] == [
        ("0", "0", "4"), ("1", "1", "4"), ("2", "2", "4"), ("3", "3", "4")]
    assert {e["ELASTIC_RESTART_COUNT"] for e in envs} == {"1"}


def test_nprocs_with_nnodes_is_refused_with_the_jax_text(capsys):
    with pytest.raises(SystemExit):
        launch.main(["--nprocs", "2", "--nnodes", "2", "x.py"])
    assert "--nprocs (multi-rank gang on one host) and --nnodes" in capsys.readouterr().err


def _rank_script(tmp_path: pathlib.Path, body: str) -> str:
    """A rank program; it writes each line with one call, so that the
    ranks' lines do not interleave on the shared pipe."""
    path = tmp_path / "rank.py"
    path.write_text("import os, sys, time\nrank = int(os.environ['RANK'])\n" + body)
    return str(path)


def _launch(tmp_path, script: str, nproc: int = 2) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.parallel.launch",
         f"--nproc_per_node={nproc}", f"--master_port={_free_port()}", script],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(ROOT)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def test_a_dead_rank_stops_the_others_and_sets_the_exit_code(tmp_path):
    """Rank 1 exits 3 while rank 0 would wait a minute: the launcher stops
    rank 0 within its grace period and exits 3."""
    script = _rank_script(tmp_path, "if rank == 1:\n    time.sleep(0.5)\n    sys.exit(3)\n"
                                    "time.sleep(60)\n")
    t0 = time.monotonic()
    proc = _launch(tmp_path, script)
    _, err = proc.communicate(timeout=60)
    assert proc.returncode == 3, err
    assert time.monotonic() - t0 < 20


def test_signals_reach_every_rank_and_the_code_is_128_plus_signum(tmp_path):
    script = _rank_script(tmp_path, "sys.stdout.write(f'up {rank}\\n')\nsys.stdout.flush()\n"
                                    "time.sleep(60)\n")
    proc = _launch(tmp_path, script)
    up = {proc.stdout.readline().strip() for _ in range(2)}
    assert up == {"up 0", "up 1"}
    proc.send_signal(signal.SIGTERM)
    proc.communicate(timeout=30)
    assert proc.returncode == 128 + signal.SIGTERM


def test_ranks_that_finish_make_the_launcher_exit_zero(tmp_path):
    script = _rank_script(tmp_path, "sys.stdout.write(f\"{rank} {os.environ['WORLD_SIZE']} "
                                    "{os.environ['LOCAL_RANK']}\\n\")\n")
    proc = _launch(tmp_path, script, nproc=3)
    out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err
    assert sorted(out.split("\n")[:-1]) == ["0 3 0", "1 3 1", "2 3 2"]
