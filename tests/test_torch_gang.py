"""The port's supervising launcher (``parallel/launch.py`` over
``parallel/elastic.py``'s ``GangSupervisor``) on the CPU.

- A gang of two gloo ranks through the launcher, rank 1 killed by
  ``--chaos kill:step:rank=1:after=4`` under ``--restart-budget 1``:
  the launcher exits 0 after one restart (``launch_restarts_total 1``,
  ``rank_death`` and ``gang_restart`` events), the restarted world
  resumes the coordinated archive without the chaos clause, and its
  final archive equals an uninterrupted two-rank run's, array for array.
  With ``--restart-budget 0`` the same kill exits 69 with one diagnostic
  and a ``gang_exhausted`` event.  The three worlds run at once.
- The supervisor's pieces against the JAX package's: ``strip_chaos_args``
  and the seeded backoff schedule; a rank whose heartbeat goes silent is
  a hung rank (tiny children, no torch).
"""

from __future__ import annotations

import os
import pathlib
import re
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

from pytorch_mnist_ddp_tpu.parallel import elastic as jax_elastic
from pytorch_mnist_ddp_tpu_torch.data.mnist import _FILES, synthetic_mnist
from pytorch_mnist_ddp_tpu_torch.obs import Registry, read_events
from pytorch_mnist_ddp_tpu_torch.parallel import elastic

ROOT = pathlib.Path(__file__).resolve().parents[1]
LIMIT = 256  # 4 steps an epoch at 2 ranks x 32
TRAIN = ["-m", "pytorch_mnist_ddp_tpu_torch.mnist_ddp", "--no-cuda", "--epochs", "2",
         "--train-limit", str(LIMIT), "--batch-size", "32", "--pallas-opt", "--log-interval",
         "1"]
CHAOS = ["--checkpoint-every-steps", "3", "--chaos", "kill:step:rank=1:after=4"]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Three launcher runs started together: ``{name: (process, dir)}``."""
    root = tmp_path_factory.mktemp("idx")
    for split, n in (("train", LIMIT), ("test", LIMIT)):
        images, labels = synthetic_mnist(split, n)
        (root / _FILES[(split, "images")]).write_bytes(
            struct.pack(">iiii", 2051, n, 28, 28) + images.tobytes())
        (root / _FILES[(split, "labels")]).write_bytes(
            struct.pack(">ii", 2049, n) + labels.tobytes())
    launch = [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.parallel.launch"]
    runs = {
        "uninterrupted": [*launch, "--nproc_per_node", "2", *TRAIN, "--save-state", "s.npz"],
        "restarted": [*launch, "--nprocs", "2", "--restart-budget", "1", "--backoff-base-s",
                      "0.1", "--heartbeat-timeout-s", "60", "--telemetry-dir", "tel", *TRAIN,
                      "--save-state", "s.npz", *CHAOS],
        "exhausted": [*launch, "--nprocs", "2", "--restart-budget", "0", "--telemetry-dir",
                      "tel", *TRAIN, "--save-state", "s.npz", *CHAOS],
    }
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
           "MNIST_DATA_DIR": str(root)}
    out = {}
    for name, cmd in runs.items():
        workdir = tmp_path_factory.mktemp(name)
        cmd = [*cmd[:3], f"--master_port={_free_port()}", *cmd[3:]]
        out[name] = (subprocess.Popen(cmd, cwd=workdir, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True), workdir)
    yield out
    for proc, _ in out.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def _done(worlds, name: str, code: int):
    proc, workdir = worlds[name]
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == code, err[-3000:]
    return out, err, workdir


def test_a_killed_rank_restarts_the_gang_to_the_uninterrupted_bits(worlds):
    _, _, ref = _done(worlds, "uninterrupted", 0)
    out, _, workdir = _done(worlds, "restarted", 0)
    prom = (workdir / "tel" / "launcher.prom").read_text().splitlines()
    events = read_events(str(workdir / "tel" / "events-launcher.jsonl"))
    assert [e["event"] for e in events] == ["rank_death", "gang_restart"]
    assert "launch_restarts_total 1" in prom
    _assert_the_killed_rank_or_its_peer(events[0], prom)
    assert (events[1]["attempt"], events[1]["restart_count"]) == (1, 1)
    # both incarnations formed their world, each at its first attempt
    for rank in (0, 1):
        rdzv = read_events(str(workdir / "tel" / f"events-rdzv-rank{rank}.jsonl"))
        assert [(e["event"], e["attempts"], e["ok"]) for e in rdzv] == [
            ("rendezvous", 1, True)] * 2
    assert sorted(p.name for p in (workdir / "tel").glob("*.hb")) == ["rank0.hb", "rank1.hb"]
    # the restarted world resumed the step-3 archive: epoch 1 from batch 3
    assert out.count("Train Epoch: 1 [0/256") == 1
    assert out.count("Train Epoch: 1 [192/256") == 2
    with np.load(workdir / "s.npz") as got, np.load(ref / "s.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert np.array_equal(got[k], want[k]), k


def _assert_the_killed_rank_or_its_peer(death: dict, prom: list[str]) -> None:
    """Rank 1 died by the kill (137); rank 0, whose all-reduce lost its
    peer, may exit (1) before the supervisor's next poll, and the first
    dead rank in rank order is the one reported, as in the JAX launcher."""
    assert (death["rank"], death["reason"], death["exit_code"]) in ((1, "exit", 137),
                                                                    (0, "exit", 1))
    assert f'rank_deaths_total{{rank="{death["rank"]}"}} 1' in prom


def test_without_a_budget_the_same_kill_exits_69(worlds):
    _, err, workdir = _done(worlds, "exhausted", jax_elastic.EXIT_GANG)
    assert elastic.EXIT_GANG == 69
    assert re.search(r"launch: gang failed: rank [01] died \(exit (137|1)\) and the restart "
                     r"budget \(0\) is exhausted", err), err[-2000:]
    events = read_events(str(workdir / "tel" / "events-launcher.jsonl"))
    assert [e["event"] for e in events] == ["rank_death", "gang_exhausted"]
    _assert_the_killed_rank_or_its_peer(
        events[0], (workdir / "tel" / "launcher.prom").read_text().splitlines())
    assert "launch_restarts_total" not in (workdir / "tel" / "launcher.prom").read_text()


def test_the_launcher_takes_every_flag_of_the_jax_launcher_with_its_defaults():
    from pytorch_mnist_ddp_tpu.parallel import launch as jax_launch
    from pytorch_mnist_ddp_tpu_torch.parallel import launch

    ref, port = jax_launch.build_parser(), launch.build_parser()
    options = lambda p: {o for a in p._actions for o in a.option_strings}  # noqa: E731
    assert options(ref) <= options(port)
    want = vars(ref.parse_args(["x.py"]))
    got = vars(port.parse_args(["x.py"]))
    assert {k: got[k] for k in want if k in got} == {k: v for k, v in want.items() if k in got}
    assert set(want) - set(got) == {"script", "script_args"}  # -m/program here


@pytest.mark.parametrize("argv", [
    ["--epochs", "2", "--chaos", "kill:step:after=3", "--chaos-seed", "4", "--lr", "1"],
    ["--chaos=fail:data_next", "--chaos-seed=2", "x"],
    ["--chaos"],
    ["a", "--chaos", "--chaos-seed", "b"],
])
def test_strip_chaos_args_is_the_jax_one(argv):
    assert elastic.strip_chaos_args(argv) == jax_elastic.strip_chaos_args(argv)
    assert not any(a.startswith("--chaos") for a in elastic.strip_chaos_args(argv))


@pytest.mark.parametrize("seed", [0, 5])
def test_the_restart_ladder_is_the_jax_one(seed):
    kwargs = dict(restart_budget=4, backoff_base_s=0.5, backoff_max_s=3.0, seed=seed)
    port = elastic.GangSupervisor(lambda r, c: None, 2, **kwargs)
    ref = jax_elastic.GangSupervisor(lambda r, c: None, 2, **kwargs)
    assert [port.backoff_s(a) for a in range(6)] == [ref.backoff_s(a) for a in range(6)]


def test_a_silent_heartbeat_is_a_hung_rank(tmp_path):
    """A child that beats once and then sleeps is caught by the age of
    its heartbeat; with no budget the gang is exhausted."""
    code = ("import os, time\n"
            "open(os.environ['HB'], 'a').close()\n"
            "time.sleep(60)\n")
    spawned = []

    def spawn(rank, restart_count):
        proc = subprocess.Popen(
            [sys.executable, "-c", code], start_new_session=True,
            env={**os.environ, "HB": elastic.heartbeat_path(str(tmp_path), rank)})
        spawned.append(proc)
        return proc

    registry = Registry()

    class Sink(list):
        def emit(self, event, **fields):
            self.append((event, fields))

        def __bool__(self):  # a sink, even before its first event
            return True

    sink = Sink()
    t0 = time.monotonic()
    code_ = elastic.GangSupervisor(spawn, 1, restart_budget=0, grace_s=1.0,
                                   heartbeat_dir=str(tmp_path), heartbeat_timeout_s=0.5,
                                   poll_s=0.05, registry=registry, sink=sink).run()
    assert code_ == elastic.EXIT_GANG and time.monotonic() - t0 < 20
    assert [e for e, _ in sink] == ["rank_death", "gang_exhausted"]
    assert sink[0][1]["reason"] == "heartbeat" and sink[0][1]["heartbeat_age_s"] > 0.5
    assert registry.gauge("rank_heartbeat_age_seconds", rank=0).value > 0.5
    assert all(p.poll() is not None for p in spawned)
