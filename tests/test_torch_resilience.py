"""The port's resilient training runtime (``resilience/``) on the CPU,
held to the uninterrupted run bit for bit and to the JAX package's
archive format and texts.

- A run killed by ``--chaos kill:step`` (a process of its own, exit 137)
  resumes from its mid-epoch archive to the uninterrupted run's bits,
  plain and ``--pallas-opt``; the archive loads in the JAX package's
  ``load_train_state_full`` with equal extras, and the JAX
  ``MidEpochCheckpointer``'s archive of that state is the port's byte for
  byte, so it resumes in the port to the same bits.  A kill inside the checkpoint rotation leaves the
  ``.prev`` archive, which resumes the same way.
- ``nan:step`` under ``--loss-guard`` heals to the uninterrupted run bit
  for bit (``--pallas-opt``, and ``--syncbn``, whose poisoned forward
  writes the BatchNorm averages); an exhausted budget exits 70 with one
  diagnostic.
- ``hang:step`` with ``--step-timeout-s`` gives ``train_stall``, and with
  ``--stall-abort`` exit 75.
- SIGTERM lands an emergency archive and exit 143; the archive resumes
  to the uninterrupted run's bits.
- The refusals are the JAX trainer's, with its texts.

The processes that must die start together, once a module; every run
reads 256-row IDX files (4 steps an epoch at batch 64).
"""

from __future__ import annotations

import contextlib
import io
import os
import pathlib
import signal
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu.resilience import checkpoint as jax_resilience_ckpt
from pytorch_mnist_ddp_tpu.utils import checkpoint as jax_ckpt
from pytorch_mnist_ddp_tpu_torch import obs
from pytorch_mnist_ddp_tpu_torch.data.mnist import _FILES, synthetic_mnist
from pytorch_mnist_ddp_tpu_torch.mnist import build_parser
from pytorch_mnist_ddp_tpu_torch.mnist import main as cli_main
from pytorch_mnist_ddp_tpu_torch.mnist_ddp import build_parser as ddp_parser
from pytorch_mnist_ddp_tpu_torch.models.net import Net
from pytorch_mnist_ddp_tpu_torch.ops.adadelta_flat import adadelta_init_flat
from pytorch_mnist_ddp_tpu_torch.parallel.ddp import TrainState
from pytorch_mnist_ddp_tpu_torch.parallel.distributed import DistState
from pytorch_mnist_ddp_tpu_torch.resilience import (
    EXIT_STALLED,
    MidEpochCheckpointer,
    PreemptionHandler,
    ResilientRuntime,
    StepWatchdog,
)
from pytorch_mnist_ddp_tpu_torch.resilience.runtime import restore, snapshot
from pytorch_mnist_ddp_tpu_torch.serving import faults
from pytorch_mnist_ddp_tpu_torch.trainer import fit
from pytorch_mnist_ddp_tpu_torch.utils import checkpoint as ckpt
from test_torch_resume import _jax_patterns, assert_jax_text

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
LIMIT = 256
TWO = ["--epochs", "2", "--train-limit", str(LIMIT), "--log-interval", "1"]
JAX_RUNTIME_MESSAGES, _ = _jax_patterns(ROOT / "pytorch_mnist_ddp_tpu" / "resilience"
                                        / "runtime.py")


@pytest.fixture(scope="module")
def idx_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("idx")
    for split, n in (("train", LIMIT), ("test", LIMIT)):
        images, labels = synthetic_mnist(split, n)
        (root / _FILES[(split, "images")]).write_bytes(
            struct.pack(">iiii", 2051, n, 28, 28) + images.tobytes())
        (root / _FILES[(split, "labels")]).write_bytes(
            struct.pack(">ii", 2049, n) + labels.tobytes())
    return root


@pytest.fixture(autouse=True)
def _idx_dir(monkeypatch, idx_root):
    monkeypatch.setenv("MNIST_DATA_DIR", str(idx_root))


def _cli(workdir, idx_root, *flags) -> subprocess.Popen:
    """mnist.py on the CPU in a process of its own, on ``idx_root``'s data."""
    return subprocess.Popen(
        [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.mnist", "--no-cuda", *flags],
        cwd=workdir, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1",
             "MNIST_DATA_DIR": str(idx_root)})


@pytest.fixture(scope="module")
def dying(tmp_path_factory, idx_root):
    """The runs that must die, started together: ``{name: (process,
    workdir)}``."""
    runs = {
        "kill_plain": [*TWO, "--save-state", "k.npz", "--checkpoint-every-steps", "3",
                       "--chaos", "kill:step:after=6"],
        "kill_pallas_opt": [*TWO, "--pallas-opt", "--save-state", "k.npz",
                            "--checkpoint-every-steps", "3", "--chaos", "kill:step:after=6"],
        "kill_in_save": [*TWO, "--pallas-opt", "--save-state", "k.npz",
                         "--checkpoint-every-steps", "3", "--chaos", "kill:ckpt_save:after=1"],
        "stall_abort": ["--epochs", "1", "--train-limit", str(LIMIT), "--step-timeout-s",
                        "2", "--stall-abort", "--telemetry-dir", "tel", "--chaos",
                        "hang:step:after=2,for=60"],
        # SIGTERM once 5 steps are logged, while the 6th hangs
        "sigterm": [*TWO, "--pallas-opt", "--save-state", "s.npz", "--checkpoint-every-steps",
                    "100", "--telemetry-dir", "tel", "--chaos", "hang:step:after=5,for=1.5"],
    }
    out = {}
    for name, flags in runs.items():
        workdir = tmp_path_factory.mktemp(name)
        out[name] = (_cli(workdir, idx_root, *flags), workdir)
    proc, workdir = out["sigterm"]
    threading.Thread(target=_terminate_after_steps, daemon=True,
                     args=(proc, workdir / "tel" / "events-rank0.jsonl", 5)).start()
    yield out
    for proc, _ in out.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


def _terminate_after_steps(proc: subprocess.Popen, events: pathlib.Path, steps: int) -> None:
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline and proc.poll() is None:
        if events.exists() and events.read_text().count('"event": "step"') >= steps:
            proc.send_signal(signal.SIGTERM)
            return
        time.sleep(0.05)


def _wait(proc: subprocess.Popen, code: int) -> str:
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == code, err[-3000:]
    return out


def _fit(*flags, parser=build_parser):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        model, state = fit(parser().parse_args(list(flags)), "cpu")
    return model, state, out.getvalue()


_FULL: dict = {}


def _full(*flags):
    """The uninterrupted two epochs of ``flags`` (once a module)."""
    key = tuple(flags)
    if key not in _FULL:
        _FULL[key] = _fit(*TWO, *flags)
    return _FULL[key]


def _assert_same(a, b) -> None:
    (ma, sa), (mb, sb) = a[:2], b[:2]
    assert sa.step == sb.step
    for (ka, ta), (kb, tb) in zip(ma.state_dict().items(), mb.state_dict().items(), strict=True):
        assert ka == kb and torch.equal(ta, tb), ka
    la = [t for part in sa.opt for t in (part.values() if isinstance(part, dict) else [part])]
    lb = [t for part in sb.opt for t in (part.values() if isinstance(part, dict) else [part])]
    assert len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _same_archive(a, b) -> bool:
    with np.load(a) as x, np.load(b) as y:
        return sorted(x.files) == sorted(y.files) and all(
            x[k].tobytes() == y[k].tobytes() for k in x.files)


@pytest.mark.parametrize("flags", [[], ["--pallas-opt"]], ids=["plain", "pallas_opt"])
def test_kill_then_resume_is_bit_exact(dying, tmp_path, flags):
    proc, workdir = dying["kill_pallas_opt" if flags else "kill_plain"]
    _wait(proc, 137)
    path = workdir / "k.npz"
    archive, epoch, extras = ckpt.load_train_state_full(str(path))
    # saves after steps 3 and 6; killed before step 7
    assert (epoch, archive.step) == (1, 6)
    assert extras == {"epoch_in_progress": 2, "batch_cursor": 2, "seed": 1,
                      "global_batch": 64, "steps_total": 6, "samples_total": 384,
                      "world_size": 1}
    full = _full(*flags)
    resumed = _fit(*TWO[2:], "--epochs", "1", "--resume-state", str(path), "--save-state",
                   str(tmp_path / "r.npz"), *flags)
    _assert_same(resumed, full)
    assert resumed[2].startswith("Train Epoch: 2 [128/256 (50%)]")
    assert resumed[2] == full[2][full[2].index("Train Epoch: 2 [128/256"):]
    # the archive in the JAX package: its reader, then its own checkpointer
    jax_state, jax_epoch, jax_extras = jax_ckpt.load_train_state_full(str(path))
    assert (jax_epoch, jax_extras, int(jax_state.step)) == (1, extras, 6)
    jax_path = str(tmp_path / "jax.npz")
    writer = jax_resilience_ckpt.MidEpochCheckpointer(jax_path, 3, seed=1, global_batch=64,
                                                      world_size=1)
    writer.save(jax_state, epoch_in_progress=2, batch_cursor=2, steps_total=6,
                samples_total=384)
    # byte for byte the port's archive, which resumed to the uninterrupted bits
    assert _same_archive(jax_path, str(path))


def test_kill_inside_the_rotation_resumes_from_prev(dying):
    proc, workdir = dying["kill_in_save"]
    _wait(proc, 137)
    assert sorted(p.name for p in workdir.glob("k.npz*")) == ["k.npz.new", "k.npz.prev"]
    resumed = _fit(*TWO[2:], "--epochs", "2", "--resume-state", str(workdir / "k.npz"),
                   "--pallas-opt")
    _assert_same(resumed, _full("--pallas-opt"))


@pytest.mark.parametrize("flags,parser", [(["--pallas-opt"], build_parser),
                                          (["--syncbn"], ddp_parser)],
                         ids=["pallas_opt", "syncbn"])
def test_nan_under_the_loss_guard_heals_bit_exact(tmp_path, flags, parser):
    # --syncbn's slower steps: one epoch
    run = TWO if parser is build_parser else ["--epochs", "1", *TWO[2:]]
    full = _full(*flags) if parser is build_parser else _fit(*run, *flags, parser=parser)
    with faults.injected("nan:step:after=3"):
        healed = _fit(*run, *flags, "--loss-guard", "--telemetry-dir", str(tmp_path),
                      parser=parser)
    _assert_same(healed, full)
    assert healed[2] == full[2]
    prom = (tmp_path / "metrics.prom").read_text()
    assert 'train_anomalies_total{kind="nan"} 1\n' in prom
    [anomaly] = [e for e in obs.read_events(str(tmp_path / "events-rank0.jsonl"))
                 if e["event"] == "train_anomaly"]
    assert {k: anomaly[k] for k in ("kind", "epoch", "step", "attempt", "action")} == {
        "kind": "nan", "epoch": 1, "step": 3, "attempt": 1, "action": "retry"}


def test_an_exhausted_budget_exits_70_with_one_diagnostic(capsys):
    with pytest.raises(SystemExit) as exit_:
        cli_main(["--no-cuda", *TWO, "--loss-guard", "--anomaly-budget", "2", "--chaos",
                  "nan:step:after=1,count=inf"])
    assert exit_.value.code == 70
    # the IDX fixture's digest warnings (data/mnist.py) come first
    err = "\n".join(ln for ln in capsys.readouterr().err.strip().splitlines()
                    if "does not match golden" not in ln)
    assert err.count("\n") == 0 and err.startswith("fatal: step 1 of epoch 1 stayed anomalous")
    assert any(p.fullmatch(err.removeprefix("fatal: ")) for p in JAX_RUNTIME_MESSAGES)
    assert not faults.active()  # the CLI uninstalled its schedule


def test_a_hung_step_is_reported_as_train_stall(tmp_path):
    """The third step hangs 2.5 s against a 1 s timeout: one stall for that
    window (a loaded host may stall another step too)."""
    with faults.injected("hang:step:after=2,for=2.5"):
        _fit("--epochs", "1", "--train-limit", str(LIMIT), "--step-timeout-s", "1",
             "--telemetry-dir", str(tmp_path))
    stalls = [e for e in obs.read_events(str(tmp_path / "events-rank0.jsonl"))
              if e["event"] == "train_stall"]
    hung = [e for e in stalls if e["steps_total"] == 2]
    assert len(hung) == 1 and hung[0]["age_s"] > 1
    assert f"train_stalls_total {len(stalls)}\n" in (tmp_path / "metrics.prom").read_text()


def test_stall_abort_exits_75(dying):
    proc, workdir = dying["stall_abort"]
    _wait(proc, EXIT_STALLED)
    events = obs.read_events(str(workdir / "tel" / "events-rank0.jsonl"))
    assert [e["event"] for e in events if e["event"] in ("step", "train_stall")] == [
        "step", "step", "train_stall"]  # the hung third step, a 2 s timeout


def test_sigterm_lands_an_emergency_archive_and_exits_143(dying):
    proc, tmp_path = dying["sigterm"]
    events = tmp_path / "tel" / "events-rank0.jsonl"
    _wait(proc, 143)
    records = obs.read_events(str(events))
    names = [e["event"] for e in records]
    at = names.index("checkpoint")
    assert names[at + 1] == "preempt_exit" and "step" not in names[at:]
    assert (records[at]["reason"], records[at + 1]["exit_code"]) == ("preempt", 143)
    # the archive holds the state after the last step logged (the 6th, unless
    # a loaded host sent the signal late), 4 steps an epoch
    k = names[:at].count("step")
    archive, epoch, extras = ckpt.load_train_state_full(str(tmp_path / "s.npz"))
    assert (archive.step, extras["epoch_in_progress"], extras["batch_cursor"], epoch) == (
        k, (k - 1) // 4 + 1, (k - 1) % 4 + 1, (k - 1) // 4)
    resumed = _fit(*TWO[2:], "--epochs", str(2 - epoch), "--resume-state",
                   str(tmp_path / "s.npz"), "--pallas-opt")
    _assert_same(resumed, _full("--pallas-opt"))


# -- refusals -----------------------------------------------------------------

TWO_RANKS = DistState(distributed=True, rank=0, world_size=2)


@pytest.mark.parametrize("flags,parser,world,chaos,fragment", [
    (["--fused", "--checkpoint-every-steps", "1", "--save-state", "x.npz"], build_parser,
     None, None, "need the per-batch step loop; drop --fused"),
    (["--fused", "--loss-guard"], build_parser, None, None, "drop --fused"),
    (["--fused"], build_parser, None, "kill:step:after=1", "--chaos clauses at trainer sites"),
    (["--loss-guard"], ddp_parser, TWO_RANKS, None, "--loss-guard is single-controller"),
    (["--tp", "2", "--step-timeout-s", "1"], ddp_parser, TWO_RANKS, None,
     "the resilient runtime rides the DP paths"),
    (["--checkpoint-every-steps", "5"], build_parser, None, None, "add --save-state PATH"),
], ids=["fused_ckpt", "fused_guard", "fused_chaos", "guard_two_ranks", "tp", "no_save_state"])
def test_refusals_are_the_jax_trainers(flags, parser, world, chaos, fragment):
    args = parser().parse_args(["--train-limit", str(LIMIT), *flags])
    with faults.injected(chaos) if chaos else contextlib.nullcontext():
        with pytest.raises(ValueError, match=fragment) as err:
            fit(args, "cpu", dist=world)
    assert_jax_text(str(err.value))


# -- the pieces -----------------------------------------------------------------

def test_snapshot_clones_every_written_tensor_and_the_step():
    model = Net(torch.Generator().manual_seed(0), use_bn=True)
    state = TrainState(opt=adadelta_init_flat(dict(model.named_parameters())), step=5)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    snap = snapshot(model, state)
    with torch.no_grad():
        for t in [*model.parameters(), *model.buffers(), *state.opt]:
            t.add_(1)
    state.step = 6
    restore(model, state, snap)
    assert state.step == 5
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
    assert all(not t.any() for t in state.opt)
    assert sum(k.endswith(("running_mean", "running_var")) for k in before) == 4


def test_a_failed_periodic_save_is_survived_and_reported(tmp_path):
    with faults.injected("fail:ckpt_save:count=1"):
        _fit("--epochs", "1", "--train-limit", str(LIMIT), "--save-state",
             str(tmp_path / "s.npz"), "--checkpoint-every-steps", "2", "--telemetry-dir",
             str(tmp_path / "tel"))
    prom = (tmp_path / "tel" / "metrics.prom").read_text()
    assert "train_checkpoint_failures_total 1\n" in prom
    assert 'train_checkpoints_total{reason="periodic"} 1\n' in prom
    events = obs.read_events(str(tmp_path / "tel" / "events-rank0.jsonl"))
    [failed] = [e for e in events if e["event"] == "checkpoint_failed"]
    assert failed["error"].startswith("FaultError: injected fail at ckpt_save")


def test_a_failed_emergency_save_surfaces():
    class Broken(MidEpochCheckpointer):
        def save(self, *a, **k):
            raise OSError("disk full")

    preemption = PreemptionHandler(grace_s=0)
    preemption.requested, preemption.signum = True, signal.SIGTERM
    runtime = ResilientRuntime(checkpointer=Broken("unused.npz", 100), preemption=preemption,
                               prepare=lambda model, state: None)
    with pytest.raises(OSError, match="disk full"):
        runtime.after_step(None, None, epoch=1, batch_idx=0)


def test_the_grace_timer_starts_from_the_wakeup_pipe_alone():
    """The signal's byte on the wakeup pipe arms the timer without the
    Python-level handler, which waits for the main thread."""
    handler = PreemptionHandler(grace_s=60).install()
    try:
        os.write(handler._pipe[1], bytes([signal.SIGTERM]))
        deadline = time.monotonic() + 5
        while handler._timer is None and time.monotonic() < deadline:
            time.sleep(0.01)
        assert handler._timer is not None and not handler.requested
    finally:
        handler.uninstall()
    assert handler._timer is None
    assert signal.getsignal(signal.SIGTERM) is signal.SIG_DFL


def test_the_watchdog_fires_once_a_stalled_window():
    stalls = []
    dog = StepWatchdog(0.05, stalls.append, poll_s=0.01).start()
    try:
        dog.suspend()
        time.sleep(0.15)
        assert not stalls  # suspended: no window
        dog.resume()
        deadline = time.monotonic() + 10
        while not stalls and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.2)  # twenty more polls of the same window
        assert len(stalls) == 1 and stalls[0] > 0.05  # once, not once a poll
    finally:
        dog.stop()
    assert dog.stalls == len(stalls) and not threading.current_thread().daemon
