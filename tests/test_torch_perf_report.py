"""The port's ``tools/perf_report.py --telemetry`` (``python -m
pytorch_mnist_ddp_tpu_torch.tools.perf_report``) held against the JAX
package's ``tools/perf_report.py``: for the same events directory both
``summarize_telemetry`` functions return the same text.

The directories: the synthetic events of ``tests/test_compile.py``
(startup), ``tests/test_faults.py`` (pool resilience),
``tests/test_scaleout.py`` (scale-out) and ``tests/test_serving.py``
(serving); what the port's ``mnist --no-cuda --telemetry-dir`` writes,
flagless and with a healed NaN step and periodic checkpoints; what the
port's serving CLI writes at ``--warmup-only``; all of them in one
directory; and what the JAX trainer writes (``tests/test_obs.py``'s
run).  One intra-op thread.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from pytorch_mnist_ddp_tpu_torch.mnist import build_parser
from pytorch_mnist_ddp_tpu_torch.serving import faults
from pytorch_mnist_ddp_tpu_torch.tools import perf_report
from pytorch_mnist_ddp_tpu_torch.trainer import fit

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_perf_report",
                                                  ROOT / "tools" / "perf_report.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX = _jax_tool()

# The synthetic fixtures of the JAX package's tests, event for event.
SYNTHETIC = {
    "startup": [  # tests/test_compile.py
        {"event": "span_end", "span": "compile", "fn": "fused_run", "duration_s": 2.0},
        {"event": "span_end", "span": "compile", "fn": "predict_step[8]", "duration_s": 0.5},
        {"event": "startup_overlap", "wall_s": 2.1,
         "tasks": {"fused_run": 2.0, "data": 1.0, "restore": 0.1}, "overlap_ratio": 0.32},
        {"event": "aot_executable", "fn": "fused_run", "outcome": "hit", "seconds": 0.2},
    ],
    "resilience": [  # tests/test_faults.py
        {"event": "replica_quarantine", "replica": "r1", "reason": "circuit_open", "flushed": 3},
        {"event": "replica_restart", "replica": "r1", "attempt": 1, "backoff_s": 0.2,
         "recovery_s": 0.35, "outcome": "restarted"},
        {"event": "replica_quarantine", "replica": "r0", "reason": "completion_stall",
         "flushed": 1},
        {"event": "replica_restart", "replica": "r0", "attempt": 1, "backoff_s": 0.2,
         "recovery_s": 0.25, "outcome": "restarted"},
        {"event": "circuit_transition", "replica": "r1", "src": "closed", "dst": "open",
         "reason": "failure_threshold"},
        {"event": "circuit_transition", "replica": "r1", "src": "open", "dst": "half-open",
         "reason": "restart_trial"},
        {"event": "circuit_transition", "replica": "r1", "src": "half-open", "dst": "closed",
         "reason": "trial_passed"},
        {"event": "replica_eject", "replica": "r2", "reason": "launch_failures", "attempts": 3},
        {"event": "request_retry"},
        {"event": "request_retry"},
    ],
    "scaleout": [  # tests/test_scaleout.py
        {"event": "serving_request", "n": 2, "latency_s": 0.010, "replica": "r0"},
        {"event": "serving_request", "n": 2, "latency_s": 0.012, "replica": "r0"},
        {"event": "serving_request", "n": 3, "latency_s": 0.030, "replica": "r1"},
        {"event": "router_decision", "policy": "cost", "replica": "r0", "rows": 2},
        {"event": "router_decision", "policy": "cost", "replica": "r1", "rows": 3},
        {"event": "replica_drain", "replica": "r1", "duration_s": 0.25},
        {"event": "replica_add", "replica": "r1", "duration_s": 0.02},
    ],
    "serving": [  # tests/test_serving.py
        {"event": "serving_request", "n": 2, "latency_s": 0.010},
        {"event": "serving_request", "n": 3, "latency_s": 0.030},
        {"event": "serving_batch", "real": 5, "bucket": 8, "fill_ratio": 0.625, "stall_s": 0.002},
    ],
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write(directory: pathlib.Path, events: list[dict], name="events-rank0.jsonl") -> str:
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / name, "w") as f:
        for e in events:
            f.write(json.dumps(e) + "\n")
    return str(directory)


def _fit(directory: pathlib.Path, *flags) -> str:
    args = build_parser().parse_args(["--epochs", "1", "--train-limit", "256",
                                      "--log-interval", "1000", "--telemetry-dir",
                                      str(directory), *flags])
    with contextlib.redirect_stdout(io.StringIO()):
        fit(args, "cpu")
    return str(directory)


@pytest.fixture(scope="module")
def port_dirs(tmp_path_factory):
    """Directories the port itself wrote: two trainer runs and a serving
    CLI's warmup."""
    root = tmp_path_factory.mktemp("port_tel")
    dirs = {"trainer": _fit(root / "trainer")}
    with faults.injected("nan:step:after=2"):
        dirs["trainer_guarded"] = _fit(root / "guarded", "--loss-guard",
                                       "--checkpoint-every-steps", "2", "--save-state",
                                       str(root / "g.npz"))
    tel = root / "serving"
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.serving", "--device", "cpu",
         "--warmup-only", "--buckets", "1,2", "--dtypes", "f32,int8", "--telemetry-dir",
         str(tel)], cwd=root, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    dirs["serving_warmup"] = str(tel)
    return dirs


def _same_text(directory: str) -> str:
    got = perf_report.summarize_telemetry(directory)
    assert got is not None
    assert got == JAX.summarize_telemetry(directory)
    return got


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_synthetic_fixture_gives_jax_text(tmp_path, name):
    _same_text(_write(tmp_path / name, SYNTHETIC[name]))


@pytest.mark.parametrize("name", ["trainer", "trainer_guarded", "serving_warmup"])
def test_port_written_directory_gives_jax_text(port_dirs, name):
    text = _same_text(port_dirs[name])
    if name.startswith("trainer"):
        assert "  steps: 4, mean" in text and "run wall:" in text
    if name == "trainer_guarded":
        assert "anomalies by kind: nan x1" in text
    if name == "serving_warmup":
        assert "startup compiles:" in text or "parity" in text


def test_every_fixture_in_one_directory(tmp_path, port_dirs):
    """Several files and runs in one directory (the summary reads each
    *.jsonl in name order)."""
    d = tmp_path / "all"
    for i, (name, events) in enumerate(sorted(SYNTHETIC.items())):
        _write(d, events, f"events-{i}-{name}.jsonl")
    for name, src in port_dirs.items():
        for path in pathlib.Path(src).glob("*.jsonl"):
            (d / f"{name}-{path.name}").write_bytes(path.read_bytes())
    _same_text(str(d))


def test_an_empty_directory_and_the_cli(tmp_path, capsys):
    assert perf_report.summarize_telemetry(str(tmp_path)) is None
    assert JAX.summarize_telemetry(str(tmp_path)) is None
    assert perf_report.main(["--telemetry", str(tmp_path)]) == 1
    assert "no parseable *.jsonl events" in capsys.readouterr().err
    d = _write(tmp_path / "s", SYNTHETIC["serving"])
    assert perf_report.main(["--telemetry", d]) == 0
    assert capsys.readouterr().out == JAX.summarize_telemetry(d) + "\n"


def test_the_verdict_half_waits_for_the_benchmark(capsys):
    assert perf_report.main([]) == 2
    assert perf_report.main(["--no-write"]) == 2
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 2 and "no benchmark yet" in err[0]


def test_jax_trainer_directory_gives_jax_text(tmp_path, monkeypatch):
    """A directory the JAX trainer wrote (tests/test_obs.py's run; its
    compiled fast path at its documented fallback, as in
    tests/test_torch_obs.py: the installed jax refuses the fast path's
    call)."""
    import argparse

    import jax
    import numpy as np

    import pytorch_mnist_ddp_tpu.data.mnist as jax_mnist
    from pytorch_mnist_ddp_tpu.compile import program as jax_program
    from pytorch_mnist_ddp_tpu.parallel.distributed import DistState
    from pytorch_mnist_ddp_tpu.trainer import fit as jax_fit

    monkeypatch.setattr(jax_program, "compiled_fastpath", lambda compiled: compiled)

    rng = np.random.RandomState(0)
    arrays = {"train": (rng.randint(0, 256, (64, 28, 28), np.uint8),
                        rng.randint(0, 10, 64).astype(np.uint8)),
              "test": (rng.randint(0, 256, (32, 28, 28), np.uint8),
                       rng.randint(0, 10, 32).astype(np.uint8))}
    def tiny(root="./data", split="train", *a, return_source=False, **kw):
        return (*arrays[split], "idx") if return_source else arrays[split]

    monkeypatch.setattr(jax_mnist, "load_mnist_arrays", tiny)
    tel = tmp_path / "telemetry"
    args = argparse.Namespace(
        batch_size=16, test_batch_size=16, epochs=1, lr=1.0, gamma=0.7, seed=1,
        log_interval=2, dry_run=True, save_model=False, fused=False, data_root="./data",
        profile=None, step_stats=False, telemetry_dir=str(tel))
    with contextlib.redirect_stdout(io.StringIO()):
        jax_fit(args, DistState(devices=jax.devices()[:1]))
    assert "steps: 1" in _same_text(str(tel))
