"""``--profile`` and ``--step-stats`` of the port (``utils/profiling.py``)
held against the JAX package's ``utils/profiling.py`` on the CPU.

- ``trace(dir)`` writes a Chrome trace that parses, also when the region
  raises, and is a no-op without a directory;
- ``StepStats``' line is the JAX package's ``summary_line`` text for the
  same intervals, and ``mark`` counts one interval a step;
- each training CLI prints one step-stats line an epoch under
  ``--step-stats --dry-run`` (rank 0 alone under the launcher), its
  step count the epoch's steps, and ``--profile`` leaves a trace of the
  run's ops.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import socket
import subprocess
import sys

import pytest
import torch

from pytorch_mnist_ddp_tpu.utils import profiling as jax_profiling
from pytorch_mnist_ddp_tpu_torch import mnist, mnist_ddp, vit_mnist
from pytorch_mnist_ddp_tpu_torch.utils.profiling import StepStats, trace

STATS_LINE = re.compile(r"^Step stats epoch (\d+): (\d+) steps, mean [\d.]+ ms, p50 [\d.]+ ms, "
                        r"p95 [\d.]+ ms, [\d.]+ steps/s$", re.M)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread in this module: the suite runs several workers
    at once, and their threads would otherwise contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _traces(logdir) -> list:
    return [json.loads(p.read_text()) for p in sorted(logdir.glob("*.pt.trace.json"))]


def test_trace_writes_a_parseable_capture(tmp_path):
    logdir = tmp_path / "prof"
    with trace(str(logdir), "cpu") as prof:
        assert prof is not None
        torch.ones(64, 64) @ torch.ones(64, 64)
    (capture,) = _traces(logdir)
    names = {e.get("name") for e in capture["traceEvents"]}
    assert "aten::mm" in names


@pytest.mark.parametrize("logdir", [None, ""])
def test_trace_without_a_dir_is_a_no_op(tmp_path, monkeypatch, logdir):
    monkeypatch.chdir(tmp_path)
    with trace(logdir, "cpu") as prof:
        torch.ones(3).sum()
    assert prof is None and os.listdir(tmp_path) == []


def test_trace_is_written_when_the_region_raises(tmp_path):
    with pytest.raises(RuntimeError, match="mid-run"):
        with trace(str(tmp_path), "cpu"):
            torch.ones(8).sum()
            raise RuntimeError("mid-run")
    assert len(_traces(tmp_path)) == 1


@pytest.mark.parametrize("times", [[0.01], [0.004, 0.002, 0.009, 0.003],
                                   [0.5 / (i + 1) for i in range(37)], []],
                         ids=["one", "four", "many", "none"])
def test_summary_line_is_the_jax_text(times):
    mine, theirs = StepStats(), jax_profiling.StepStats()
    mine._times, theirs._times = list(times), list(times)
    for epoch in (1, 14):
        assert mine.summary_line(epoch) == theirs.summary_line(epoch)


def test_mark_counts_one_interval_a_step():
    stats = StepStats()
    stats.start()
    for _ in range(5):
        stats.mark(torch.ones(2).sum())
    assert STATS_LINE.match(stats.summary_line(3)).groups() == ("3", "5")


def _run(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


@pytest.mark.parametrize("cli", ["mnist", "mnist_ddp", "vit_mnist"])
def test_each_cli_prints_one_stats_line_an_epoch(tmp_path, monkeypatch, cli):
    for name in ("RANK", "WORLD_SIZE", "SLURM_PROCID"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.chdir(tmp_path)
    flags = ["--no-cuda", "--dry-run", "--epochs", "2", "--step-stats",
             "--profile", str(tmp_path / "prof")]
    if cli == "vit_mnist":
        out = _run(vit_mnist.main, flags)
    else:
        out = _run({"mnist": mnist, "mnist_ddp": mnist_ddp}[cli].main,
                   [*flags, "--train-limit", "128"])
    assert [m.groups() for m in STATS_LINE.finditer(out)] == [("1", "1"), ("2", "1")]
    # the line sits between the epoch's training and its evaluation
    assert out.index("Step stats epoch 1") < out.index("Test set:")
    (capture,) = _traces(tmp_path / "prof")
    names = {e.get("name") for e in capture["traceEvents"]}
    assert "aten::addmm" in names or "aten::linear" in names


def test_only_the_chief_prints_stats_under_the_launcher(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    drop = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "SLURM_PROCID", "MASTER_ADDR", "MASTER_PORT")
    env = {k: v for k, v in os.environ.items() if k not in drop}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.parallel.launch",
         "--nproc_per_node=2", f"--master_port={port}", "-m",
         "pytorch_mnist_ddp_tpu_torch.mnist_ddp", "--no-cuda", "--epochs", "1",
         "--train-limit", "256", "--step-stats"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    # 256 rows over 2 ranks of 64: 2 steps
    assert [m.groups() for m in STATS_LINE.finditer(proc.stdout)] == [("1", "2")]
