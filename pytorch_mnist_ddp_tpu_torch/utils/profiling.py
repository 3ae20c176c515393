"""Opt-in profiling for the training CLIs (the JAX package's
``utils/profiling.py``), behind ``--profile DIR`` and ``--step-stats``.

- :func:`trace`: ``torch.profiler`` around the whole run, CPU and CUDA
  activity on the card (CPU alone on the CPU), written into ``DIR`` as a
  Chrome trace (``<host>_<pid>.<ms>.pt.trace.json``, the TensorBoard
  profiler plugin's naming) when the region closes, also when the run
  raises.  A no-op for a falsy ``logdir``, so the CLIs pass the flag
  straight through.  The profiler keeps every event of the run in
  memory until then: no schedule, no sampling, the JAX contract.
- :class:`StepStats`: per-step latency of one epoch of the per-batch
  loop; one summary line an epoch, the JAX package's text.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time

import torch

from ..obs.registry import percentile


@contextlib.contextmanager
def trace(logdir: str | None, device: torch.device | str | None = None):
    """``torch.profiler.profile`` of the region into ``logdir`` (CUDA
    activity too on a CUDA ``device``); no-op without ``logdir``."""
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device or "cpu").type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns() // 1_000_000}"
        prof.export_chrome_trace(os.path.join(logdir, f"{name}.pt.trace.json"))


class StepStats:
    """Per-step latency of one epoch's training loop.

    ``mark(result)`` waits for the step's output before it reads the
    clock (a CUDA tensor synchronizes its device), so an interval is the
    step's device and host time, not the gap between two launches: one
    sync a step, the accepted cost of an opt-in diagnostic.  Call
    ``start()`` before the loop so the first step counts."""

    def __init__(self) -> None:
        self._times: list[float] = []
        self._last: float | None = None

    def start(self) -> None:
        self._last = time.perf_counter()

    def mark(self, result: torch.Tensor | None = None) -> None:
        """Once a step, with the step's output tensor."""
        if result is not None and result.is_cuda:
            torch.cuda.synchronize(result.device)
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
        self._last = now

    def _percentile(self, q: float) -> float:
        return percentile(sorted(self._times), 100.0 * q)

    def summary_line(self, epoch: int) -> str:
        n = len(self._times)
        if not n:
            return f"Step stats epoch {epoch}: no steps recorded"
        total = sum(self._times)
        return (
            f"Step stats epoch {epoch}: {n} steps, "
            f"mean {1e3 * total / n:.2f} ms, "
            f"p50 {1e3 * self._percentile(0.5):.2f} ms, "
            f"p95 {1e3 * self._percentile(0.95):.2f} ms, "
            f"{n / total:.1f} steps/s"
        )
