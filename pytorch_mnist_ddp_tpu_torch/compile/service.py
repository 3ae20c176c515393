"""Background build service: a small thread pool for startup work, so the
kernel libraries a process needs build or load CONCURRENTLY instead of
one at a time (the JAX package's ``compile/service.py``).

Why threads work here: a kernel library's build is an ``nvcc`` child
process, and waiting on it releases the GIL, so N libraries build in the
wall time of the slowest while the main thread keeps doing startup work
(the dataset upload, the checkpoint's restore).  The structural test
pins the fan-out with GIL-releasing fake jobs (tests/test_torch_compile.py),
the same jobs the JAX package's service runs in its own test.

Standard library only: jobs are opaque callables, and importing the
service starts no device.

Every job is timed and reported:

- ``compile_seconds_total{fn=<name>}``: registry counter accumulating
  wall seconds per named job (a library's build or load, a warmup rung);
- a ``compile`` span (``obs/spans.py``) with the job name as the ``fn``
  field, so the JSONL telemetry shows what was built when, for how long.
"""

from __future__ import annotations

import functools
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable

from ..obs.spans import span


def timed(name: str, call: Callable[[], Any], kind: str = "compile", registry=None,
          sink=None) -> Any:
    """Run ``call()`` in a ``kind`` span with ``fn=name``; a ``compile``
    job's wall seconds also land on ``compile_seconds_total{fn=name}``.
    The service runs every job through here, and the serial paths call
    it inline."""
    t0 = time.perf_counter()
    with span(kind, sink=sink, registry=registry, fn=name):
        out = call()
    if kind == "compile" and registry is not None:
        registry.counter(
            "compile_seconds_total",
            help="wall seconds spent building executables, per program",
            fn=name,
        ).inc(time.perf_counter() - t0)
    return out


class CompileJob:
    """Handle to one submitted job; ``result()`` blocks and re-raises."""

    __slots__ = ("name", "_future")

    def __init__(self, name: str, future: Future):
        self.name = name
        self._future = future

    def result(self, timeout: float | None = None) -> Any:
        return self._future.result(timeout)

    def done(self) -> bool:
        return self._future.done()


class CompileService:
    """Run build jobs off the main thread, several at a time.

    Parameters
    ----------
    max_workers:
        Concurrent jobs; defaults to ``min(8, cpu_count)``.  Callers that
        build kernel libraries pass at most the number of sources: more
        workers than ``nvcc`` runs only add threads.
    registry:
        Optional obs registry: each job's wall time lands on
        ``compile_seconds_total{fn=name}``.
    sink:
        Optional obs event sink: each job runs inside a ``compile`` span
        (start/end JSONL events carrying ``fn=name``).
    """

    def __init__(self, max_workers: int | None = None, registry=None, sink=None):
        if max_workers is None:
            import os

            max_workers = min(8, max(2, os.cpu_count() or 1))
        if max_workers < 1:
            raise ValueError(f"max_workers must be >= 1, got {max_workers}")
        self.max_workers = max_workers
        self._registry = registry
        self._sink = sink
        self._pool = ThreadPoolExecutor(max_workers=max_workers, thread_name_prefix="compile")
        self._lock = threading.Lock()
        self._jobs: list[CompileJob] = []

    # -- submission -----------------------------------------------------------

    def submit(self, name: str, fn: Callable[..., Any], *args, kind: str = "compile",
               **kwargs) -> CompileJob:
        """Queue ``fn(*args, **kwargs)`` under the label ``name``.

        The label is the telemetry identity (``compile_seconds_total{fn=
        name}``, the span's ``fn`` field); keep it stable across runs so
        cold and warm starts line up.  ``kind`` is the span name and
        defaults to ``compile``; other startup work sharing the pool (the
        checkpoint's restore, the dataset upload) passes e.g.
        ``kind="startup_task"`` so it never lands on the compile counter.
        """
        future = self._pool.submit(timed, name, functools.partial(fn, *args, **kwargs), kind,
                                   self._registry, self._sink)
        job = CompileJob(name, future)
        with self._lock:
            self._jobs.append(job)
        return job

    # -- rendezvous -----------------------------------------------------------

    def wait_all(self, timeout: float | None = None) -> list[Any]:
        """Block until every job submitted so far finishes; results in
        submission order.  The first job error re-raises here (later jobs
        still run to completion: the pool is not cancelled, so a failed
        startup reports the FIRST cause, not a cascade)."""
        with self._lock:
            jobs = list(self._jobs)
        return [j.result(timeout) for j in jobs]

    def shutdown(self, wait: bool = True) -> None:
        self._pool.shutdown(wait=wait)

    def __enter__(self) -> "CompileService":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown(wait=True)
