"""Startup overlap: run named startup tasks concurrently, rendezvous, and
MEASURE how much wall clock the overlap hid (the JAX package's
``compile/overlap.py``).

The fused trainer's startup would be a serial chain: the checkpoint's
restore onto the card, the dataset's upload, the kernel library's build
or load, each waiting for the last.  This runner executes them as named
jobs on a :class:`~.service.CompileService` and, at :meth:`rendezvous`,
reports

    startup_overlap_ratio = (sum of task durations - wall) / sum

0.0 when the tasks effectively ran serially (or there was only one),
approaching ``1 - max/sum`` when they fully overlapped.  The ratio is a
gauge (``startup_overlap_ratio``) and rides the ``startup_overlap`` JSONL
event with the per-task durations.

Standard library only, like the service: tasks are opaque callables.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

from .service import CompileService


class StartupTasks:
    """Named concurrent startup jobs with a measuring rendezvous.

    Usage::

        tasks = StartupTasks(service)
        tasks.add("fused_run", program.build, kind="compile")
        tasks.add("restore", restore_state)
        tasks.result("restore")              # blocks on that task only
        tasks.rendezvous()                   # everything done; ratio recorded
    """

    def __init__(self, service: CompileService, registry=None, sink=None):
        self._service = service
        self._registry = registry
        self._sink = sink
        self._lock = threading.Lock()
        self._jobs: dict[str, Any] = {}
        self._durations: dict[str, float] = {}
        # Time each task spent blocked in result() on ANOTHER task:
        # dependency serialization, which must not count as "hidden by
        # overlap" in the ratio (a chain that ran strictly serially must
        # score ~0, per the contract above).
        self._waits: dict[str, float] = {}
        self._current = threading.local()
        self._t0 = time.perf_counter()

    def add(self, name: str, fn: Callable[[], Any], kind: str = "startup_task") -> None:
        """Start ``fn`` now, under ``name``.  ``kind`` is the span name the
        service records; pass ``kind="compile"`` for the jobs that should
        land on ``compile_seconds_total``."""
        if name in self._jobs:
            raise ValueError(f"startup task {name!r} already added")

        def timed():
            self._current.name = name
            t0 = time.perf_counter()
            try:
                return fn()
            finally:
                with self._lock:
                    self._durations[name] = time.perf_counter() - t0
                self._current.name = None

        self._jobs[name] = self._service.submit(name, timed, kind=kind)

    def result(self, name: str, timeout: float | None = None) -> Any:
        """Block on ONE task (others keep running).  Called from inside
        another task's body, the blocked time is recorded against the
        CALLER as dependency wait and excluded from the overlap ratio."""
        caller = getattr(self._current, "name", None)
        if caller is None:
            return self._jobs[name].result(timeout)
        t0 = time.perf_counter()
        try:
            return self._jobs[name].result(timeout)
        finally:
            with self._lock:
                self._waits[caller] = self._waits.get(caller, 0.0) + time.perf_counter() - t0

    def duration(self, name: str) -> float | None:
        """Wall seconds ``name`` took, or None while still running.
        Includes any time the task spent waiting on another task's result:
        that wait is real startup serialization and stays in the
        attribution (the ratio, by contrast, excludes it)."""
        with self._lock:
            return self._durations.get(name)

    def wait_seconds(self, name: str) -> float:
        """Seconds ``name`` has spent blocked on other tasks' results: the
        serialization component :meth:`duration` includes and the overlap
        ratio excludes."""
        with self._lock:
            return self._waits.get(name, 0.0)

    def rendezvous(self, timeout: float | None = None) -> float:
        """Wait for every task; record and return the overlap ratio."""
        for job in self._jobs.values():
            job.result(timeout)
        wall = time.perf_counter() - self._t0
        with self._lock:
            durations = dict(self._durations)
            waits = dict(self._waits)
        # Effective (active) time per task: blocked-on-dependency time is
        # serialization, not concurrent work; counting it would report a
        # strictly serial restore -> upload chain as a large overlap win.
        total = sum(max(0.0, dur - waits.get(name, 0.0)) for name, dur in durations.items())
        ratio = max(0.0, (total - wall) / total) if total > 0 else 0.0
        if self._registry is not None:
            self._registry.gauge(
                "startup_overlap_ratio",
                help="fraction of summed startup-task time hidden by overlap",
            ).set(ratio)
        if self._sink is not None:
            fields = {}
            if any(v > 0 for v in waits.values()):
                fields["waits"] = {k: round(v, 6) for k, v in waits.items()}
            self._sink.emit(
                "startup_overlap",
                wall_s=wall,
                tasks={k: round(v, 6) for k, v in durations.items()},
                overlap_ratio=ratio,
                **fields,
            )
        return ratio
