"""Structured JSONL event sink (the JAX package's ``obs/events.py``).

The registry (``obs/registry.py``) says what a value is now; the sink
says what happened and when: one JSON object a line, written and flushed
as the event occurs, so a run that dies mid-epoch keeps every step it
completed on disk.

Every record carries:

- ``ts``: ``time.monotonic()`` at emit, for deltas (step latency, span
  duration) that must not jump when the wall clock is stepped;
- ``wall``: ``time.time()`` at emit, to correlate with logs and hosts;
- ``run_id``: one opaque id a sink, so a directory that gathers several
  runs keeps them apart;
- ``rank``: the emitting process (0 in a world of one);
- ``event``: the event's name; the other keys are the event's own.

In a distributed run only the chief writes by default (:func:`open_sink`),
as only rank 0 prints; the other ranks get a :class:`NullSink`, so call
sites stay unconditional.
"""

from __future__ import annotations

import json
import os
import threading
import time


class NullSink:
    """Swallows events; falsy, so ``if sink:`` gates chief-only work."""

    path = None
    run_id = None

    def emit(self, event: str, **fields) -> None:
        pass

    def close(self) -> None:
        pass

    def __bool__(self) -> bool:
        return False


def _make_run_id() -> str:
    # A wall-clock prefix to sort by, a random suffix for two runs that
    # start within one second.
    return time.strftime("%Y%m%dT%H%M%SZ", time.gmtime()) + "-" + os.urandom(3).hex()


class EventSink:
    """Append-mode JSONL writer; ``emit`` is thread-safe and flushes every
    line (a crashed run keeps everything it emitted)."""

    def __init__(
        self,
        directory: str,
        run_id: str | None = None,
        rank: int = 0,
        filename: str | None = None,
    ):
        os.makedirs(directory, exist_ok=True)
        self.run_id = run_id or _make_run_id()
        self.rank = int(rank)
        self.path = os.path.join(directory, filename or f"events-rank{self.rank}.jsonl")
        self._lock = threading.Lock()
        self._f = open(self.path, "a", encoding="utf-8")

    def emit(self, event: str, **fields) -> None:
        record = {
            "ts": time.monotonic(),
            "wall": time.time(),
            "run_id": self.run_id,
            "rank": self.rank,
            "event": event,
        }
        record.update(fields)
        line = json.dumps(record, sort_keys=False)
        with self._lock:
            if self._f.closed:
                return  # a daemon thread's late emit after close: dropped
            self._f.write(line + "\n")
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()

    def __bool__(self) -> bool:
        return True


def open_sink(
    directory: str | None,
    rank: int = 0,
    distributed: bool = False,
    chief_only: bool = True,
    run_id: str | None = None,
) -> EventSink | NullSink:
    """The constructor call sites use: no ``directory``, or a non-chief
    rank of a distributed run (with ``chief_only``), gives a NullSink."""
    if not directory:
        return NullSink()
    if distributed and chief_only and rank != 0:
        return NullSink()
    return EventSink(directory, run_id=run_id, rank=rank)


def read_events(path: str) -> list[dict]:
    """One JSONL file's records, skipping blank and torn lines (a live
    run's last line may be half written)."""
    out: list[dict] = []
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue
    return out
