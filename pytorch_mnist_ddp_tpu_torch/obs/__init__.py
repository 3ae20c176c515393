"""Telemetry (the JAX package's ``obs/``): the named metrics registry and
its Prometheus text (:mod:`.registry`), the JSONL event sink
(:mod:`.events`), timed spans (:mod:`.spans`), the exposition file
(:mod:`.export`), and :class:`Telemetry`, the training runs'
``--telemetry-dir`` bundle of all of them.

Standard library only: telemetry never pays a device start.  A run
without ``--telemetry-dir`` builds none of it, and its printed lines are
the same either way.
"""

from __future__ import annotations

import os

from .events import EventSink, NullSink, open_sink, read_events
from .export import render_prometheus, write_prometheus
from .registry import Counter, Gauge, Histogram, Registry, percentile
from .spans import current_span, span

__all__ = [
    "Counter",
    "EventSink",
    "Gauge",
    "Histogram",
    "NullSink",
    "Registry",
    "Telemetry",
    "current_span",
    "open_sink",
    "percentile",
    "read_events",
    "render_prometheus",
    "span",
    "write_prometheus",
]


class Telemetry:
    """One run's telemetry: a registry, an event sink and spans.

    Events and the end-of-run exposition file are the chief's in a
    distributed run (the registry still records on every rank, for
    in-process readers); ``span`` binds this bundle's sink and registry,
    so a call site says ``with telemetry.span("epoch", epoch=3):``."""

    def __init__(
        self,
        directory: str,
        rank: int = 0,
        distributed: bool = False,
        registry: Registry | None = None,
        run_id: str | None = None,
    ):
        self.directory = directory
        self.registry = registry if registry is not None else Registry()
        self.events = open_sink(directory, rank=rank, distributed=distributed, run_id=run_id)

    def span(self, name: str, trace_dir: str | None = None, **fields):
        return span(name, sink=self.events, registry=self.registry,
                    trace_dir=trace_dir, **fields)

    def write_exposition(self, filename: str = "metrics.prom") -> str | None:
        """Render the registry to ``<dir>/metrics.prom`` (the chief only,
        as for events); returns the path, or None where gated."""
        if not self.events:
            return None
        path = os.path.join(self.directory, filename)
        write_prometheus(self.registry, path)
        return path

    def close(self) -> None:
        self.events.close()
