"""``span("name")``: timed regions, their events, and the profiler (the
JAX package's ``obs/spans.py``).

A span emits ``span_start``/``span_end`` events (``obs/events.py``),
records its duration into the histogram ``span_duration_seconds{span=
name}``, and with ``trace_dir`` wraps the region in the port's
``utils.profiling.trace`` (a ``torch.profiler`` Chrome trace), so "time
this" and "profile this" are one call site.

Nesting is tracked per thread: a child span's events carry ``parent`` and
``depth``, so the JSONL gives the call tree without matching end times.
"""

from __future__ import annotations

import contextlib
import threading
import time

_stack = threading.local()


def current_span() -> str | None:
    """The innermost open span on this thread, or None."""
    stack = getattr(_stack, "names", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def span(
    name: str,
    sink=None,
    registry=None,
    trace_dir: str | None = None,
    **fields,
):
    """Time a region, emit its start and end, and trace it with
    ``trace_dir``.  ``sink`` and ``registry`` are optional: a span with
    neither is a silent timer.  ``fields`` ride on both events."""
    stack = getattr(_stack, "names", None)
    if stack is None:
        stack = _stack.names = []
    parent = stack[-1] if stack else None
    depth = len(stack)
    if sink is not None:
        sink.emit("span_start", span=name, parent=parent, depth=depth, **fields)
    stack.append(name)
    t0 = time.perf_counter()
    try:
        if trace_dir:
            from ..utils.profiling import trace

            with trace(trace_dir):
                yield
        else:
            yield
    finally:
        duration = time.perf_counter() - t0
        stack.pop()
        if registry is not None:
            registry.histogram(
                "span_duration_seconds",
                help="wall duration of obs.span regions",
                span=name,
            ).observe(duration)
        if sink is not None:
            sink.emit("span_end", span=name, parent=parent, depth=depth,
                      duration_s=duration, **fields)
