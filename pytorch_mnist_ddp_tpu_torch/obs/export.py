"""Prometheus text exposition written to a file (the JAX package's
``obs/export.py``).  The renderer is the registry's own
(:func:`~.registry.render_prometheus`): the serving endpoint and the
training runs' ``metrics.prom`` print the same text."""

from __future__ import annotations

import os
import tempfile

from .registry import Registry, render_prometheus

__all__ = ["render_prometheus", "write_prometheus"]


def write_prometheus(registry: Registry, path: str) -> None:
    """Render ``registry`` to ``path`` atomically: a temporary file in the
    same directory, renamed over ``path``, so a scraper that re-reads the
    file never sees half of it."""
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=directory, prefix=".metrics-", suffix=".tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(render_prometheus(registry))
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
