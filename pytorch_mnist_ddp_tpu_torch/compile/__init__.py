"""compile: the startup path (the JAX package's ``compile/``).

Get from process start to step 0, or to an open serving socket, as fast
as the card allows:

- :mod:`.service`: :class:`CompileService`, a thread pool that runs
  startup jobs off the main thread (a kernel library's ``nvcc`` build
  waits on a child process and releases the GIL), so the libraries a
  process needs build CONCURRENTLY.  Each job is timed onto
  ``compile_seconds_total{fn=}`` and a ``compile`` span.
- :mod:`.aot`: :class:`ExecutableStore`, the built kernel libraries kept
  under a key of source digest, flags and environment; a warm start
  loads them with no ``nvcc`` run, behind a gate checked before
  ``ctypes`` opens a library, and falls back to a fresh build on any
  mismatch.
- :mod:`.overlap`: :class:`StartupTasks`, named concurrent startup jobs
  with a measuring rendezvous (``startup_overlap_ratio``).
- :mod:`.program`: :class:`Program`, the libraries a trainer step or a
  serving rung needs and its run-once warm step, and
  :func:`build_programs`.

Standard library only at import: torch is imported where a library or
the environment is asked for.
"""

from __future__ import annotations

from .aot import ExecutableStore, source_digest
from .overlap import StartupTasks
from .program import Program, build_programs
from .service import CompileJob, CompileService

__all__ = [
    "CompileJob",
    "CompileService",
    "ExecutableStore",
    "Program",
    "StartupTasks",
    "build_programs",
    "source_digest",
]
