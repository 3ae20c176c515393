"""The ``Program`` artifact: one startup path for the trainer's steps and
the serving engine's rungs (the JAX package's ``compile/program.py``).

A JAX ``Program`` bundles a jitted function, the abstract arguments that
fix its one signature, its AOT key and its compile span; ``build()``
traces and compiles it (or deserializes it from the store), and
``Program.call`` is then bound to the executable's C++ fast path.  The
port runs eagerly, so what a program needs before its first real call is
different:

- the **kernel libraries** it launches (``csrc/<name>.cu`` built by
  ``nvcc``; ``ops/_build.py``), loaded through its store when it has one
  (``compile/aot.py``; a warm start runs no ``nvcc``), else through the
  build directory's;
- a **run-once warm step** with example arguments: cuDNN's choice of a
  convolution plan and the first launch of each kernel happen there, not
  on a request.

``build()`` does both, once.  ``Program.name`` is the telemetry identity
(``compile_seconds_total{fn=}`` and the ``compile`` span, as in the JAX
package: ``train_step``, ``eval_step``, ``fused_run``,
``predict_step[{bucket}]``, ``predict_step[{dtype}][{bucket}]``).

Not ported: the JAX package's ``compiled_fastpath`` and the executable's
C++ dispatch.  Dispatch stays eager: a port function is already a Python
call into PyTorch's dispatcher, with no compiled executable to bind.
Nor are ``predict_config``/``train_config``/``predict_store_size``: a
store entry is a kernel library, not a (program, config) executable, so
no rung and no model version has an entry of its own and the serving
grid's size does not bound the store.  A program's libraries are loaded
only on the card: on the CPU every wrapper runs its plain version, so a
CPU program needs none.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence


class Program:
    """One startup artifact (module docstring for the contract).

    Parameters
    ----------
    name:
        Telemetry identity: the ``compile_seconds_total{fn=}`` label and
        the ``compile`` span's ``fn`` field.  Keep it stable across runs.
    libraries:
        Names of the ``csrc`` kernel libraries the program launches
        (``()`` on the CPU, where the plain versions run).
    warm:
        Optional callable run once by :meth:`build` with the example
        arguments (a serving rung's forward, waited on its stream).
    example_args:
        ``warm``'s arguments.
    store:
        Optional :class:`~.aot.ExecutableStore`: the libraries come from
        it (a hit runs no ``nvcc``), else from the build directory's.
    """

    def __init__(
        self,
        name: str,
        libraries: Sequence[str] = (),
        *,
        warm: Callable[..., Any] | None = None,
        example_args: Sequence[Any] = (),
        store=None,
    ):
        self.name = name
        self.libraries = tuple(libraries)
        self.warm = warm
        self.example_args = tuple(example_args)
        self.store = store
        self.built = False

    def build(self) -> None:
        """Load the libraries (``ops/_build.origin`` then says where each
        came from), then run the warm step once.  Idempotent.  Safe to fan
        out over a :class:`~.service.CompileService`: distinct programs
        build their libraries concurrently (``nvcc`` runs in child
        processes), and one library is built once (``ops/_build.py``'s
        per-source locks)."""
        if self.built:
            return
        from ..ops import _build

        for lib in self.libraries:
            _build.library(lib, store=self.store)
        if self.warm is not None:
            self.warm(*self.example_args)
        self.built = True


def build_programs(programs: Sequence[Program], registry=None, sink=None) -> None:
    """Fan ``Program.build`` out over a :class:`~.service.CompileService`,
    a worker a program, each timed onto ``compile_seconds_total{fn=name}``
    inside a ``compile`` span: the trainer's train and eval steps and the
    serve-prewarm program load their libraries concurrently, in the wall
    time of the slowest.  One program builds inline (no pool spun up for
    nothing), in its span all the same."""
    from .service import CompileService, timed

    if len(programs) == 1:
        timed(programs[0].name, programs[0].build, registry=registry, sink=sink)
        return
    with CompileService(max_workers=len(programs), registry=registry, sink=sink) as svc:
        for p in programs:
            svc.submit(p.name, p.build)
        svc.wait_all()
