"""Where the port's kernel libraries are built and kept (the JAX
package's ``utils/compile_cache.py``).

The JAX package points XLA's persistent compilation cache at a directory,
so every run after the first starts from compiled executables.  The
port's counterpart is the directory ``ops/_build.py`` builds its
``nvcc`` libraries into and loads them from: ``build/torch_kernels`` at
the root of the checkout by default, or the directory that
``--compile-cache-dir`` (the trainers) or ``--cache-dir`` (the server)
names.  That directory is an ``ExecutableStore`` (``compile/aot.py``)
like the one ``--aot-cache`` names, with the same key and gate, but
without outcomes: it records nothing on a registry, as XLA's cache
records nothing.  ``--aot-cache`` is the store a trainer and a server
share and whose hits and misses a run reports; a library loads from it
when it is set, else from this directory.
"""

from __future__ import annotations

import os


def enable_persistent_cache(path: str | None = None, force: bool = False,
                            device: str | None = None) -> str | None:
    """Build and load the kernel libraries in ``path``; returns the
    directory in use, or None when there is none to set up.

    Without a path the build directory stays ``build/torch_kernels``.  A
    run on the CPU (``device="cpu"``, or no card) builds nothing, so the
    cache is off there (None, and no directory is made) unless ``force``:
    the CLIs pass it when a directory is named explicitly, operator
    intent, as the JAX CLIs do.
    Call it before the first library loads: a library this process has
    loaded stays the one it uses.  An unwritable directory returns None,
    as in the JAX package: the cache is an optimization, never a startup
    requirement."""
    import torch

    from ..ops import _build

    on_cpu = device == "cpu" or (device is None and not torch.cuda.is_available())
    if on_cpu and not force:
        return None
    if path is None:
        return str(_build.BUILD_DIR)
    try:
        return str(_build.set_build_dir(os.path.expanduser(path)))
    except OSError:
        return None
