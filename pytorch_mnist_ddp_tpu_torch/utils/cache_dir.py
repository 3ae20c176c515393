"""Single source of truth for this framework's on-disk cache tree (the
JAX package's ``utils/cache_dir.py``)."""

from __future__ import annotations

import os


def cache_root(*subdirs: str) -> str:
    """Per-user cache path ``$XDG_CACHE_HOME|~/.cache / tpu_mnist_ddp /
    *subdirs`` (not created — callers mkdir when they actually write)."""
    base = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache"
    )
    return os.path.join(base, "tpu_mnist_ddp", *subdirs)
