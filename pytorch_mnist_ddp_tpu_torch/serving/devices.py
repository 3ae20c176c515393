"""Replica planning for the serving pool: which card each replica runs on.

The JAX package's ``parallel/mesh.py`` replica functions
(``replica_devices``, ``parse_shard_kind``, ``parse_replica_shapes``,
``plan_replica_meshes``), with their error messages, for ``dp`` plans:
each replica is one whole model on one device, and the plan returns torch
devices instead of meshes.  A replica count beyond the visible cards wraps
round-robin (replica ``i`` on ``cuda:(i % device_count)``), so a pool of two
runs on one card, each replica on a CUDA stream of its own.

The sharded shapes (``tpK``, ``vtpK``, ``epK``, ``ppK``) parse as in the
JAX package and are then refused: a sharded replica spans K distinct
cards and is not ported yet.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..device import resolve_device

SHARD_KINDS = ("dp", "tp", "vtp", "ep", "pp")

SHARDED_NOT_PORTED = (
    "sharded replicas (tp/vtp/ep/pp, one replica over K cards) are not "
    "ported to the PyTorch/CUDA pool yet; every --replica-shapes entry "
    "must be dp"
)


def visible_devices(device: str | torch.device | None = None) -> list[torch.device]:
    """Every device a pool on ``device`` may use: each visible card for a
    bare ``cuda`` (``None`` too; raises without one), the one card of
    ``cuda:K``, or the one CPU device."""
    asked = torch.device("cuda" if device is None else device)
    dev = resolve_device(asked)
    if dev.type == "cpu" or asked.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def replica_devices(
    n: int | None = None, devices: Sequence[torch.device] | None = None
) -> list[torch.device]:
    """Device assignment for an ``n``-replica pool: ``n=None`` is one
    replica per device; ``n`` beyond the device count wraps round-robin."""
    pool = list(devices if devices is not None else visible_devices())
    if not pool:
        raise ValueError("no devices visible to this process")
    if n is None:
        return pool
    if n < 1:
        raise ValueError(f"need >= 1 replica, got {n}")
    return [pool[i % len(pool)] for i in range(n)]


def parse_shard_kind(spec: str) -> tuple[str, int]:
    """``"tp4"`` -> ``("tp", 4)``; bare ``"dp"`` -> ``("dp", 1)``."""
    s = str(spec).strip().lower()
    for kind in sorted(SHARD_KINDS, key=len, reverse=True):
        if s.startswith(kind):
            digits = s[len(kind):]
            if not digits:
                if kind == "dp":
                    return ("dp", 1)
                raise ValueError(
                    f"shard kind {spec!r} needs a device count (e.g. "
                    f"'{kind}4')"
                )
            if not digits.isdigit():
                break
            k = int(digits)
            if kind == "dp" and k != 1:
                raise ValueError(
                    f"a dp replica is 1 device by definition, got {spec!r}"
                    " (scale dp by adding replicas, not devices)"
                )
            if k < 1:
                raise ValueError(f"bad device count in {spec!r}")
            return (kind, k)
    raise ValueError(
        f"unknown replica shape {spec!r}; want one of "
        f"{', '.join(SHARD_KINDS)} with a device-count suffix"
    )


def parse_replica_shapes(spec) -> list[tuple[str, int]]:
    """``"dp,dp"`` (or a sequence of entries) -> ``[("dp", 1), ("dp", 1)]``."""
    if isinstance(spec, str):
        parts = [p for p in spec.split(",") if p.strip()]
    else:
        parts = list(spec)
    if not parts:
        raise ValueError("empty replica-shape spec")
    return [parse_shard_kind(p) for p in parts]


def plan_replica_devices(
    shapes: Sequence[tuple[str, int]],
    devices: Sequence[torch.device] | None = None,
) -> list[torch.device]:
    """One device per entry of an all-``dp`` plan, wrapping round-robin;
    any other kind raises (:data:`SHARDED_NOT_PORTED`)."""
    sharded = [f"{kind}{k}" for kind, k in shapes if kind != "dp"]
    if sharded:
        raise ValueError(f"replica plan entries {sharded}: {SHARDED_NOT_PORTED}")
    return replica_devices(len(shapes), devices)
