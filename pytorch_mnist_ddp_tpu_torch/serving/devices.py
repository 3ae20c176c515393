"""Replica planning for the serving pool: which cards each replica runs on.

The JAX package's ``parallel/mesh.py`` replica functions
(``replica_devices``, ``parse_shard_kind``, ``parse_replica_shapes``,
``replica_mesh``, ``plan_replica_meshes``), with their error messages.  A
``dp`` replica is one whole model on one device; a replica count beyond the
visible cards wraps round-robin (replica ``i`` on ``cuda:(i %
device_count)``), so a pool of two runs on one card, each replica on a CUDA
stream of its own.

A sharded replica (``tpK``, ``vtpK``, ``epK``, ``ppK``) spans ``K``
devices: its :class:`ReplicaMesh` holds the kind, ``K``, the ordered device
list and the sizes of JAX's ``(data, model)`` axes.  TP and PP ride the
model axis (``(1, K)``: every shard sees the whole batch), EP the data axis
(``(K, 1)``: the rows split over the expert shards).  A plan gives the
multi-device replicas disjoint consecutive blocks of the visible devices and
refuses one that needs more than there are ("multi-device replicas never
share chips").  The planners take an explicit device list and, as JAX's,
do not ask its entries to be distinct: a list of one card ``K`` times runs
the shards one after another on that card (a correctness run, not a
sharding speed).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from ..device import resolve_device

SHARD_KINDS = ("dp", "tp", "vtp", "ep", "pp")


@dataclass(frozen=True)
class ReplicaMesh:
    """One replica's devices: ``kind`` and ``k`` (``"tp"``, 4), the ordered
    device list (shard ``i`` on ``devices[i]``; the replica's inputs and
    answers live on ``devices[0]``) and JAX's ``data`` x ``model`` axis
    sizes."""

    kind: str
    k: int
    devices: tuple[torch.device, ...]
    data: int = 1
    model: int = 1


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


def replica_mesh(kind: str, k: int, devices: Sequence[torch.device]) -> ReplicaMesh:
    """The mesh one replica of shape ``(kind, k)`` dispatches on, over the
    first ``k`` of ``devices`` (JAX ``replica_mesh``)."""
    if len(devices) < k:
        raise ValueError(
            f"replica shape {kind}{k} needs {k} devices, got {len(devices)}"
        )
    devs = tuple(torch.device(d) for d in devices[:k])
    if kind == "dp":
        return ReplicaMesh("dp", 1, devs[:1])
    if kind in ("tp", "vtp"):
        return ReplicaMesh(kind, k, devs, data=1, model=k)
    if kind == "ep":
        return ReplicaMesh(kind, k, devs, data=k, model=1)
    if kind == "pp":
        from ..parallel.pp import NUM_STAGES

        if k != NUM_STAGES:
            raise ValueError(
                f"pipeline replicas are {NUM_STAGES}-stage, got pp{k}"
            )
        return ReplicaMesh(kind, k, devs, data=1, model=k)
    raise ValueError(f"unknown shard kind {kind!r}")


def plan_replica_meshes(
    shapes: Sequence[tuple[str, int]],
    devices: Sequence[torch.device] | None = None,
) -> list[tuple[str, int, ReplicaMesh]]:
    """Consecutive device blocks for a replica-shape plan, each replica's
    mesh: ``[(kind, k, mesh), ...]`` (JAX ``plan_replica_meshes``).  An
    all-``dp`` plan wraps round-robin as :func:`replica_devices` does; a
    plan with a multi-device replica takes disjoint blocks and raises when
    it needs more devices than ``devices`` holds."""
    pool = list(devices if devices is not None else visible_devices())
    if not pool:
        raise ValueError("no devices visible to this process")
    if all(k == 1 for _, k in shapes):
        assigned = replica_devices(len(shapes), pool)
        return [(kind, 1, replica_mesh(kind, 1, [dev]))
                for (kind, _), dev in zip(shapes, assigned)]
    need = sum(k for _, k in shapes)
    if need > len(pool):
        raise ValueError(
            f"replica plan {[f'{kind}{k}' for kind, k in shapes]} needs "
            f"{need} devices but only {len(pool)} are visible; "
            "multi-device replicas never share chips"
        )
    out: list[tuple[str, int, ReplicaMesh]] = []
    cursor = 0
    for kind, k in shapes:
        out.append((kind, k, replica_mesh(kind, k, pool[cursor:cursor + k])))
        cursor += k
    return out
