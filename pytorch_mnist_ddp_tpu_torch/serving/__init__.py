"""Inference serving: engine, micro-batcher, HTTP endpoint, replica pool,
fleet and CLI (``python -m pytorch_mnist_ddp_tpu_torch.serving``).

The exports load lazily (PEP 562).  The fleet front (``--fleet``,
serving/fleet.py) supervises the processes that own the card, so it must
not depend on what it supervises: ``from pytorch_mnist_ddp_tpu_torch.serving
import Fleet`` imports no torch, while ``... import EnginePool`` still
works and pays torch's import only then.
"""

_EXPORTS = {
    "batcher": (
        "AdaptiveLinger", "MicroBatcher", "RejectedError",
        "ReplicaDeadError", "RequestTimeout",
    ),
    "buckets": (
        "StagingPool", "bucket_for", "pad_to_bucket", "pow2_buckets",
        "validate_buckets",
    ),
    "cache": ("ResponseCache",),
    "circuit": ("CircuitBreaker",),
    "engine": ("InferenceEngine",),
    "faults": ("FaultError", "FaultInjector"),
    "fleet": (
        "Backend", "FakeBackendServer", "Fleet", "FleetAutoscaler",
        "FleetRouter", "FleetSupervisor", "fake_backend_spawner",
        "make_fleet_server",
    ),
    "metrics": ("ServingMetrics",),
    "pool": ("EnginePool", "ReplicaSupervisor"),
    "qos": ("DEFAULT_QOS", "QOS_CLASSES", "QoSQueue"),
    "router": ("HedgeManager", "Replica", "Router", "ShardedRequest"),
    "wire": ("WireError", "WireRequest"),
}
_EXPORT_TO_MODULE = {
    name: module for module, names in _EXPORTS.items() for name in names
}


def __getattr__(name: str):
    module = _EXPORT_TO_MODULE.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        )
    import importlib

    value = getattr(importlib.import_module(f".{module}", __name__), name)
    globals()[name] = value  # cache: the next access skips __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORT_TO_MODULE))


__all__ = sorted(_EXPORT_TO_MODULE)
