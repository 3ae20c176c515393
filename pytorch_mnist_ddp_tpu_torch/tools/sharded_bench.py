"""Replica-shape sweep + the sharded structural pin (the JAX package's
``tools/sharded_bench.py``: the same two halves, flags, report keys,
``PASS``/``FAIL`` lines and exit code, plus ``--device``).

**Structural pin (fake engines).**  Fake engines whose launch returns at
once and whose batch is ready after a service delay, read back where the
port's completion worker reads a real batch (``DeviceResult.wait()``).  A
k-device TP replica's full-batch service time is ``service_ms / k``, a
1-device replica's is ``service_ms``.  An oversized request stream (every
request larger than the bucket, split client-side into full serial
batches) is driven through the port's ``MicroBatcher``, ``Replica`` and
``Router``; the pin asserts the 4-device TP replica beats the 1-device
serial dispatch by more than 25% of the wall time — structurally, not by
host-noise luck.

**Real-engine sweep.**  Every replica-shape plan (pure DP, pure TP, mixed
TP+DP, EP pair, PP pair) is then built as a REAL ``EnginePool.from_seed``
over the explicit device list ``[device] * 8``: warmed, parity-gated, and
driven through the cost router.  On one card every shard of a replica is
serialized on that card (on the CPU, on the same cores), so a rung's wall
time is a reading, not a sharding speed; the *correctness* invariants are
asserted per rung: every sharded replica's parity gate passed, and the
drive added ZERO compiles after warmup.  The compile firewall's count is
the rung Programs built (``compile_programs_total``) plus the kernel
libraries built or loaded (``ops/_build.py``); sharded rungs serve f32 and
launch no kernel.

Exits non-zero if the structural pin misses the margin, any parity gate
fails, or any real rung compiles after warmup.

Usage:
    python -m pytorch_mnist_ddp_tpu_torch.tools.sharded_bench
        [--report build/sharded/BENCH_sharded.json] [--requests 48]
        [--max-request 24] [--service-ms 40] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

NUM_CLASSES = 10
BUCKET = 8  # the fake rungs' single bucket; oversized requests split
MIN_WIN = 0.25
# The default report's directory, relative to the working directory: the
# JAX tool's default would overwrite its committed BENCH_sharded.json.
REPORT_DIR = os.path.join("build", "sharded")


# ---------------------------------------------------------------------------
# Fake half: device-faithful async-completion engines


class _FakeResult:
    """Launch returns at once; :meth:`wait` — the port's read-back of a
    launched batch (serving/engine.py ``DeviceResult``) — blocks until the
    modeled device would have finished."""

    def __init__(self, n_rows: int, delay_s: float):
        self._n = n_rows
        self._t_ready = time.perf_counter() + delay_s

    def wait(self) -> np.ndarray:
        wait = self._t_ready - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        return np.zeros((self._n, NUM_CLASSES), np.float32)


class FakeShardedEngine:
    """A replica of ``devices`` fake devices: full-batch service time is
    ``service_s / devices`` (TP splits the matmuls; DP has k=1)."""

    def __init__(self, devices: int, service_s: float):
        self.buckets = (BUCKET,)
        self.metrics = None
        self.devices = devices
        self.service_s = service_s / devices
        self.dispatches: list[int] = []

    def launch(self, staged, n):
        self.dispatches.append(n)
        return _FakeResult(len(staged), self.service_s)


def _drive_fake_rung(shapes: list[int], service_s: float,
                     requests: int, max_request: int) -> dict:
    """``shapes`` = fake-device count per replica; returns the rung row."""
    from ..serving.batcher import MicroBatcher
    from ..serving.metrics import ServingMetrics
    from ..serving.router import Replica, Router

    metrics = ServingMetrics()
    replicas, engines = [], []
    for i, k in enumerate(shapes):
        engine = FakeShardedEngine(k, service_s)
        batcher = MicroBatcher(
            engine, metrics=metrics, replica=f"r{i}",
            linger_ms=0.0, adaptive_linger=False, max_inflight=1,
            timeout_ms=300_000.0, queue_depth=512,
        )
        replica = Replica(f"r{i}", batcher, engine=engine)
        batcher.on_complete = replica.observe_latency
        batcher.start()
        replicas.append(replica)
        engines.append(engine)
    router = Router(replicas, policy="cost", registry=metrics.registry, metrics=metrics)
    # Every request is OVERSIZED (3x the bucket): it pays three full
    # serial batches on a 1-device replica, three k-times-faster batches
    # on a TP replica, and spreads chunks across a multi-replica pool.
    # The split happens client-side in bucket-sized chunks because a
    # single replica's admission honestly caps at one maximal batch.
    chunks_per_req = max_request // BUCKET + (1 if max_request % BUCKET else 0)
    x = np.zeros((BUCKET, 28, 28, 1), np.float32)
    reqs = [
        router.submit(x)
        for _ in range(requests)
        for _chunk in range(chunks_per_req)
    ]
    t0 = time.perf_counter()
    for r in reqs:
        out = r.result(grace_s=300.0)
        if out.shape != (BUCKET, NUM_CLASSES):
            raise RuntimeError(f"fake rung answered {out.shape}")
    wall = time.perf_counter() - t0
    router.stop()
    dispatched = sum(len(e.dispatches) for e in engines)
    return {
        "replica_shapes": [f"{'tp' if k > 1 else 'dp'}{k}" for k in shapes],
        "fake_devices": sum(shapes),
        "batches_dispatched": dispatched,
        "wall_s": wall,
    }


def run_structural_pin(args) -> dict:
    service_s = args.service_ms / 1e3
    rungs = {
        # One 1-device replica: the serial-dispatch baseline every
        # oversized request pays in full.
        "dp1": _drive_fake_rung([1], service_s, args.requests,
                                args.max_request),
        # One 4-device TP replica: same serial batch stream, each batch
        # 4x faster — the giant-model shape (the model does not FIT on
        # one device; DP is not an option for it).
        "tp4": _drive_fake_rung([4], service_s, args.requests,
                                args.max_request),
        # Four 1-device DP replicas: the classic scale-out answer when
        # the model does fit.
        "dp4": _drive_fake_rung([1, 1, 1, 1], service_s, args.requests,
                                args.max_request),
        # Mixed pool over 8 fake devices: tp4 + 4x dp behind the cost
        # router's per-shape-class EWMAs.
        "tp4_dp4": _drive_fake_rung([4, 1, 1, 1, 1], service_s,
                                    args.requests, args.max_request),
    }
    base = rungs["dp1"]["wall_s"]
    for row in rungs.values():
        row["speedup_vs_dp1"] = base / row["wall_s"]
    win = 1.0 - rungs["tp4"]["wall_s"] / base
    pin = {
        "service_ms": args.service_ms,
        "requests": args.requests,
        "max_request": args.max_request,
        "bucket": BUCKET,
        "rungs": rungs,
        "tp4_win_vs_dp1": win,
        "min_win": MIN_WIN,
        "passed": win > MIN_WIN,
    }
    print(f"structural pin: tp4 wall {rungs['tp4']['wall_s']:.3f}s vs "
          f"dp1 {base:.3f}s -> win {win:.1%} (need >25%)"
          f"{' PASS' if pin['passed'] else ' FAIL'}")
    return pin


# ---------------------------------------------------------------------------
# Real half: every shape plan as a live pool over [device] * 8


REAL_PLANS = [
    ("dp,dp,dp,dp", 4),
    ("tp4", 1),
    ("tp4,dp,dp,dp,dp", 5),
    ("ep2,ep2", 2),
    ("pp2,pp2", 2),
]


def _compile_count(metrics) -> int:
    """The compile firewall's count: rung Programs built plus kernel
    libraries built and loaded in this process."""
    from ..ops import _build

    return metrics.programs_built() + _build.BUILDS + _build.LOADS


def run_real_sweep(args, plans=None) -> list[dict]:
    """``plans`` (default :data:`REAL_PLANS`) as live pools, one row each."""
    from ..device import resolve_device
    from ..serving.metrics import ServingMetrics
    from ..serving.pool import EnginePool

    device = resolve_device(args.device)
    rows = []
    rng = np.random.RandomState(20260807)
    for shapes, n_replicas in REAL_PLANS if plans is None else plans:
        metrics = ServingMetrics()
        pool = EnginePool.from_seed(
            replicas=n_replicas, replica_shapes=shapes, buckets=(8, 16),
            metrics=metrics, devices=[device] * 8,
        )
        pool.warmup(parallel=True)  # parity-gates every sharded replica
        parity = {
            e.shard_kind: e.parity_report.get("f32", {})
            for e in pool.engines if e.shard_kind != "dp"
        }
        router = pool.start(router_policy="cost", linger_ms=1.0,
                            timeout_ms=120_000.0, queue_depth=512)
        compiles_before = _compile_count(metrics)
        # Oversized where the pool has the capacity to shard it (the
        # router splits across replicas); the top bucket otherwise.
        n = min(args.max_request, n_replicas * 16)
        x = rng.rand(n, 28, 28, 1).astype(np.float32)
        t0 = time.perf_counter()
        reqs = [router.submit(x) for _ in range(args.requests)]
        for r in reqs:
            out = r.result(grace_s=60.0)
            if out.shape != (n, NUM_CLASSES):
                raise RuntimeError(f"real rung {shapes!r} answered {out.shape}")
        wall = time.perf_counter() - t0
        added = _compile_count(metrics) - compiles_before
        pool.stop()
        row = {
            "replica_shapes": shapes,
            "replicas": n_replicas,
            "devices": sum(len(e.mesh.devices) for e in pool.engines),
            "wall_s": wall,
            "warmup_compiles": compiles_before,
            "additional_compiles": added,
            "parity": {
                kind: {
                    "max_abs_logit_diff": p.get("max_abs_logit_diff"),
                    "tolerance": p.get("tolerance"),
                    "passed": p.get("passed"),
                }
                for kind, p in parity.items()
            },
            "passed": added == 0 and all(
                p.get("passed") for p in parity.values()
            ) if parity else added == 0,
        }
        rows.append(row)
        print(f"real rung {shapes!r}: wall {wall:.2f}s, "
              f"warmup compiles {compiles_before}, added {added}"
              f"{' PASS' if row['passed'] else ' FAIL'}")
    return rows


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--report", default=os.path.join(REPORT_DIR, "BENCH_sharded.json"))
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--max-request", type=int, default=24)
    ap.add_argument("--service-ms", type=float, default=40.0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the real sweep's pools run (cuda: an explicit "
                    "device list of the first card, eight times)")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    pin = run_structural_pin(args)
    sweep = run_real_sweep(args)
    report = {
        "mode": "sharded-sweep",
        "host_bound_caveat": (
            f"real-rung wall times serialize every shard on one {args.device} "
            "device (an explicit device list of it, eight times); the "
            "speedup claim lives in the fake-device structural pin"
        ),
        "structural_pin": pin,
        "real_sweep": sweep,
    }
    directory = os.path.dirname(args.report)
    if directory:
        os.makedirs(directory, exist_ok=True)
    with open(args.report, "w") as f:
        json.dump(report, f, indent=2)
        f.write("\n")
    print(f"wrote {args.report}")
    ok = pin["passed"] and all(r["passed"] for r in sweep)
    print("SHARDED BENCH:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
