"""Serving metrics: request outcomes, occupancy, latency percentiles.

Every counter and reservoir lives in one :class:`~..obs.registry.Registry`,
so the same numbers back both ``/metrics`` surfaces — the JSON snapshot
and the Prometheus text (``?format=prom``).  Mutations arrive from the
HTTP handler threads and the batcher's workers; the registry's one lock
makes every read a consistent cut.  :meth:`report_lines` renders the
shutdown summary; callers print.
"""

from __future__ import annotations

import time

from ..obs.registry import Registry, percentile

_OUTCOMES = ("admitted", "completed", "rejected", "timed_out", "failed")


class ServingMetrics:
    """Counters + latency reservoirs for one serving process."""

    def __init__(self, reservoir: int = 8192, registry: Registry | None = None):
        self.registry = registry if registry is not None else Registry()
        self._reservoir = reservoir
        self._t0 = time.perf_counter()
        self._requests = {
            outcome: self.registry.counter(
                "serving_requests_total",
                help="requests by lifecycle outcome "
                "(admitted intake; completed/rejected/timed_out/failed exits)",
                outcome=outcome,
            )
            for outcome in _OUTCOMES
        }
        self._batches = self.registry.counter(
            "serving_batches_total", help="engine dispatches"
        )
        self._samples = {
            kind: self.registry.counter(
                "serving_samples_total",
                help="samples by kind (real = live rows, dispatched = bucket "
                "rows incl. padding)",
                kind=kind,
            )
            for kind in ("real", "dispatched")
        }
        self._latency = self.registry.histogram(
            "serving_request_latency_seconds",
            help="request latency, submit -> result set (reservoir window)",
            reservoir=reservoir,
        )
        self._fill = self.registry.histogram(
            "serving_batch_fill_ratio",
            help="live rows / dispatched rows per dispatch (the pow2 bucket, "
            "or the packed rows-capacity)",
            reservoir=reservoir,
        )
        self._padding_rows = self.registry.histogram(
            "serving_padding_waste_rows",
            help="padding rows per dispatch",
            reservoir=reservoir,
        )
        self._stall = self.registry.histogram(
            "serving_pipeline_stall_seconds",
            help="dispatch-thread wait for a free in-flight window slot",
            reservoir=reservoir,
        )
        self._inflight = self.registry.gauge(
            "serving_inflight_batches",
            help="batches launched on the device, result not yet read back",
        )
        self._dtype_count: dict[str, object] = {}
        self._dtype_latency: dict[str, object] = {}

    # -- counter views --------------------------------------------------------

    @property
    def completed(self) -> int:
        return self._requests["completed"].value

    @property
    def failed(self) -> int:
        return self._requests["failed"].value

    @property
    def batches(self) -> int:
        return self._batches.value

    # -- recording (any thread) -----------------------------------------------

    def record_admitted(self, n: int = 1) -> None:
        self._requests["admitted"].inc(n)

    def record_rejected(self, n: int = 1) -> None:
        self._requests["rejected"].inc(n)

    def record_timeout(self, n: int = 1) -> None:
        self._requests["timed_out"].inc(n)

    def record_failed(self, n: int = 1) -> None:
        self._requests["failed"].inc(n)

    def record_batch(self, real: int, bucket: int) -> None:
        """One dispatch: ``real`` live rows in a ``bucket``-row buffer."""
        self._batches.inc()
        self._samples["real"].inc(real)
        self._samples["dispatched"].inc(bucket)
        self._fill.observe(real / bucket if bucket else 0.0)
        self._padding_rows.observe(bucket - real)

    def record_stall(self, stall_s: float) -> None:
        self._stall.observe(stall_s)

    def set_inflight(self, depth: int) -> None:
        self._inflight.set(depth)

    def record_completed(self, latency_s: float, dtype: str | None = None) -> None:
        """One request finished; ``dtype`` also lands it on the per-variant
        count/latency families."""
        self._requests["completed"].inc()
        self._latency.observe(latency_s)
        if dtype is None:
            return
        with self.registry.locked():
            counter = self._dtype_count.get(dtype)
            if counter is None:
                counter = self._dtype_count[dtype] = self.registry.counter(
                    "serving_dtype_requests_total",
                    help="completed requests per serving dtype variant",
                    dtype=dtype,
                )
                self._dtype_latency[dtype] = self.registry.histogram(
                    "serving_dtype_latency_seconds",
                    help="request latency per serving dtype variant "
                    "(reservoir window)",
                    reservoir=self._reservoir,
                    dtype=dtype,
                )
        counter.inc()
        self._dtype_latency[dtype].observe(latency_s)

    # -- reading ----------------------------------------------------------------

    def snapshot(
        self,
        queue_depth: int | None = None,
        buckets: tuple[int, ...] | None = None,
        inflight: int | None = None,
        max_inflight: int | None = None,
    ) -> dict:
        """One consistent dict of everything (the /metrics JSON payload).
        Passed values are owned by the batcher and engine; ``queue_depth``
        is mirrored into a gauge so the Prometheus surface carries it."""
        with self.registry.locked():
            lat = sorted(self._latency.values())
            by_dtype = {
                name: (
                    self._dtype_count[name].value,
                    sorted(self._dtype_latency[name].values()),
                )
                for name in self._dtype_count
            }
            fills = self._fill.values()
            stall_count, stall_sum = self._stall.count, self._stall.sum
            real = self._samples["real"].value
            dispatched = self._samples["dispatched"].value
            batches = self.batches
            requests = {o: self._requests[o].value for o in _OUTCOMES}
        uptime = time.perf_counter() - self._t0
        occupancy = 100.0 * real / dispatched if dispatched else 0.0
        throughput = requests["completed"] / uptime if uptime > 0 else 0.0
        snap = {
            "uptime_s": uptime,
            "requests": requests,
            "batches": batches,
            "samples": {"real": real, "dispatched": dispatched},
            "batch_occupancy_pct": occupancy,
            "padding_waste_pct": 100.0 - occupancy if batches else 0.0,
            "throughput_rps": throughput,
            "samples_per_s": real / uptime if uptime > 0 else 0.0,
            "latency_ms": {
                "count": len(lat),
                "p50": 1e3 * percentile(lat, 50),
                "p95": 1e3 * percentile(lat, 95),
                "p99": 1e3 * percentile(lat, 99),
                "mean": 1e3 * sum(lat) / len(lat) if lat else 0.0,
                "max": 1e3 * lat[-1] if lat else 0.0,
            },
            "pipeline": {
                "fill_ratio_mean": sum(fills) / len(fills) if fills else 0.0,
                "stalls": stall_count,
                "stall_s_total": stall_sum,
            },
        }
        if by_dtype:
            snap["dtypes"] = {
                name: {
                    "requests": count,
                    "p50_ms": 1e3 * percentile(window, 50),
                    "p99_ms": 1e3 * percentile(window, 99),
                }
                for name, (count, window) in sorted(by_dtype.items())
            }
        gauges = [
            ("serving_uptime_seconds", "process uptime", uptime),
            ("serving_batch_occupancy_pct", "real samples / dispatched rows", occupancy),
            ("serving_throughput_rps", "completed requests per second", throughput),
        ]
        if queue_depth is not None:
            snap["queue_depth"] = queue_depth
            gauges.append(("serving_queue_depth", "admission queue depth", queue_depth))
        if inflight is not None:
            snap["pipeline"]["inflight"] = inflight
        if max_inflight is not None:
            snap["pipeline"]["max_inflight"] = max_inflight
        if buckets is not None:
            snap["buckets"] = list(buckets)
        for name, help_text, value in gauges:
            self.registry.gauge(name, help=help_text).set(value)
        return snap

    def report_lines(self, **snapshot_kwargs) -> str:
        """Human-readable multi-line summary (the caller prints it)."""
        s = self.snapshot(**snapshot_kwargs)
        r, lat = s["requests"], s["latency_ms"]
        lines = [
            "serving metrics "
            f"(uptime {s['uptime_s']:.1f}s, {s['throughput_rps']:.1f} req/s, "
            f"{s['samples_per_s']:.1f} samples/s):",
            f"  requests: {r['completed']} ok / {r['rejected']} rejected / "
            f"{r['timed_out']} timed out / {r['failed']} failed "
            f"(admitted {r['admitted']})",
            f"  batches: {s['batches']} dispatched, occupancy "
            f"{s['batch_occupancy_pct']:.1f}%, padding waste "
            f"{s['padding_waste_pct']:.1f}%",
            f"  latency: p50 {lat['p50']:.2f} ms, p95 {lat['p95']:.2f} ms, "
            f"p99 {lat['p99']:.2f} ms, max {lat['max']:.2f} ms "
            f"over {lat['count']} requests",
        ]
        if "queue_depth" in s:
            lines.append(f"  queue depth: {s['queue_depth']}")
        pipe = s["pipeline"]
        if "inflight" in pipe:
            lines.append(
                f"  pipeline: in-flight {pipe['inflight']}"
                + (f"/{pipe['max_inflight']}" if "max_inflight" in pipe else "")
                + f", mean fill {100.0 * pipe['fill_ratio_mean']:.1f}%, "
                f"{pipe['stalls']} stalls ({pipe['stall_s_total']:.3f} s total)"
            )
        for name, d in s.get("dtypes", {}).items():
            lines.append(
                f"  dtype [{name}]: {d['requests']} ok, p50 {d['p50_ms']:.2f} ms "
                f"/ p99 {d['p99_ms']:.2f} ms"
            )
        return "\n".join(lines)
