"""Serving metrics: request outcomes, occupancy, latency percentiles, the
tail surfaces (the JAX package's ``serving/metrics.py``, its names and
labels).

Every counter and reservoir lives in one :class:`~..obs.registry.Registry`,
so the same numbers back both ``/metrics`` surfaces — the JSON snapshot
and the Prometheus text (``?format=prom``).  Mutations arrive from the
HTTP handler threads and the batcher's workers; the registry's one lock
makes every read a consistent cut.  :meth:`report_lines` renders the
shutdown summary; callers print.

Families beside the request outcomes, each registered before its first
observation where a short run's exposition must already carry it:

- per QoS class: ``serving_qos_requests_total{qos=}``,
  ``serving_qos_latency_seconds{qos=}``, ``serving_shed_total{qos=}``
  (the batcher registers its classes);
- the adaptive linger: ``serving_linger_seconds`` (batcher.py);
- the wire: ``serving_wire_requests_total{format=}``,
  ``serving_wire_bytes_total{direction=}`` (the server registers them);
- the response cache: ``serving_cache_total{outcome=}`` (only with the
  cache on);
- the registry routes: ``serving_model_requests_total{model=,version=}``,
  ``serving_model_latency_seconds{...}``;
- per dtype variant: ``serving_dtype_requests_total{dtype=}``,
  ``serving_dtype_latency_seconds{dtype=}``, and the engine's
  ``serving_variant_verified{dtype=}`` gauge; the canary's
  ``serving_circuit_state{replica=}`` (circuit.py);
- the replica pool (serving/pool.py, router.py):
  ``serving_request_retries_total``, ``serving_replica_inflight{replica=}``
  (pool batchers write it instead of ``serving_inflight_batches``),
  ``serving_hedges_total{outcome=}``, and beside them, registered by the
  router and the supervisor, ``serving_hedge_dispatches_total{replica=}``,
  ``serving_replica_drain_seconds``,
  ``serving_router_decisions_total{policy=,replica=}``,
  ``serving_router_shape_decisions_total{policy=,shape_class=}`` and
  ``serving_replica_restarts_total{replica=}``; the snapshot's
  ``replicas`` block is the router's per-replica state;
- sharded replicas: ``serving_shard_devices{replica=}`` (the pool sets it
  once a replica at construction) and, for EP replicas,
  ``serving_expert_load{expert=}`` (the kept tokens a dispatch routed to
  each expert, one dispatch late);
- the fleet front (serving/fleet.py): ``fleet_scale_events_total
  {direction=}`` (:meth:`ensure_fleet`) and, registered by the fleet,
  ``fleet_backends{state=}``, ``fleet_route_decisions_total{backend=}``,
  ``fleet_backend_restarts_total{backend=}``; the snapshot's
  ``compiles`` counts kernel libraries built with nvcc;
- the rungs built (``compile/service.timed``): ``compile_seconds_total
  {fn=}`` and ``compile_programs_total{fn=}``; a server's snapshot
  carries their sum and the libraries built and loaded as ``programs``.
"""

from __future__ import annotations

import time

from ..obs.registry import Registry, percentile

HEDGE_OUTCOMES = ("won", "lost", "cancelled")

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
        # Not an outcome: a retried request still leaves through one.
        self._retries = self.registry.counter(
            "serving_request_retries_total",
            help="transparent handler resubmissions after a replica "
            "drain race or death (pool mode); the client saw no error",
        )
        self._hedges: dict[str, object] = {}
        self._dtype_count: dict[str, object] = {}
        self._dtype_latency: dict[str, object] = {}
        self._qos_count: dict[str, object] = {}
        self._qos_latency: dict[str, object] = {}
        self._shed: dict[str, object] = {}
        self._wire_requests: dict[str, object] = {}
        self._wire_bytes: dict[str, object] = {}
        self._cache: dict[str, object] = {}
        self._model_count: dict[tuple[str, str], object] = {}
        self._model_latency: dict[tuple[str, str], object] = {}
        self._expert_load: dict[str, object] = {}

    # -- counter views --------------------------------------------------------

    @property
    def admitted(self) -> int:
        return self._requests["admitted"].value

    @property
    def completed(self) -> int:
        return self._requests["completed"].value

    @property
    def rejected(self) -> int:
        return self._requests["rejected"].value

    @property
    def timed_out(self) -> int:
        return self._requests["timed_out"].value

    @property
    def failed(self) -> int:
        return self._requests["failed"].value

    @property
    def batches(self) -> int:
        return self._batches.value

    @property
    def retried(self) -> int:
        return self._retries.value

    def programs_built(self) -> int:
        """Programs this registry saw built (``compile_programs_total``
        summed over ``fn``): a serving process's warmed rungs, plus any
        rung a request reached unwarmed."""
        with self.registry.locked():
            return int(sum(
                metric.value
                for name, _, _, children in self.registry.collect()
                if name == "compile_programs_total"
                for _, metric in children
            ))

    # -- family registration (before the first observation) ---------------------

    def ensure_qos(self, qos: str) -> None:
        """One QoS class's count/latency/shed families."""
        if qos in self._qos_count:
            return
        with self.registry.locked():
            self._qos_count[qos] = self.registry.counter(
                "serving_qos_requests_total",
                help="completed requests per QoS class",
                qos=qos,
            )
            self._qos_latency[qos] = self.registry.histogram(
                "serving_qos_latency_seconds",
                help="request latency per QoS class (reservoir window)",
                reservoir=self._reservoir,
                qos=qos,
            )
            self._shed[qos] = self.registry.counter(
                "serving_shed_total",
                help="requests load-shed from the admission queue per "
                "QoS class (lowest class first under pressure)",
                qos=qos,
            )

    def ensure_fleet(self) -> None:
        """Pre-register the fleet front's families (serving/fleet.py) so a
        short run's exposition carries them before the first scale event
        or restart.  The per-backend restart counters register as each
        backend joins (``Fleet._register``); here live the families no
        backend owns."""
        for direction in ("up", "down"):
            self.registry.counter(
                "fleet_scale_events_total",
                help="autoscaler actions by direction",
                direction=direction,
            )

    def ensure_hedges(self) -> None:
        """The hedge outcome family (the router's hedger registers it when
        hedging is on)."""
        if self._hedges:
            return
        with self.registry.locked():
            for outcome in HEDGE_OUTCOMES:
                self._hedges[outcome] = self.registry.counter(
                    "serving_hedges_total",
                    help="hedged dispatches by outcome: won = the hedge's "
                    "completion was the client-visible one, lost = the "
                    "primary answered first, cancelled = a due hedge was "
                    "abandoned before or without a decisive dispatch",
                    outcome=outcome,
                )

    def ensure_wire(self) -> None:
        """Both wire formats and both byte directions."""
        if self._wire_requests:
            return
        with self.registry.locked():
            for fmt in ("json", "binary"):
                self._wire_requests[fmt] = self.registry.counter(
                    "serving_wire_requests_total",
                    help="/predict requests by wire format (json = the "
                    "default text protocol, binary = "
                    "application/x-mnist-f32)",
                    format=fmt,
                )
            for direction in ("in", "out"):
                self._wire_bytes[direction] = self.registry.counter(
                    "serving_wire_bytes_total",
                    help="/predict payload bytes by direction (request "
                    "bodies in, response bodies out)",
                    direction=direction,
                )

    def ensure_cache(self) -> None:
        """The response cache's outcome family (only with the cache on,
        so cache-off expositions are unchanged)."""
        if self._cache:
            return
        with self.registry.locked():
            for outcome in ("hit", "miss", "coalesced"):
                self._cache[outcome] = self.registry.counter(
                    "serving_cache_total",
                    help="response-cache lookups by outcome (hit = "
                    "served from cache, miss = claimed the dispatch, "
                    "coalesced = joined an identical in-flight request)",
                    outcome=outcome,
                )

    def ensure_model(self, model: str, version: str) -> None:
        """One (model, version) route's count/latency families (the
        rollout controller registers each route as it becomes servable)."""
        key = (model, version)
        if key in self._model_count:
            return
        with self.registry.locked():
            self._model_count[key] = self.registry.counter(
                "serving_model_requests_total",
                help="completed requests per served (model, version) "
                "registry route",
                model=model,
                version=version,
            )
            self._model_latency[key] = self.registry.histogram(
                "serving_model_latency_seconds",
                help="request latency per served (model, version) "
                "registry route (reservoir window)",
                reservoir=self._reservoir,
                model=model,
                version=version,
            )

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

    def record_retry(self, n: int = 1) -> None:
        self._retries.inc(n)

    def set_inflight(self, depth: int, replica: str | None = None) -> None:
        """Launched-not-yet-read batches; a pool batcher (``replica``)
        writes its own ``serving_replica_inflight{replica=}`` series, since
        N batchers on one unlabeled gauge would race."""
        if replica is None:
            self._inflight.set(depth)
            return
        self.registry.gauge(
            "serving_replica_inflight",
            help="per-replica batches launched on the device, result not "
            "yet read back (pool mode)",
            replica=replica,
        ).set(depth)

    def record_hedge(self, outcome: str) -> None:
        self.ensure_hedges()
        self._hedges[outcome].inc()

    def qos_p99_s(self, qos: str, min_samples: int = 20) -> float | None:
        """One QoS class's p99 latency (seconds) from its reservoir, the
        hedger's delay; None until ``min_samples`` observations exist."""
        hist = self._qos_latency.get(qos)
        if hist is None:
            return None
        window = hist.values()
        if len(window) < min_samples:
            return None
        return percentile(sorted(window), 99)

    def record_shard_devices(self, replica: str, devices: int) -> None:
        """Devices in REPLICA's mesh (1 = a dp replica, k = a sharded one)."""
        self.registry.gauge(
            "serving_shard_devices",
            help="devices in each replica's mesh (1 = plain DP, k = a "
            "sharded TP/EP/PP replica spanning k devices)",
            replica=replica,
        ).set(devices)

    def ensure_expert_load(self, num_experts: int) -> None:
        """Register the per-expert load gauges before the first dispatch
        records them (an EP pool's exposition carries the family)."""
        if len(self._expert_load) >= num_experts:
            return
        with self.registry.locked():
            for e in range(num_experts):
                key = str(e)
                if key not in self._expert_load:
                    self._expert_load[key] = self.registry.gauge(
                        "serving_expert_load",
                        help="tokens routed to (and kept by) each expert "
                        "in the most recent EP dispatch; max/mean across "
                        "experts is the imbalance factor",
                        expert=key,
                    )

    def record_expert_load(self, loads) -> None:
        """Per-expert kept-token counts of one EP dispatch."""
        loads = [float(v) for v in loads]
        self.ensure_expert_load(len(loads))
        for e, val in enumerate(loads):
            self._expert_load[str(e)].set(val)

    def expert_load_snapshot(self) -> dict[str, float]:
        """The per-expert load gauges' values ({} without an EP replica)."""
        return {k: g.value for k, g in sorted(self._expert_load.items())}

    def record_model_request(self, model: str, version: str, latency_s: float) -> None:
        """One request served by registry route (model, version)."""
        key = (model, version)
        if key not in self._model_count:
            self.ensure_model(model, version)
        self._model_count[key].inc()
        self._model_latency[key].observe(latency_s)

    def record_wire(self, fmt: str, bytes_in: int = 0, bytes_out: int = 0) -> None:
        """One /predict exchange on wire format ``fmt``."""
        self.ensure_wire()
        self._wire_requests[fmt].inc()
        if bytes_in:
            self._wire_bytes["in"].inc(bytes_in)
        if bytes_out:
            self._wire_bytes["out"].inc(bytes_out)

    def record_cache(self, outcome: str) -> None:
        self.ensure_cache()
        self._cache[outcome].inc()

    def record_shed(self, qos: str) -> None:
        """One request evicted from the admission queue to admit a higher
        class under pressure."""
        self.ensure_qos(qos)
        self._shed[qos].inc()

    def record_completed(
        self, latency_s: float, dtype: str | None = None, qos: str | None = None
    ) -> None:
        """One request finished; ``dtype`` also lands it on the per-variant
        families, ``qos`` on the per-class ones."""
        self._requests["completed"].inc()
        self._latency.observe(latency_s)
        if qos is not None:
            self.ensure_qos(qos)
            self._qos_count[qos].inc()
            self._qos_latency[qos].observe(latency_s)
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
        compiles: int | None = None,
        buckets: tuple[int, ...] | None = None,
        inflight: int | None = None,
        max_inflight: int | None = None,
        linger_ms: float | None = None,
        replicas: dict | None = None,
        programs: dict | None = None,
    ) -> dict:
        """One consistent dict of everything (the /metrics JSON payload).
        Passed values are owned by the batcher and engine; ``queue_depth``
        is mirrored into a gauge so the Prometheus surface carries it.
        ``compiles`` is the kernel libraries this process built with nvcc
        (the fleet front: its backends' sum).  ``replicas`` is the
        router's per-replica block (pool mode).  ``programs`` is the
        server's ``{"rungs", "library_builds", "library_loads"}``: the
        rung Programs built and the kernel libraries built and loaded,
        which a request at an unwarmed rung would move."""
        with self.registry.locked():
            lat = sorted(self._latency.values())
            by_dtype = {
                name: (
                    self._dtype_count[name].value,
                    sorted(self._dtype_latency[name].values()),
                )
                for name in self._dtype_count
            }
            by_qos = {
                name: (
                    self._qos_count[name].value,
                    sorted(self._qos_latency[name].values()),
                    self._shed[name].value,
                )
                for name in self._qos_count
            }
            cache = {o: c.value for o, c in self._cache.items()}
            hedges = {o: c.value for o, c in self._hedges.items()}
            retried = self.retried
            wire = {f: c.value for f, c in self._wire_requests.items()}
            wire_bytes = {d: c.value for d, c in self._wire_bytes.items()}
            fills = self._fill.values()
            stalls = sorted(self._stall.values())
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
            "retries": retried,
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
                "stall_ms_p95": 1e3 * percentile(stalls, 95),
            },
        }
        if by_dtype:
            snap["dtypes"] = {
                name: {
                    "requests": count,
                    "p50_ms": 1e3 * percentile(window, 50),
                    "p95_ms": 1e3 * percentile(window, 95),
                    "p99_ms": 1e3 * percentile(window, 99),
                }
                for name, (count, window) in sorted(by_dtype.items())
            }
        if by_qos:
            snap["qos"] = {
                name: {
                    "requests": count,
                    "shed": shed,
                    "p50_ms": 1e3 * percentile(window, 50),
                    "p95_ms": 1e3 * percentile(window, 95),
                    "p99_ms": 1e3 * percentile(window, 99),
                }
                for name, (count, window, shed) in sorted(by_qos.items())
            }
        if hedges:
            snap["hedges"] = dict(sorted(hedges.items()))
        if cache:
            lookups = sum(cache.values())
            snap["cache"] = {
                **dict(sorted(cache.items())),
                "hit_rate": cache.get("hit", 0) / lookups if lookups else 0.0,
            }
        if wire.get("binary"):
            # Only once a binary request was seen: JSON-only traffic keeps
            # the snapshot and the shutdown report as they were.
            snap["wire"] = {
                "requests": dict(sorted(wire.items())),
                "bytes": dict(sorted(wire_bytes.items())),
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
        if linger_ms is not None:
            snap["pipeline"]["linger_ms"] = linger_ms
        if replicas is not None:
            snap["replicas"] = replicas
        if compiles is not None:
            snap["compiles"] = compiles
        if programs is not None:
            snap["programs"] = programs
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
        if pipe["stalls"] or "inflight" in pipe:
            lines.append(
                "  pipeline: "
                + (f"in-flight {pipe['inflight']}"
                   + (f"/{pipe['max_inflight']}" if "max_inflight" in pipe else "")
                   + ", " if "inflight" in pipe else "")
                + (f"linger {pipe['linger_ms']:.2f} ms, " if "linger_ms" in pipe else "")
                + f"mean fill {100.0 * pipe['fill_ratio_mean']:.1f}%, "
                f"{pipe['stalls']} stalls "
                f"({pipe['stall_s_total']:.3f} s total, "
                f"p95 {pipe['stall_ms_p95']:.2f} ms)"
            )
        for name, q in s.get("qos", {}).items():
            lines.append(
                f"  qos [{name}]: {q['requests']} ok, {q['shed']} shed, "
                f"p50 {q['p50_ms']:.2f} ms / p95 {q['p95_ms']:.2f} ms / "
                f"p99 {q['p99_ms']:.2f} ms"
            )
        if s.get("hedges"):
            h = s["hedges"]
            placed = h.get("won", 0) + h.get("lost", 0)
            lines.append(
                f"  hedges: {h.get('won', 0)} won / {h.get('lost', 0)} lost "
                f"/ {h.get('cancelled', 0)} cancelled"
                + (f" (win rate {h.get('won', 0) / placed:.1%})" if placed else "")
            )
        if "cache" in s:
            c = s["cache"]
            lines.append(
                f"  cache: {c.get('hit', 0)} hit / {c.get('miss', 0)} miss "
                f"/ {c.get('coalesced', 0)} coalesced "
                f"(hit rate {c['hit_rate']:.1%})"
            )
        if "wire" in s:
            w = s["wire"]
            lines.append(
                f"  wire: {w['requests'].get('binary', 0)} binary / "
                f"{w['requests'].get('json', 0)} json requests, "
                f"{w['bytes'].get('in', 0)} B in / "
                f"{w['bytes'].get('out', 0)} B out"
            )
        for name, d in s.get("dtypes", {}).items():
            lines.append(
                f"  dtype [{name}]: {d['requests']} ok, p50 {d['p50_ms']:.2f} ms "
                f"/ p99 {d['p99_ms']:.2f} ms"
            )
        if "compiles" in s:
            lines.append(
                f"  compiles: {s['compiles']}"
                + (f" (buckets {s['buckets']})" if "buckets" in s else "")
            )
        return "\n".join(lines)
