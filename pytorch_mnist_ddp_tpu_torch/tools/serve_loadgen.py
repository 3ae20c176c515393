#!/usr/bin/env python
"""Load generator for the port's serving stack:
``python -m pytorch_mnist_ddp_tpu_torch.tools.serve_loadgen``.

The JAX package's ``tools/serve_loadgen.py`` over the port's server,
replica pool and fleet, with its flags, modes, report schemas, exit codes
and verdict lines.  It fires mixed-size /predict requests from concurrent
client threads at a serving endpoint and writes a ``BENCH_serving.json``-
style report: client-side p50/p95/p99 latency, throughput, per-status
counts (including 503 rejections — the backpressure signal), and the
server's own /metrics snapshot before and after the run.

The headline assertion is the compile firewall: mixed request sizes must
build nothing beyond the warmed rungs.  The port dispatches eagerly, so
what a request at an unwarmed rung moves is that rung's Program, built
on the request's path (a ``compile_programs_total{fn=}`` observation),
and the kernel libraries built or loaded (``ops/_build.BUILDS``/``LOADS``):
the ``programs`` block of the server's /metrics.  The tool reads their
sum before and after the run and exits nonzero if it moved (disable with
--no-check-compiles when deliberately probing an unwarmed ladder).  An
endpoint without that block (the fleet front) is read by its
``compiles``: the kernel libraries its backends built.

Two arrival models:

- **closed loop** (default): ``--concurrency`` client threads, each
  firing its next request when the previous answers.  Simple, but the
  server's own latency throttles the offered load — a pipelining win
  shows up as lower latency, not higher pressure.
- **open loop** (``--open-loop``): requests arrive on a Poisson process
  at ``--rate`` req/s *regardless of completions*, the arrival model
  real traffic actually has (and the one that exposes overlap: the
  server must absorb arrivals while earlier batches are still in
  flight).  Offered vs achieved rate both land in the report.

Default mode (``--self-serve``) spins the whole stack up in-process on a
loopback port with fresh seed weights — no checkpoint, no running server,
no network needed — on ``--device`` (``cuda``, the default, raises
without a card; ``cpu`` on request, as for the serving CLI).  Point --url
at a real server to load-test a deployment; that path imports no torch.
``--prom-dump PATH`` saves the endpoint's final Prometheus exposition
(the in-flight gauge, stall/fill histograms) for offline grepping.

Scale-out: ``--replicas N`` self-serves an N-replica engine pool behind
the queue-aware router (``--router-policy``; replica i on
``cuda:(i % cards)``, each on its own CUDA stream), and
``--replicas-sweep 1,2,4`` runs the same workload against each count in
turn, writing goodput vs. replicas at fixed p99 plus scaling efficiency
to ``--scaleout-report``.  ``--replica-shapes`` (``tp4,dp``) reaches the
pool as in the JAX tool; a plan that needs more devices than ``--device``
shows is refused with the serving CLI's words (exit 2) before anything is
built.

Tail-latency mode: ``--qos-mix interactive=0.8,batch=0.2`` labels every
request with a seeded QoS class (the ``/predict`` ``"qos"`` field) and the
report gains per-class latency percentiles; ``--hedge`` /
``--hedge-delay-ms`` enable hedged dispatch on the self-serve pool; and
``--ab-tail`` drives the SAME open-loop trace against a feature-off and a
feature-on pool, writing per-class p50/p95/p99 deltas to ``--tail-report``
and FAILING on any lost response or duplicated client-visible outcome.

Chaos mode: ``--chaos SPEC`` arms a fault schedule in
``serving/faults.py``'s grammar
(``fail:launch:r1:count=6;hang:complete:r0:for=2``) against the
self-serve pool while the workload runs, then FAILS the run on any lost
or duplicated response, any transport error, a 503 rate above
``--chaos-max-503-rate``, an unrecovered replica, or any post-restart
compile — and writes restarts, recovery times, circuit states, and the
fault receipt into the report's ``chaos`` section.

Host hot path: ``--wire {json,binary}`` picks the request format (binary
= ``application/x-mnist-f32``, serving/wire.py; bodies are pre-encoded
BEFORE the arrival clock in both formats, so the measured window never
contains request serialization), ``--repeat-dist zipf:S[:K]`` draws
payloads from a seeded zipf-popularity catalog (the response-cache hit
distribution), ``--response-cache N`` enables the self-serve server's
cache tier, and ``--hostpath-ab`` runs the whole A/B — same open-loop
trace per wire format at equal offered rate, then a zipf cache round —
into ``--hostpath-report``, failing on any lost or duplicated response,
post-warmup compile, zero cache hits, or a hit-path p99 not under the
miss-path p99.  ``--devicepath-ab`` is its device twin: bucketed against
packed, where the packed capacity ladder must warm fewer rung Programs.

The registry rounds (``--swap-at-s``, ``--canary-sweep``) drive the
port's ``serving/registry.py`` and ``rollout.py``; ``--fleet-sweep``
drives ``serving/fleet.py``: real backend processes on one
``--aot-cache`` store, or ``--fleet-fake``.

Every report defaults to a path under ``build/loadgen/`` (relative to the
working directory), so a run never overwrites the JAX tool's committed
``BENCH_*.json`` files.  ``JAXLINT_LOCKWATCH=1`` is refused (exit 2): the
port has no runtime lock-order tracer yet.

Usage::

    python -m pytorch_mnist_ddp_tpu_torch.tools.serve_loadgen --device cpu
    python -m pytorch_mnist_ddp_tpu_torch.tools.serve_loadgen --open-loop \
        --rate 500 --requests 1000
    python -m pytorch_mnist_ddp_tpu_torch.tools.serve_loadgen \
        --url http://host:8000 --requests 2000 --concurrency 32
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import threading
import time
import urllib.error
import urllib.request

# Every report's default directory, relative to the working directory:
# the JAX tool's defaults would overwrite its committed BENCH_*.json.
REPORT_DIR = os.path.join("build", "loadgen")

LOCKWATCH_ENV = "JAXLINT_LOCKWATCH"


def _write_json(path: str, doc) -> None:
    """Write a report, making its directory first."""
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)


def fetch_json(url: str, payload: dict | None = None, timeout: float = 30.0) -> tuple[int, dict]:
    """One HTTP exchange -> (status, parsed body); HTTP errors are data
    here (503 IS the backpressure measurement), so they don't raise.
    Transport-level failures (connection refused/reset, timeout) return
    status 0 — under --chaos a lost RESPONSE is precisely the defect the
    harness asserts against, so it must be countable, not a dead client
    thread silently shrinking the result set."""
    req = urllib.request.Request(
        url,
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.load(resp)
    except urllib.error.HTTPError as e:
        try:
            body = json.load(e)
        except Exception:
            body = {}
        return e.code, body
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        return 0, {"error": str(e)}


def fetch_raw(
    url: str, body: bytes, headers: dict, timeout: float = 30.0
) -> tuple[int, bytes]:
    """Transport-only /predict exchange for a PRE-ENCODED body.

    The drive loops send through here so the latency-measured window
    contains zero request serialization work — bodies are built once,
    before the arrival clock starts (the per-request re-encode audit,
    pinned by tests/test_hostpath.py).  Same status-0-on-transport-error
    contract as :func:`fetch_json`."""
    req = urllib.request.Request(url, data=body, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        try:
            data = e.read()
        except Exception:
            data = b""
        return e.code, data
    except (urllib.error.URLError, OSError, TimeoutError):
        return 0, b""


def fetch_text(url: str, timeout: float = 30.0) -> str:
    """GET a text body (the Prometheus exposition for --prom-dump)."""
    req = urllib.request.Request(url, headers={"Accept": "text/plain"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read().decode()


def _encode_body(
    pixels: list, wire_fmt: str, dtype: str, qos: str | None,
    log_probs: bool = False,
) -> tuple[bytes, dict]:
    """One request's (body bytes, headers) — the SINGLE request-encode
    funnel.  Every body is built through here at PLAN time, before the
    arrival clock starts; the drive loops only move bytes (the
    re-encode-in-window audit, tests/test_hostpath.py).

    ``log_probs`` asks the JSON server for the full per-class logits —
    the equal-information response to the binary wire's raw logits
    bytes (the hostpath A/B sets it on the JSON rung so neither format
    answers with less than the other)."""
    if wire_fmt == "binary":
        import numpy as np

        from ..serving import wire

        body = wire.encode_request(
            np.asarray(pixels, np.float32), dtype=dtype, qos=qos
        )
        return body, {"Content-Type": wire.WIRE_REQUEST_TYPE}
    payload = {"instances": pixels}
    if log_probs:
        payload["return_log_probs"] = True
    if dtype != "f32":
        # The reduced-precision A/B knob: route every
        # request to one named variant; the default payload stays
        # byte-compatible with pre-dtype servers.
        payload["dtype"] = dtype
    if qos is not None:
        # The tail-latency A/B knob: name the scheduling class.  Omitted
        # = interactive (the server default), so pre-QoS payloads are
        # unchanged.
        payload["qos"] = qos
    return json.dumps(payload).encode(), {"Content-Type": "application/json"}


def _parse_repeat_dist(spec: str) -> tuple[float, int]:
    """``zipf:S[:K]`` -> (exponent, catalog size).  Rank r of K distinct
    payloads is drawn with probability proportional to r^-S — the
    classic popularity skew a response cache actually meets (S ~ 1 is
    web-like; bigger = spikier).  Default catalog 16."""
    parts = spec.split(":")
    if parts[0] != "zipf" or len(parts) not in (2, 3):
        raise SystemExit(
            f"--repeat-dist {spec!r} must be zipf:S or zipf:S:K "
            "(S = exponent, K = distinct payloads)"
        )
    try:
        s_exp = float(parts[1])
        catalog = int(parts[2]) if len(parts) == 3 else 16
    except ValueError:
        raise SystemExit(f"--repeat-dist {spec!r}: S/K are not numeric")
    if s_exp <= 0 or catalog < 1:
        raise SystemExit(
            f"--repeat-dist {spec!r}: need S > 0 and K >= 1"
        )
    return s_exp, catalog


def build_plan(args, send_qos: bool = True) -> dict:
    """The full request plan, encoded BEFORE the clock starts: per-
    request pre-built bodies + headers, sizes, seeded QoS labels, and —
    with ``--repeat-dist`` — the payload catalog structure (which
    requests repeat an earlier payload; the cache A/B's client-side
    hit/miss split reads it).  Deterministic from --seed."""
    requests = args.requests
    rng = random.Random(args.seed)
    wire_fmt = getattr(args, "wire", "json") or "json"
    repeat_spec = getattr(args, "repeat_dist", None)
    if requests > 20000 and not repeat_spec:
        # Pre-encoding holds one body per DISTINCT payload for the whole
        # run (the encode-outside-the-window contract); with no repeat
        # catalog that is O(requests) resident bodies.  Say so rather
        # than surprise the host at six figures.
        print(
            f"note: pre-encoding {requests} distinct request bodies "
            "up front (~KBs each); use --repeat-dist zipf:S:K to bound "
            "the catalog for very large runs"
        )
    if repeat_spec:
        s_exp, catalog_n = _parse_repeat_dist(repeat_spec)
        catalog_n = min(catalog_n, requests)
        weights = [1.0 / (r ** s_exp) for r in range(1, catalog_n + 1)]
        payload_ids = rng.choices(
            range(catalog_n), weights=weights, k=requests
        )
    else:
        catalog_n = requests
        payload_ids = list(range(requests))
    # Sizes are a per-PAYLOAD property (a repeated payload is the same
    # bytes, so necessarily the same rows).
    sizes_catalog = [rng.randint(1, args.max_request) for _ in range(catalog_n)]
    mix = _parse_qos_mix(args.qos_mix) if args.qos_mix else None
    qos_labels = _draw_qos_labels(mix, requests, args.seed)
    # Encode each distinct (payload, qos) exactly once; repeats share
    # the SAME bytes object — what makes them cache hits on the wire.
    encoded: dict[tuple, tuple[bytes, dict]] = {}
    bodies: list[bytes] = []
    headers: list[dict] = []
    for i, pid in enumerate(payload_ids):
        qos = qos_labels[i] if send_qos else None
        key = (pid, qos)
        if key not in encoded:
            prng = random.Random(args.seed * 1000 + pid)
            pixels = [
                [prng.randint(0, 255) for _ in range(784)]
                for _ in range(sizes_catalog[pid])
            ]
            encoded[key] = _encode_body(
                pixels, wire_fmt, args.dtype, qos,
                log_probs=getattr(args, "json_log_probs", False),
            )
        body, hdrs = encoded[key]
        bodies.append(body)
        headers.append(hdrs)
    seen: set[int] = set()
    repeat_flags = []
    for pid in payload_ids:
        repeat_flags.append(pid in seen)
        seen.add(pid)
    return {
        "bodies": bodies,
        "headers": headers,
        "sizes": [sizes_catalog[pid] for pid in payload_ids],
        "payload_ids": payload_ids,
        "repeat_flags": repeat_flags,
        "qos_labels": qos_labels,
        "distinct": catalog_n,
        "wire": wire_fmt,
        "repeat_dist": repeat_spec,
    }


def _decode_reply(wire_fmt: str, status: int, data: bytes) -> None:
    """Client-side response decode (inside the measured window, like a
    real client): JSON parses the reply document, binary views the raw
    logits.  Each format pays its own decode cost — the honest half of
    the wire A/B."""
    if status != 200:
        return
    if wire_fmt == "binary":
        from ..serving import wire

        wire.decode_response(data)
    else:
        json.loads(data)


def _parse_qos_mix(spec: str) -> dict[str, float]:
    """``interactive=0.8,batch=0.2`` -> class -> probability (must sum
    to ~1; names must be served classes — a typo'd class would 400 on
    every request of the featured rung and report a vacuously green
    A/B from empty percentile windows)."""
    from ..serving.qos import QOS_CLASSES

    mix: dict[str, float] = {}
    for part in spec.split(","):
        name, _, frac = part.partition("=")
        try:
            mix[name.strip()] = float(frac)
        except ValueError:
            frac = ""
        if not frac:
            raise SystemExit(
                f"--qos-mix part {part!r} must be CLASS=FRACTION"
            )
    unknown = sorted(set(mix) - set(QOS_CLASSES))
    if unknown:
        raise SystemExit(
            f"--qos-mix names unknown class(es) {unknown}; "
            f"served classes: {list(QOS_CLASSES)}"
        )
    total = sum(mix.values())
    if not 0.999 <= total <= 1.001:
        raise SystemExit(
            f"--qos-mix fractions must sum to 1, got {total:g} ({spec!r})"
        )
    return mix


def _draw_qos_labels(
    mix: dict[str, float] | None, requests: int, seed: int
) -> list[str | None]:
    """Per-request class labels, reproducible from --seed.  A None mix
    labels every request None (no qos field is sent).  The ab-tail mode
    draws ONE label trace and reuses it for both rungs, sending the
    field only on the featured rung — so the per-class percentile
    comparison slices identical request populations."""
    if not mix:
        return [None] * requests
    rng = random.Random(seed + 7919)  # distinct stream from sizes/arrivals
    names = list(mix)
    weights = [mix[n] for n in names]
    return rng.choices(names, weights=weights, k=requests)


def run_open_loop(
    url: str,
    plan: dict,
    rate: float,
    seed: int,
    timeout_s: float,
    max_workers: int,
    dtype: str = "f32",
) -> dict:
    """Poisson arrivals at ``rate`` req/s, fired independently of
    completions, bounded by ``max_workers`` outstanding requests.

    Latency is measured from each request's SCHEDULED arrival, not from
    when an executor thread picks it up — otherwise a saturated worker
    pool silently re-closes the loop and hides client-side queueing from
    the percentiles (the coordinated-omission trap open-loop load
    generation exists to avoid).  Bodies come PRE-ENCODED from ``plan``
    (build_plan): the measured window contains transport + response
    decode only, never request serialization.
    """
    from concurrent.futures import ThreadPoolExecutor

    requests = len(plan["bodies"])
    rng = random.Random(seed)
    # Pre-draw the whole arrival schedule so the trace is reproducible
    # from --seed and the firing loop does no RNG work.
    arrivals: list[float] = []
    t = 0.0
    for _ in range(requests):
        t += rng.expovariate(rate)
        arrivals.append(t)
    bodies, headers = plan["bodies"], plan["headers"]
    qos_labels = plan["qos_labels"]
    wire_fmt = plan["wire"]

    def one(i: int, scheduled: float) -> tuple[int, float, str | None]:
        status, data = fetch_raw(
            f"{url}/predict", bodies[i], headers[i], timeout=timeout_s
        )
        _decode_reply(wire_fmt, status, data)
        return status, time.perf_counter() - scheduled, qos_labels[i]

    t_start = time.perf_counter()
    last_fired = t_start
    with ThreadPoolExecutor(max_workers=max_workers) as pool:
        futures = []
        for i in range(requests):
            delay = t_start + arrivals[i] - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            last_fired = time.perf_counter()
            futures.append(pool.submit(one, i, t_start + arrivals[i]))
        results = [f.result() for f in futures]
    wall = time.perf_counter() - t_start
    # achieved rate from real fire times — if the submission loop could
    # not keep up with the schedule, the report must say so rather than
    # echo the offered rate back.
    fired_span = last_fired - t_start
    return {
        "results": results,
        "wall_s": wall,
        "sizes": plan["sizes"],
        "plan": plan,
        "mode": "open-loop",
        "dtype": dtype,
        "offered_rate_rps": rate,
        "achieved_arrival_rate_rps": requests / fired_span if fired_span > 0 else 0.0,
    }


def run_load(
    url: str,
    plan: dict,
    concurrency: int,
    timeout_s: float,
    dtype: str = "f32",
) -> dict:
    """Drive the endpoint closed-loop over ``plan``'s pre-encoded
    bodies; returns raw per-request (status, latency_s, qos)."""
    requests = len(plan["bodies"])
    bodies, headers = plan["bodies"], plan["headers"]
    qos_labels = plan["qos_labels"]
    wire_fmt = plan["wire"]
    results: list[tuple[int, float, str | None]] = []
    lock = threading.Lock()
    cursor = [0]

    def worker(wid: int) -> None:
        while True:
            with lock:
                i = cursor[0]
                if i >= requests:
                    return
                cursor[0] += 1
            t0 = time.perf_counter()
            status, data = fetch_raw(
                f"{url}/predict", bodies[i], headers[i], timeout=timeout_s
            )
            _decode_reply(wire_fmt, status, data)
            elapsed = time.perf_counter() - t0
            with lock:
                results.append((status, elapsed, qos_labels[i]))

    threads = [
        threading.Thread(target=worker, args=(w,)) for w in range(concurrency)
    ]
    t_start = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t_start
    return {
        "results": results, "wall_s": wall, "sizes": plan["sizes"],
        "plan": plan, "mode": "closed-loop", "dtype": dtype,
    }


def _compile_count(snap: dict) -> int | None:
    """The compile firewall's count on one /metrics snapshot (module
    docstring): rung Programs built plus kernel libraries built and
    loaded; an endpoint without a ``programs`` block gives its
    ``compiles``, or None."""
    programs = snap.get("programs")
    if programs is None:
        return snap.get("compiles")
    return (programs["rungs"] + programs["library_builds"]
            + programs["library_loads"])


def summarize(raw: dict, before: dict, after: dict) -> dict:
    from ..obs.registry import percentile

    results = raw["results"]
    ok = sorted(lat for status, lat, *_ in results if status == 200)
    by_status: dict[str, int] = {}
    for status, *_ in results:
        by_status[str(status)] = by_status.get(str(status), 0) + 1
    # Per-QoS-class client-side view (the tail-latency A/B reads these):
    # latency percentiles over 200s plus shed/reject counts, per class.
    by_qos: dict[str, dict] = {}
    for status, lat, *rest in results:
        qos = rest[0] if rest else None
        if qos is None:
            continue
        entry = by_qos.setdefault(qos, {"ok": [], "statuses": {}})
        entry["statuses"][str(status)] = entry["statuses"].get(str(status), 0) + 1
        if status == 200:
            entry["ok"].append(lat)
    compiles_before = _compile_count(before)
    compiles_after = _compile_count(after)
    additional = (
        compiles_after - compiles_before
        if compiles_before is not None and compiles_after is not None
        else None
    )
    # Host-path extras, present only when the new knobs were used so
    # pre-existing report schemas stay unchanged: the wire format, the
    # repeat-workload client split (first occurrence ~ cache-miss path,
    # repeat ~ hit-eligible path), and the server's cache counters.
    plan = raw.get("plan") or {}
    extras: dict = {}
    if plan.get("wire", "json") != "json" or plan.get("repeat_dist"):
        extras["wire"] = plan.get("wire", "json")
    if plan.get("repeat_dist"):
        flags = plan["repeat_flags"]
        first = sorted(
            lat for (status, lat, *_), rep in zip(results, flags)
            if status == 200 and not rep
        )
        repeat = sorted(
            lat for (status, lat, *_), rep in zip(results, flags)
            if status == 200 and rep
        )
        extras["repeat_workload"] = {
            "repeat_dist": plan["repeat_dist"],
            "distinct_payloads": plan["distinct"],
            "repeat_fraction": sum(flags) / len(flags) if flags else 0.0,
            "first_ms": {
                "count": len(first),
                "p50": 1e3 * percentile(first, 50),
                "p99": 1e3 * percentile(first, 99),
            },
            "repeat_ms": {
                "count": len(repeat),
                "p50": 1e3 * percentile(repeat, 50),
                "p99": 1e3 * percentile(repeat, 99),
            },
        }
    if after.get("cache") is not None:
        extras["server_cache"] = after.get("cache")
    return {
        **extras,
        "mode": raw.get("mode", "closed-loop"),
        "dtype": raw.get("dtype", "f32"),
        "offered_rate_rps": raw.get("offered_rate_rps"),
        "achieved_arrival_rate_rps": raw.get("achieved_arrival_rate_rps"),
        "requests": len(results),
        "request_size_range": [min(raw["sizes"]), max(raw["sizes"])],
        "wall_s": raw["wall_s"],
        # throughput_rps keeps its historical meaning (useful 200s per
        # wall second — cross-revision BENCH comparability); goodput_rps
        # is its canonical name going forward, and answered_rps is the
        # shed-inclusive rate — under shedding load the answered/goodput
        # gap is the capacity signal a dtype A/B compares.
        "throughput_rps": len(ok) / raw["wall_s"] if raw["wall_s"] else 0.0,
        "goodput_rps": len(ok) / raw["wall_s"] if raw["wall_s"] else 0.0,
        "answered_rps": len(results) / raw["wall_s"] if raw["wall_s"] else 0.0,
        "server_dtype_latency": after.get("dtypes"),
        "status_counts": by_status,
        "rejected": by_status.get("503", 0),
        "timed_out": by_status.get("504", 0),
        "latency_ms": {
            "p50": 1e3 * percentile(ok, 50),
            "p95": 1e3 * percentile(ok, 95),
            "p99": 1e3 * percentile(ok, 99),
            "mean": 1e3 * sum(ok) / len(ok) if ok else 0.0,
        },
        "qos_latency_ms": {
            qos: {
                "requests": sum(entry["statuses"].values()),
                "ok": len(entry["ok"]),
                "rejected": entry["statuses"].get("503", 0),
                "timed_out": entry["statuses"].get("504", 0),
                "p50": 1e3 * percentile(sorted(entry["ok"]), 50),
                "p95": 1e3 * percentile(sorted(entry["ok"]), 95),
                "p99": 1e3 * percentile(sorted(entry["ok"]), 99),
            }
            for qos, entry in sorted(by_qos.items())
        } or None,
        "server_qos": after.get("qos"),
        "server_hedges": after.get("hedges"),
        "server_replicas": after.get("replicas"),
        "server_batch_occupancy_pct": after.get("batch_occupancy_pct"),
        "server_padding_waste_pct": after.get("padding_waste_pct"),
        "server_queue_depth_final": after.get("queue_depth"),
        "server_pipeline": after.get("pipeline"),
        "compiles_before": compiles_before,
        "compiles_after": compiles_after,
        "additional_compiles": additional,
        "server_metrics_before": before,
        "server_metrics_after": after,
    }


def _spin_self_serve(args, replicas: int | None):
    """Start the in-process stack (single engine, or an N-replica pool
    behind the router when ``replicas``), warmed and parity-gated.
    Returns ``(server, sink, url)``; the caller owns teardown."""
    from ..obs.events import open_sink
    from ..serving import InferenceEngine, ServingMetrics
    from ..serving.engine import UnverifiedVariantError
    from ..serving.server import make_server

    metrics = ServingMetrics()
    buckets = [int(b) for b in args.buckets.split(",")]
    dtypes = (args.dtype,) if args.dtype != "f32" else ()
    packed = bool(getattr(args, "packed", False))
    int8_impl = getattr(args, "int8_impl", None) or "dot"
    batcher_kwargs = dict(
        linger_ms=args.linger_ms, queue_depth=args.queue_depth,
        timeout_ms=args.timeout_ms, max_inflight=args.max_inflight,
        adaptive_linger=not args.no_adaptive_linger,
        deadline_aware=not getattr(args, "no_deadline_close", False),
        fill_wait_ms=getattr(args, "fill_wait_ms", None),
    )
    hedge = bool(
        getattr(args, "hedge", False)
        or getattr(args, "hedge_delay_ms", None) is not None
    )
    sink = open_sink(args.telemetry_dir)
    if replicas is not None:
        from ..serving import EnginePool

        # Same convention as the serving CLI: 0 = one replica per
        # visible device (the EnginePool default).
        pool = EnginePool.from_seed(
            replicas=replicas or None, device=args.device,
            buckets=buckets, metrics=metrics,
            dtypes=dtypes, aot_cache=args.aot_cache,
            packed=packed, int8_impl=int8_impl,
            replica_shapes=getattr(args, "replica_shapes", None),
        )
        print(
            f"self-serve pool: warming buckets {list(pool.buckets)} x "
            f"dtypes {list(pool.dtypes)} x {pool.n_replicas} replicas"
        )
        pool.warmup(sink=sink)
        if args.dtype != "f32":
            pool.verify_parity(raise_on_failure=True)
        supervisor_kwargs = {}
        if getattr(args, "chaos", None):
            # Chaos cadence: the schedule compresses a production outage
            # into seconds, so detection/backoff must compress with it —
            # otherwise the smoke would time out waiting on defaults
            # sized for real fleets.
            supervisor_kwargs = dict(
                interval_s=0.02,
                stall_timeout_s=args.chaos_stall_timeout,
                backoff_base_s=0.1,
                backoff_max_s=1.0,
                restart_budget=8,
                seed=args.chaos_seed,
            )
        router = pool.start(
            router_policy=args.router_policy, sink=sink,
            supervisor_kwargs=supervisor_kwargs,
            hedge=hedge,
            hedge_delay_ms=getattr(args, "hedge_delay_ms", None),
            **batcher_kwargs
        )
        server = make_server(
            pool, metrics, port=0, batcher=router,
            response_cache=getattr(args, "response_cache", None),
            sink=sink,
        )
        threading.Thread(target=server.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{server.server_address[1]}"
        print(
            f"self-serve pool: {url} ({pool.n_replicas} replicas, "
            f"router policy {args.router_policy}, hedging "
            # The RESOLVED state: a 1-replica pool has no hedger even
            # when the flag asked for one.
            f"{'on' if hedge and pool.n_replicas > 1 else 'off'})"
        )
        return server, sink, url
    engine = InferenceEngine.from_seed(
        device=args.device, buckets=buckets, metrics=metrics, dtypes=dtypes,
        aot_cache=args.aot_cache,
        packed=packed, int8_impl=int8_impl,
    )
    print(
        f"self-serve: warming buckets {list(engine.buckets)} x dtypes "
        f"{list(engine.dtypes)}"
    )
    engine.warmup()
    if args.dtype != "f32":
        # The variant must clear its parity gate before a single
        # request routes to it (the refusal contract): fail the
        # A/B loudly rather than measure an unverified path.
        gate = engine.verify_parity()[args.dtype]
        if not gate["passed"]:
            raise UnverifiedVariantError(
                f"variant {args.dtype!r} failed its parity gate: {gate}")
        print(
            f"parity gate [{args.dtype}]: PASS "
            f"(max|dlogit| {gate['max_abs_logit_diff']:.2e} <= "
            f"{gate['tolerance']:g}, argmax identical)"
        )
    server = make_server(
        engine, metrics, port=0, sink=sink,
        response_cache=getattr(args, "response_cache", None),
        **batcher_kwargs,
    )
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    print(
        f"self-serve: {url} (in-flight window {args.max_inflight}, "
        f"adaptive linger {'off' if args.no_adaptive_linger else 'on'})"
    )
    return server, sink, url


def _teardown_self_serve(server, sink) -> None:
    if server is not None:
        server.shutdown()
        # Pool mode: stop the supervisor BEFORE the router drain (a
        # restart racing the teardown would attach a fresh batcher to a
        # router tearing its replicas down); EnginePool.stop owns that
        # ordering.  Single engine: plain batcher drain.
        if getattr(server.engine, "router", None) is not None:
            server.engine.stop(drain=True)
        else:
            server.batcher.stop(drain=True)
        server.server_close()
    if sink is not None:
        sink.close()


def _drive(args, url: str, send_qos: bool = True) -> dict:
    """Fire the configured workload (open or closed loop) at ``url``.

    ``send_qos=False`` keeps the per-request class LABELS (for the
    report's per-class slices) but omits the payload field — the
    baseline rung of the tail A/B.  The WHOLE plan (sizes, labels,
    repeat structure, encoded bodies) is built here, before the clock."""
    plan = build_plan(args, send_qos=send_qos)
    wire_note = f", wire {plan['wire']}" if plan["wire"] != "json" else ""
    repeat_note = (
        f", repeat-dist {plan['repeat_dist']} ({plan['distinct']} distinct)"
        if plan["repeat_dist"] else ""
    )
    if args.open_loop:
        print(
            f"driving {args.requests} open-loop Poisson arrivals of "
            f"1..{args.max_request} samples at {args.rate:.0f} req/s"
            f"{wire_note}{repeat_note}"
            + (f" (qos mix {args.qos_mix}"
               + (", field sent" if send_qos else ", labels only") + ")"
               if args.qos_mix else "")
        )
        return run_open_loop(
            url, plan, args.rate, args.seed, args.timeout_s,
            max_workers=args.concurrency,
            dtype=args.dtype,
        )
    print(
        f"driving {args.requests} requests of 1..{args.max_request} "
        f"samples at concurrency {args.concurrency}{wire_note}{repeat_note}"
    )
    return run_load(
        url, plan, args.concurrency, args.timeout_s, dtype=args.dtype,
    )


def _await_recovery(server, url: str, timeout_s: float) -> bool:
    """Post-chaos settle: poll until every replica is healthy (state
    active/drained/ejected and circuit not open), firing small probe
    requests so half-open circuits get the trial traffic they need to
    close — an idle pool would otherwise sit half-open forever, and the
    final prom dump would report a recovery still in flight."""
    router = server.batcher
    deadline = time.perf_counter() + timeout_s
    probe = {"instances": [[0] * 784], "normalized": True}
    while time.perf_counter() < deadline:
        stats = router.replica_stats()
        unsettled = [
            name for name, s in stats.items()
            if s["state"] in ("quarantined", "restarting")
            # Ejection is a SETTLED terminal state; its breaker is
            # force-opened permanently, so the circuit check must not
            # hold an exhausted-restart-budget replica "in flight"
            # until the wait expires.
            or (s["state"] != "ejected"
                and s.get("circuit") in ("open", "half-open"))
        ]
        if not unsettled:
            return True
        fetch_json(f"{url}/predict", probe, timeout=5.0)
        time.sleep(0.05)
    return False


def run_chaos(args, server, sink, url) -> tuple[dict, dict, dict, dict]:
    """Drive the workload under an installed fault schedule; returns
    (raw results, before, after, chaos report section).  The injector's
    virtual clock starts when the workload does, so ``at=`` clauses are
    relative to first arrival — 'kill replica 2 at t=5s' means five
    seconds into the RUN, not into warmup."""
    from ..serving import faults

    injector = faults.install(
        faults.FaultInjector(args.chaos, seed=args.chaos_seed)
    )
    print(f"chaos: armed {len(injector.specs)} clause(s): {args.chaos}")
    _status, before = fetch_json(f"{url}/metrics")
    injector.start()
    try:
        raw = _drive(args, url)
    finally:
        faults.uninstall()
    recovered = _await_recovery(server, url, args.chaos_recovery_wait)
    _status, after = fetch_json(f"{url}/metrics")
    pool = server.engine
    router = server.batcher
    supervisor = getattr(pool, "supervisor", None)
    sup_stats = supervisor.stats() if supervisor is not None else {}
    per_replica = sup_stats.get("replicas", {})
    chaos = {
        "spec": args.chaos,
        "seed": args.chaos_seed,
        "fired": injector.fired_counts(),
        # Clauses that never fired, split by determinism: a p=-triggered
        # clause can legitimately miss on a short run, but a count/after/
        # at clause that fired zero times means the schedule never
        # exercised what it claims to prove — e.g. warmup/aot_load sites,
        # which the self-serve pool has already passed by the time the
        # injector is armed (the fault tests drive those).
        "unfired": [s.source for s in injector.specs
                    if s.fired == 0 and s.p >= 1.0],
        "unfired_probabilistic": [s.source for s in injector.specs
                                  if s.fired == 0 and s.p < 1.0],
        "recovered": recovered,
        "restarts": {
            name: per_replica.get(name, {}).get("restarts", 0)
            for name in pool.replica_names
        },
        "mean_recovery_s": sup_stats.get("mean_recovery_s"),
        "replica_states": {
            name: s["state"] for name, s in router.replica_stats().items()
        },
        "circuits": {
            name: s.get("circuit")
            for name, s in router.replica_stats().items()
        },
        "retries": after.get("retries"),
    }
    return raw, before, after, chaos


def run_replica_sweep(args) -> int:
    """The scale-out A/B: the SAME workload against self-serve pools of
    increasing replica counts, reporting goodput and p99 per rung plus
    scaling efficiency (goodput_N / (N x goodput_1)) —
    ``--scaleout-report``."""
    counts = [int(c) for c in args.replicas_sweep.split(",")]
    if any(c < 1 for c in counts):
        raise SystemExit("--replicas-sweep counts must be >= 1")
    rows = []
    rc = 0
    for i, n in enumerate(counts):
        server, sink, url = _spin_self_serve(args, replicas=n)
        try:
            _status, before = fetch_json(f"{url}/metrics")
            raw = _drive(args, url)
            _status, after = fetch_json(f"{url}/metrics")
            if args.prom_dump and i == len(counts) - 1:
                with open(args.prom_dump, "w") as f:
                    f.write(fetch_text(f"{url}/metrics?format=prom"))
                print(f"prometheus exposition ({n} replicas): {args.prom_dump}")
        finally:
            _teardown_self_serve(server, sink)
        report = summarize(raw, before, after)
        extra = report["additional_compiles"]
        if extra and not args.no_check_compiles:
            print(f"RETRACE at {n} replicas: {extra} additional compile(s)")
            rc = 1
        rows.append({
            "replicas": n,
            "goodput_rps": report["goodput_rps"],
            "answered_rps": report["answered_rps"],
            "p50_ms": report["latency_ms"]["p50"],
            "p99_ms": report["latency_ms"]["p99"],
            "rejected": report["rejected"],
            "timed_out": report["timed_out"],
            "additional_compiles": extra,
            "router_policy": args.router_policy,
        })
    # Both ratios promise a 1-replica baseline; a sweep that starts at
    # some other rung (e.g. --replicas-sweep 2,4) has no such baseline,
    # so they stay None rather than quietly rebasing.
    base = rows[0]["goodput_rps"] if rows[0]["replicas"] == 1 else None
    for row in rows:
        row["speedup_vs_1"] = (
            row["goodput_rps"] / base if base else None
        )
        row["scaling_efficiency"] = (
            row["goodput_rps"] / (row["replicas"] * base)
            if base else None
        )
    sweep_report = {
        "mode": "open-loop" if args.open_loop else "closed-loop",
        "router_policy": args.router_policy,
        "requests": args.requests,
        "max_request": args.max_request,
        "buckets": [int(b) for b in args.buckets.split(",")],
        "offered_rate_rps": args.rate if args.open_loop else None,
        "sweep": rows,
    }
    _write_json(args.scaleout_report, sweep_report)
    print(f"scale-out report: {args.scaleout_report}")
    for row in rows:
        eff = row["scaling_efficiency"]
        print(
            f"  {row['replicas']} replica(s): "
            f"{row['goodput_rps']:.1f} goodput req/s, "
            f"p99 {row['p99_ms']:.2f} ms, {row['rejected']} rejected"
            + (f", efficiency {eff:.2f}" if eff is not None else "")
        )
    return rc


def _spin_fleet(args, n: int, workdir: str, autoscale: bool = False):
    """Bring up an n-backend FLEET behind an in-process front server
    (serving/fleet.py): real serving subprocesses sharing one
    ``--aot-cache`` store by default (``workdir``'s when the flag is
    absent, so a sweep builds its kernel libraries once), or — with
    ``--fleet-fake`` — in-process fake backends with serial capacity
    (the structural mode for a host-bound box).  ``workdir`` also holds
    the heartbeat files.  Returns ``(server, fleet, fakes, sink, url)``;
    the caller owns teardown.  Imports no torch: the backends own the
    card."""
    import tempfile

    from ..obs.events import EventSink, NullSink
    from ..serving.fleet import (
        Fleet,
        fake_backend_spawner,
        make_fleet_server,
        subprocess_backend_spawner,
    )
    from ..serving.metrics import ServingMetrics

    sink = (
        EventSink(args.telemetry_dir, filename="events-fleet.jsonl")
        if args.telemetry_dir else NullSink()
    )
    fakes: dict = {}
    hb_dir = tempfile.mkdtemp(prefix="fleet-hb-", dir=workdir)
    if args.fleet_fake:
        spawn = fake_backend_spawner(
            service_s=args.fleet_service_ms / 1e3,
            buckets=tuple(int(b) for b in args.buckets.split(",")),
            heartbeat_dir=hb_dir,
            registry=fakes,
        )
        # Compressed supervision, like --chaos: the kill round injects
        # an outage measured in milliseconds, so detection and backoff
        # must compress with it.
        supervisor_kwargs = dict(
            interval_s=0.05, probe_timeout_s=0.5, probe_failures=3,
            backoff_base_s=0.05, backoff_max_s=0.5, grace_s=2.0,
            heartbeat_timeout_s=2.0, ready_timeout_s=30.0,
        )
    else:
        aot = args.aot_cache or os.path.join(workdir, "aot")
        spawn = subprocess_backend_spawner(
            [
                "--device", args.device,
                "--buckets", args.buckets,
                "--timeout-ms", str(args.timeout_ms),
                "--queue-depth", str(args.queue_depth),
                "--max-inflight", str(args.max_inflight),
                "--aot-cache", aot,
                # The trace's variant, served and gated in every backend.
                "--dtypes", ",".join(dict.fromkeys(("f32", args.dtype))),
                "--int8-impl", args.int8_impl,
            ],
            base_port=args.fleet_base_port,
            heartbeat_dir=hb_dir,
            log_dir=args.telemetry_dir,
        )
        supervisor_kwargs = dict(
            interval_s=0.2, probe_timeout_s=1.0, probe_failures=3,
            backoff_base_s=0.2, backoff_max_s=1.0, grace_s=5.0,
            heartbeat_timeout_s=10.0, ready_timeout_s=180.0,
        )
    fleet = Fleet(
        spawn, policy=args.router_policy, metrics=ServingMetrics(),
        sink=sink, poll_s=0.1,
        default_timeout_s=args.timeout_ms / 1e3 + 2.0,
    )
    print(
        f"fleet: bringing up {n} "
        f"{'fake' if args.fleet_fake else 'real'} backend(s) "
        f"(policy {args.router_policy})"
    )
    fleet.start(
        n, wait_ready_s=300.0, supervise=True,
        supervisor_kwargs=supervisor_kwargs,
        autoscale=autoscale,
        # Compressed control loop, matched to the fakes' compressed
        # service times: high water a few queued requests per backend,
        # sub-second sustain window, everything interactive-speed.
        autoscaler_kwargs=dict(
            high_water=3.0, low_water=0.5, window_s=0.3,
            cooldown_s=1.0, min_backends=n, max_backends=n + 1,
            interval_s=0.05,
        ) if autoscale else None,
    )
    server = make_fleet_server(fleet, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    print(f"fleet front: {url} ({n} backends ready)")
    return server, fleet, fakes, sink, url


def _teardown_fleet(server, fleet, sink) -> None:
    if server is not None:
        server.shutdown()
        server.server_close()
    if fleet is not None:
        fleet.stop()
        # The real spawner's backend log files (one a name, kept across
        # respawns); the fakes' spawner has none.
        for handle in getattr(fleet.spawn, "handles", {}).values():
            handle.close()
    if sink is not None:
        sink.close()


def _fleet_kill_round(args, rows_max: int, workdir: str) -> tuple[dict, int]:
    """Recovery-under-kill: drive the open-loop trace against the
    biggest fleet and SIGKILL one backend mid-drive.  The front must
    absorb it: zero lost responses, zero client transport errors, 503
    rate within the bound, the backend REPLACED (restart counter >= 1,
    everything active again) and the replacement serving with zero
    post-warmup compiles (a warm start off the shared store).  Returns
    the report section and an exit code contribution."""
    import signal as _signal

    from ..liveness import signal_process_group

    rc = 0
    server, fleet, fakes, sink, url = _spin_fleet(args, rows_max, workdir)
    victim = fleet.backends_snapshot()[-1].name
    kill_at_s = 0.4 * args.requests / args.rate

    def _kill():
        print(f"fleet: KILLING backend {victim} (SIGKILL, mid-drive)")
        if args.fleet_fake:
            fakes[victim].kill()
        else:
            signal_process_group(
                fleet.backend(victim).proc, _signal.SIGKILL
            )

    timer = threading.Timer(kill_at_s, _kill)
    timer.start()
    try:
        _status, before = fetch_json(f"{url}/metrics")
        raw = _drive(args, url)
        timer.join()
        # Post-drive settle: the replacement must be serving again
        # within the recovery window.
        deadline = time.perf_counter() + args.fleet_recovery_wait
        replaced = False
        while time.perf_counter() < deadline:
            _status, snap = fetch_json(f"{url}/metrics")
            states = {
                name: b["state"]
                for name, b in (snap.get("backends") or {}).items()
                if b["state"] != "retired"
            }
            sup = (snap.get("fleet") or {}).get("supervisor") or {}
            if (states and all(s == "active" for s in states.values())
                    and (sup.get("restarts_total") or 0) >= 1):
                replaced = True
                break
            time.sleep(0.1)
        _status, after = fetch_json(f"{url}/metrics")
        if args.prom_dump:
            with open(args.prom_dump, "w") as f:
                f.write(fetch_text(f"{url}/metrics?format=prom"))
            print(f"prometheus exposition (kill round): {args.prom_dump}")
    finally:
        timer.cancel()
        _teardown_fleet(server, fleet, sink)
    results = raw["results"]
    lost = args.requests - len(results)
    transport = sum(1 for status, *_ in results if status == 0)
    rejected = sum(1 for status, *_ in results if status == 503)
    rate_503 = rejected / len(results) if results else 0.0
    replacement_compiles = (
        (after.get("backends") or {}).get(victim, {}).get("compiles")
    )
    sup = (after.get("fleet") or {}).get("supervisor") or {}
    recovery = {
        "backends": rows_max,
        "killed": victim,
        "kill_at_s": kill_at_s,
        "lost": lost,
        "transport_errors": transport,
        "rejected": rejected,
        "rejected_rate": rate_503,
        "replaced": replaced,
        "restarts_total": sup.get("restarts_total"),
        "mean_replacement_s": sup.get("mean_recovery_s"),
        "replacement_compiles": replacement_compiles,
        "goodput_rps": (
            sum(1 for status, *_ in results if status == 200) / raw["wall_s"]
            if raw["wall_s"] else 0.0
        ),
    }
    if lost or transport:
        print(
            f"FLEET-KILL FAIL: {lost} lost response(s), "
            f"{transport} client transport error(s) — the front must "
            "absorb a backend kill"
        )
        rc = 1
    if rate_503 > args.fleet_max_503_rate:
        print(
            f"FLEET-KILL FAIL: 503 rate {rate_503:.1%} exceeds the "
            f"--fleet-max-503-rate bound {args.fleet_max_503_rate:.1%}"
        )
        rc = 1
    if not replaced:
        print(
            f"FLEET-KILL FAIL: {victim} not replaced within "
            f"{args.fleet_recovery_wait:.0f}s"
        )
        rc = 1
    if replacement_compiles:
        print(
            f"FLEET-KILL FAIL: replacement {victim} reports "
            f"{replacement_compiles} compile(s) — a warm start off the "
            "shared store must load its kernel libraries, not build them"
        )
        rc = 1
    if rc == 0:
        print(
            f"fleet kill round: {victim} killed at {kill_at_s:.1f}s, "
            f"replaced in {recovery['mean_replacement_s'] or 0.0:.2f}s, "
            f"0 lost, 503 rate {rate_503:.1%}, replacement compiles "
            f"{replacement_compiles}"
        )
    return recovery, rc


def _fleet_autoscale_round(args, workdir: str) -> tuple[dict, int]:
    """The elasticity drill (--fleet-fake only — real backends on a
    2-core box cannot be saturated honestly): start ONE backend with the
    autoscaler on, drive a sustained over-capacity open-loop trace so
    the smoothed backlog breaches the high-water mark and the fleet
    scales 1 -> 2, then go idle so it drains the newest backend back
    down (drain -> settle -> kill).  Fails on any lost response, any
    non-200 outcome, a missing scale-up, or a missing drain-down."""
    rc = 0
    server, fleet, _fakes, sink, url = _spin_fleet(args, 1, workdir, autoscale=True)
    try:
        _status, before = fetch_json(f"{url}/metrics")
        raw = _drive(args, url)
        # Idle: the backlog signal decays below the low-water mark and
        # the newest backend drains back out.
        deadline = time.perf_counter() + args.fleet_recovery_wait
        drained = False
        while time.perf_counter() < deadline:
            _status, snap = fetch_json(f"{url}/metrics")
            states = [
                b["state"]
                for b in (snap.get("backends") or {}).values()
            ]
            if states.count("active") == 1 and "retired" in states:
                drained = True
                break
            time.sleep(0.1)
        _status, after = fetch_json(f"{url}/metrics")
    finally:
        _teardown_fleet(server, fleet, sink)
    results = raw["results"]
    lost = args.requests - len(results)
    non_200 = sum(1 for status, *_ in results if status != 200)
    scaled_up = any(
        b["state"] in ("active", "retired")
        for name, b in (after.get("backends") or {}).items()
        if name != "b0"
    )
    section = {
        "offered_rate_rps": args.rate,
        "requests": args.requests,
        "lost": lost,
        "non_200": non_200,
        "scaled_up": scaled_up,
        "drained_back": drained,
        "final_backends": {
            name: b["state"]
            for name, b in (after.get("backends") or {}).items()
        },
    }
    if lost or non_200:
        print(
            f"FLEET-AUTOSCALE FAIL: {lost} lost, {non_200} non-200 "
            "outcome(s) — scaling must lose nothing"
        )
        rc = 1
    if not scaled_up:
        print("FLEET-AUTOSCALE FAIL: never scaled 1 -> 2 under sustained "
              "over-capacity load")
        rc = 1
    if not drained:
        print("FLEET-AUTOSCALE FAIL: never drained back down at idle "
              f"within {args.fleet_recovery_wait:.0f}s")
        rc = 1
    if rc == 0:
        print(
            f"fleet autoscale round: scaled 1 -> 2 under load, drained "
            f"back at idle, 0 lost ({section['final_backends']})"
        )
    return section, rc


def run_fleet_sweep(args) -> int:
    """The fleet scale-out A/B: the SAME open-loop trace against fleets
    of increasing backend count → goodput / p99 / scaling efficiency per
    rung, then the recovery-under-kill round — all recorded in
    ``--fleet-report``.

    Real backends share the host's cores, so on a small host the REAL
    sweep is host-bound and goodput flattens; ``--fleet-fake`` swaps in
    serial-capacity fake backends over real sockets, which pins the
    routing/scaling structure without the host bound."""
    if not args.open_loop:
        raise SystemExit(
            "--fleet-sweep is an open-loop drill (the kill round's "
            "arrival schedule must not re-close around the outage); add "
            "--open-loop --rate R"
        )
    counts = [int(c) for c in args.fleet_sweep.split(",")]
    if any(c < 1 for c in counts):
        raise SystemExit("--fleet-sweep counts must be >= 1")
    import shutil
    import tempfile

    workdir = tempfile.mkdtemp(prefix="loadgen-fleet-")
    try:
        return _fleet_sweep(args, counts, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _fleet_sweep(args, counts: list[int], workdir: str) -> int:
    rows = []
    rc = 0
    for n in counts:
        server, fleet, _fakes, sink, url = _spin_fleet(args, n, workdir)
        try:
            _status, before = fetch_json(f"{url}/metrics")
            raw = _drive(args, url)
            _status, after = fetch_json(f"{url}/metrics")
        finally:
            _teardown_fleet(server, fleet, sink)
        report = summarize(raw, before, after)
        extra = report["additional_compiles"]
        if extra and extra > 0 and not args.no_check_compiles:
            print(f"RETRACE at {n} backends: {extra} additional compile(s)")
            rc = 1
        rows.append({
            "backends": n,
            "goodput_rps": report["goodput_rps"],
            "answered_rps": report["answered_rps"],
            "wall_s": raw["wall_s"],
            "p50_ms": report["latency_ms"]["p50"],
            "p99_ms": report["latency_ms"]["p99"],
            "rejected": report["rejected"],
            "timed_out": report["timed_out"],
            "additional_compiles": extra,
        })
    base = rows[0] if rows[0]["backends"] == 1 else None
    for row in rows:
        row["speedup_vs_1"] = (
            row["goodput_rps"] / base["goodput_rps"]
            if base and base["goodput_rps"] else None
        )
        row["scaling_efficiency"] = (
            row["goodput_rps"] / (row["backends"] * base["goodput_rps"])
            if base and base["goodput_rps"] else None
        )
    recovery = None
    if not args.no_fleet_kill:
        recovery, kill_rc = _fleet_kill_round(args, max(counts), workdir)
        rc = rc or kill_rc
    autoscale_round = None
    if args.fleet_fake and not args.no_fleet_autoscale:
        autoscale_round, scale_rc = _fleet_autoscale_round(args, workdir)
        rc = rc or scale_rc
    fleet_report = {
        "mode": "fleet-sweep",
        "backend_kind": "fake" if args.fleet_fake else "process",
        "host_bound_caveat": (
            None if args.fleet_fake else
            "real backends share this host's cores; on a small box "
            "goodput flattens at the host bound — the scaling structure "
            "is pinned by the --fleet-fake rung and "
            "tests/test_torch_fleet.py"
        ),
        "router_policy": args.router_policy,
        "requests": args.requests,
        "offered_rate_rps": args.rate,
        "max_request": args.max_request,
        "buckets": [int(b) for b in args.buckets.split(",")],
        "fake_service_ms": (
            args.fleet_service_ms if args.fleet_fake else None
        ),
        "sweep": rows,
        "recovery_under_kill": recovery,
        "autoscale_round": autoscale_round,
    }
    _write_json(args.fleet_report, fleet_report)
    print(f"fleet report: {args.fleet_report}")
    for row in rows:
        eff = row["scaling_efficiency"]
        print(
            f"  {row['backends']} backend(s): "
            f"{row['goodput_rps']:.1f} goodput req/s, wall "
            f"{row['wall_s']:.2f}s, p99 {row['p99_ms']:.2f} ms, "
            f"{row['rejected']} rejected"
            + (f", efficiency {eff:.2f}" if eff is not None else "")
        )
    return rc


def run_ab_tail(args) -> int:
    """The tail-latency A/B: the SAME
    open-loop Poisson trace — identical arrivals, sizes, and per-request
    class labels — against two self-serve pools:

    - **baseline**: feature off.  No ``qos`` field is sent (every
      request is default-class FIFO), batch close honors the global
      linger, no hedging.
    - **tail**: feature on.  The class labels ride the payload, batches
      close deadline-aware, and stragglers hedge to a second replica
      (``--hedge-delay-ms``, or the per-class p99 digest).

    Per-class p50/p95/p99 deltas land in ``--tail-report``.  The run
    FAILS on any lost response, any
    transport error, any duplicated client-visible outcome (the server's
    completed counter moving past the client's request count — the
    hedge-double-count check), or any post-warmup compile.
    """
    if not args.open_loop:
        raise SystemExit(
            "--ab-tail is an open-loop A/B (the tail is an arrival-rate "
            "phenomenon); add --open-loop --rate R"
        )
    if args.max_request > max(int(b) for b in args.buckets.split(",")):
        # A request bigger than the top bucket shards into N chunks and
        # the server counts each chunk's completion — the
        # completed-vs-(200s+504s) duplicate check below would read the
        # fan-out as phantom hedge double-counts and FAIL a correct run.
        raise SystemExit(
            "--ab-tail needs --max-request <= the top bucket (sharded "
            "chunk fan-out breaks the per-request completed-count "
            "accounting the duplicate check relies on)"
        )
    if args.replicas is None:
        args.replicas = 2  # hedging needs a second replica
    elif args.replicas < 2:
        # A 1-replica pool has no hedger (Router silently skips it) —
        # the "feature-on" rung would be unhedged while the report
        # labels it hedged.  0 (one per visible device) is also refused:
        # it can resolve to 1 on a single-device host.
        raise SystemExit(
            "--ab-tail needs --replicas >= 2: the feature-on rung hedges, "
            "and a lone replica has no second replica to hedge onto"
        )
    if not args.qos_mix:
        args.qos_mix = "interactive=0.8,batch=0.2"
    rungs = []
    rc = 0
    for label, send_qos, overrides in (
        ("baseline", False, dict(
            no_deadline_close=True, hedge=False, hedge_delay_ms=None)),
        ("tail", True, dict(
            no_deadline_close=False, hedge=True,
            hedge_delay_ms=args.hedge_delay_ms)),
    ):
        rung_args = argparse.Namespace(**{**vars(args), **overrides})
        print(f"--- ab-tail rung: {label} ---")
        server, sink, url = _spin_self_serve(
            rung_args, replicas=rung_args.replicas
        )
        try:
            _status, before = fetch_json(f"{url}/metrics")
            raw = _drive(rung_args, url, send_qos=send_qos)
            _status, after = fetch_json(f"{url}/metrics")
            if args.prom_dump and label == "tail":
                with open(args.prom_dump, "w") as f:
                    f.write(fetch_text(f"{url}/metrics?format=prom"))
                print(f"prometheus exposition (tail rung): {args.prom_dump}")
        finally:
            _teardown_self_serve(server, sink)
        report = summarize(raw, before, after)
        results = raw["results"]
        lost = args.requests - len(results)
        transport = sum(1 for status, *_ in results if status == 0)
        completed_delta = (
            after["requests"]["completed"] - before["requests"]["completed"]
        )
        # Exactly-one-outcome check: every server-side completion must
        # correspond to a client 200, or to a client 504 whose late
        # result landed after the client stopped waiting.  Anything
        # beyond that is a duplicated outcome (a hedge double-count).
        # Bounding by ok+504 — not by args.requests — keeps the check
        # honest under load: sheds and rejections must not open
        # headroom that masks real duplicates.
        ok_count = sum(1 for status, *_ in results if status == 200)
        client_504 = sum(1 for status, *_ in results if status == 504)
        duplicates = max(0, completed_delta - ok_count - client_504)
        if lost or transport or duplicates:
            print(
                f"AB-TAIL FAIL [{label}]: {lost} lost response(s), "
                f"{transport} transport error(s), {duplicates} "
                "duplicated client-visible outcome(s)"
            )
            rc = 1
        extra = report["additional_compiles"]
        if extra and not args.no_check_compiles:
            print(f"AB-TAIL FAIL [{label}]: {extra} additional compile(s)")
            rc = 1
        rungs.append({
            "label": label,
            "qos_sent": send_qos,
            "lost": lost,
            "transport_errors": transport,
            "completed_delta": completed_delta,
            "duplicates": duplicates,
            "goodput_rps": report["goodput_rps"],
            "latency_ms": report["latency_ms"],
            "qos_latency_ms": report["qos_latency_ms"],
            "server_qos": report["server_qos"],
            "server_hedges": report["server_hedges"],
            "rejected": report["rejected"],
            "timed_out": report["timed_out"],
            "additional_compiles": extra,
        })
    base, tail = rungs
    deltas: dict[str, dict] = {}
    for qos in sorted(set(base["qos_latency_ms"] or {})
                      & set(tail["qos_latency_ms"] or {})):
        b = base["qos_latency_ms"][qos]
        t = tail["qos_latency_ms"][qos]
        deltas[qos] = {
            key: {
                "baseline_ms": b[key],
                "tail_ms": t[key],
                "delta_ms": t[key] - b[key],
                "delta_pct": (
                    100.0 * (t[key] - b[key]) / b[key] if b[key] else None
                ),
            }
            for key in ("p50", "p95", "p99")
        }
    goodput_ratio = (
        tail["goodput_rps"] / base["goodput_rps"]
        if base["goodput_rps"] else None
    )
    ab_report = {
        "mode": "ab-tail",
        "offered_rate_rps": args.rate,
        "requests": args.requests,
        "replicas": args.replicas,
        "qos_mix": args.qos_mix,
        "hedge_delay_ms": args.hedge_delay_ms,
        "buckets": [int(b) for b in args.buckets.split(",")],
        "rungs": rungs,
        "deltas": deltas,
        "goodput_ratio_tail_vs_baseline": goodput_ratio,
    }
    _write_json(args.tail_report, ab_report)
    print(f"tail A/B report: {args.tail_report}")
    for qos, d in deltas.items():
        print(
            f"  {qos}: p50 {d['p50']['baseline_ms']:.1f} -> "
            f"{d['p50']['tail_ms']:.1f} ms, p99 "
            f"{d['p99']['baseline_ms']:.1f} -> {d['p99']['tail_ms']:.1f} ms "
            f"({d['p99']['delta_pct']:+.1f}%)"
            if d["p99"]["delta_pct"] is not None else f"  {qos}: (no data)"
        )
    hedges = tail["server_hedges"] or {}
    placed = hedges.get("won", 0) + hedges.get("lost", 0)
    print(
        "  goodput ratio "
        + (f"{goodput_ratio:.3f}" if goodput_ratio is not None
           else "n/a (baseline completed zero requests)")
        + f", hedges {hedges.get('won', 0)} won / "
        f"{hedges.get('lost', 0)} lost / "
        f"{hedges.get('cancelled', 0)} cancelled"
        + (f" (win rate {hedges.get('won', 0) / placed:.1%})" if placed else "")
    )
    return rc


def _rung_verdict(args, raw, before, after, report, label) -> tuple[dict, int]:
    """Shared per-rung accounting for the hostpath rounds: loss,
    transport errors, duplicated outcomes (server completions beyond
    client 200s+504s — cache hits/coalesces complete nothing server-side
    so they only SHRINK the delta), and the compile firewall."""
    rc = 0
    results = raw["results"]
    lost = args.requests - len(results)
    transport = sum(1 for status, *_ in results if status == 0)
    ok = sum(1 for status, *_ in results if status == 200)
    c504 = sum(1 for status, *_ in results if status == 504)
    completed_delta = (
        after["requests"]["completed"] - before["requests"]["completed"]
    )
    duplicates = max(0, completed_delta - ok - c504)
    extra = report["additional_compiles"]
    if lost or transport or duplicates:
        print(
            f"HOSTPATH FAIL [{label}]: {lost} lost response(s), "
            f"{transport} transport error(s), {duplicates} duplicated "
            "client-visible outcome(s)"
        )
        rc = 1
    if extra and not args.no_check_compiles:
        print(f"HOSTPATH FAIL [{label}]: {extra} additional compile(s)")
        rc = 1
    row = {
        "label": label,
        "requests": len(results),
        "lost": lost,
        "transport_errors": transport,
        "duplicates": duplicates,
        "goodput_rps": report["goodput_rps"],
        "answered_rps": report["answered_rps"],
        "latency_ms": report["latency_ms"],
        "rejected": report["rejected"],
        "timed_out": report["timed_out"],
        "additional_compiles": extra,
        "server_wire": (after.get("wire") or {}),
    }
    return row, rc


def run_hostpath(args) -> int:
    """The host hot-path A/B (``--hostpath-report``):

    1. **wire A/B** — the SAME open-loop trace (arrivals, sizes,
       payload pixels) against a fresh self-serve stack twice, once per
       wire format at equal offered rate.  Binary's win is pure host
       work deleted: no per-pixel text parse server-side, no JSON
       document client-side.
    2. **cache round** — a zipf-repeated payload workload
       (``--repeat-dist``, default ``zipf:1.1:16``) on the binary wire
       with the response cache on (``--response-cache``, default 64):
       server hit/miss/coalesced counters plus the client-side
       first-occurrence (miss path) vs repeat (hit path) percentile
       split.

    Every round fails on lost responses, transport errors, duplicated
    outcomes, or post-warmup compiles; the cache round additionally
    fails on a zero hit count or a hit-path p99 that is not under the
    miss-path p99.
    """
    if not args.open_loop:
        raise SystemExit(
            "--hostpath-ab is an open-loop A/B (the win is host work "
            "deleted at a FIXED offered rate; a closed loop would "
            "re-close around the faster path); add --open-loop --rate R"
        )
    rc = 0
    rungs: dict[str, dict] = {}
    for wire_fmt in ("json", "binary"):
        rung_args = argparse.Namespace(**{
            **vars(args),
            "wire": wire_fmt, "repeat_dist": None, "response_cache": None,
            # Equal information per response: the binary wire always
            # returns the full logits, so the JSON rung asks for
            # log_probs rather than the (smaller) predictions-only
            # answer.
            "json_log_probs": True,
        })
        print(f"--- hostpath rung: wire {wire_fmt} ---")
        server, sink, url = _spin_self_serve(rung_args, replicas=args.replicas)
        try:
            _status, before = fetch_json(f"{url}/metrics")
            raw = _drive(rung_args, url)
            _status, after = fetch_json(f"{url}/metrics")
        finally:
            _teardown_self_serve(server, sink)
        report = summarize(raw, before, after)
        row, rung_rc = _rung_verdict(args, raw, before, after, report, wire_fmt)
        rc = rc or rung_rc
        rungs[wire_fmt] = row
    goodput_ratio = (
        rungs["binary"]["goodput_rps"] / rungs["json"]["goodput_rps"]
        if rungs["json"]["goodput_rps"] else None
    )
    p50_ratio = (
        rungs["binary"]["latency_ms"]["p50"] / rungs["json"]["latency_ms"]["p50"]
        if rungs["json"]["latency_ms"]["p50"] else None
    )
    # The cache round: binary wire (the taught fast path), seeded zipf
    # repeats, cache on at both tiers the self-serve stack has (the
    # admission point; there is no fleet front here).
    cache_args = argparse.Namespace(**{
        **vars(args),
        "wire": "binary",
        "repeat_dist": args.repeat_dist or "zipf:1.1:16",
        "response_cache": args.response_cache or 64,
        "rate": args.cache_rate or args.rate,
    })
    print(
        f"--- hostpath rung: response cache "
        f"({cache_args.repeat_dist}, {cache_args.response_cache} entries, "
        f"{cache_args.rate:.0f} req/s) ---"
    )
    server, sink, url = _spin_self_serve(cache_args, replicas=args.replicas)
    try:
        _status, before = fetch_json(f"{url}/metrics")
        raw = _drive(cache_args, url)
        _status, after = fetch_json(f"{url}/metrics")
        if args.prom_dump:
            with open(args.prom_dump, "w") as f:
                f.write(fetch_text(f"{url}/metrics?format=prom"))
            print(f"prometheus exposition (cache round): {args.prom_dump}")
    finally:
        _teardown_self_serve(server, sink)
    report = summarize(raw, before, after)
    row, rung_rc = _rung_verdict(args, raw, before, after, report, "cache")
    rc = rc or rung_rc
    server_cache = report.get("server_cache") or {}
    split = report.get("repeat_workload") or {}
    hits = server_cache.get("hit", 0)
    first_p99 = (split.get("first_ms") or {}).get("p99")
    repeat_p99 = (split.get("repeat_ms") or {}).get("p99")
    if not hits:
        print("HOSTPATH FAIL [cache]: zero cache hits under a zipf "
              "repeat workload — the cache tier did nothing")
        rc = 1
    elif first_p99 and repeat_p99 is not None and repeat_p99 >= first_p99:
        print(
            f"HOSTPATH FAIL [cache]: hit-path p99 {repeat_p99:.2f} ms is "
            f"not under miss-path p99 {first_p99:.2f} ms"
        )
        rc = 1
    cache_round = {
        **row,
        "offered_rate_rps": cache_args.rate,
        "repeat_dist": cache_args.repeat_dist,
        "response_cache": cache_args.response_cache,
        "server_cache": server_cache,
        "repeat_workload": split,
    }
    hostpath_report = {
        "mode": "hostpath-ab",
        "offered_rate_rps": args.rate,
        "requests": args.requests,
        "max_request": args.max_request,
        "buckets": [int(b) for b in args.buckets.split(",")],
        "replicas": args.replicas,
        "wire_ab": {
            "rungs": rungs,
            "goodput_ratio_binary_vs_json": goodput_ratio,
            "p50_ratio_binary_vs_json": p50_ratio,
        },
        "cache_round": cache_round,
    }
    _write_json(args.hostpath_report, hostpath_report)
    print(f"hostpath report: {args.hostpath_report}")
    for fmt in ("json", "binary"):
        r = rungs[fmt]
        print(
            f"  wire {fmt}: {r['goodput_rps']:.1f} goodput req/s, "
            f"p50 {r['latency_ms']['p50']:.2f} ms / "
            f"p99 {r['latency_ms']['p99']:.2f} ms, "
            f"{r['rejected']} rejected, {r['timed_out']} timed out"
        )
    print(
        "  binary vs json: goodput "
        + (f"{goodput_ratio:.2f}x" if goodput_ratio else "n/a")
        + ", p50 "
        + (f"{p50_ratio:.2f}x" if p50_ratio else "n/a")
    )
    print(
        f"  cache round: {hits} hit / {server_cache.get('miss', 0)} miss "
        f"/ {server_cache.get('coalesced', 0)} coalesced "
        f"(hit rate {server_cache.get('hit_rate', 0.0):.1%}), "
        "hit-path p99 "
        + (f"{repeat_p99:.2f} ms" if repeat_p99 is not None else "n/a")
        + " vs miss-path p99 "
        + (f"{first_p99:.2f} ms" if first_p99 is not None else "n/a")
    )
    return rc


def run_devicepath(args) -> int:
    """The device hot-path A/B (the twin of --hostpath-ab): the SAME
    open-loop trace against a fresh self-serve
    stack twice, once bucketed (pow2 padding ladder) and once packed
    (ragged rows-capacity buffer + segment ids), at equal offered rate.

    What packing must show, and what this round enforces:

    - **fewer warmed rung Programs** — the packed capacity ladder
      collapses the pow2 rung grid, so the packed rung's warmup must
      build strictly fewer rung Programs than the bucketed rung's;
    - **better fill** — mean fill ratio (live rows / dispatched rows,
      the corrected accounting) must improve, optionally above a hard
      floor (``--devicepath-min-fill``);
    - **equal-or-better client p99** within ``--devicepath-p99-slack``
      (default 1.0 = literally equal-or-better; smokes on noisy CI
      hosts may loosen it);
    - the standing hostpath invariants: zero lost responses, zero
      transport errors, zero duplicated outcomes, zero post-warmup
      compiles — splitting a request across two packed batches must
      never lose or double-answer it.

    The section merges into ``--hostpath-report`` under ``"device_ab"``
    so one file carries both hot-path ledgers.
    """
    if not args.open_loop:
        raise SystemExit(
            "--devicepath-ab is an open-loop A/B (fill and padding waste "
            "only mean something at a FIXED offered rate; a closed loop "
            "would re-close around the faster path); add --open-loop "
            "--rate R"
        )
    rc = 0
    rungs: dict[str, dict] = {}
    for mode in ("bucketed", "packed"):
        rung_args = argparse.Namespace(**{
            **vars(args),
            "packed": mode == "packed",
            "fill_wait_ms": (
                args.fill_wait_ms if mode == "packed" else None
            ),
            "repeat_dist": None, "response_cache": None,
        })
        print(f"--- devicepath rung: {mode} ---")
        server, sink, url = _spin_self_serve(rung_args, replicas=args.replicas)
        try:
            _status, before = fetch_json(f"{url}/metrics")
            raw = _drive(rung_args, url)
            _status, after = fetch_json(f"{url}/metrics")
            if mode == "packed" and args.prom_dump:
                with open(args.prom_dump, "w") as f:
                    f.write(fetch_text(f"{url}/metrics?format=prom"))
                print(f"prometheus exposition (packed rung): {args.prom_dump}")
        finally:
            _teardown_self_serve(server, sink)
        report = summarize(raw, before, after)
        row, rung_rc = _rung_verdict(args, raw, before, after, report, mode)
        rc = rc or rung_rc
        # Warmed rung Programs: right after warmup they ARE the rung
        # grid (variants x rungs x replicas) — the ladder-collapse win
        # the packed rung must show.
        row["warmup_executables"] = (before.get("programs") or {}).get("rungs")
        row["fill_ratio_mean"] = (
            (after.get("pipeline") or {}).get("fill_ratio_mean")
        )
        row["batch_occupancy_pct"] = after.get("batch_occupancy_pct")
        rungs[mode] = row
    b, p = rungs["bucketed"], rungs["packed"]
    if (
        b["warmup_executables"] is not None
        and p["warmup_executables"] is not None
        and p["warmup_executables"] >= b["warmup_executables"]
    ):
        print(
            f"DEVICEPATH FAIL: packed warmed {p['warmup_executables']} "
            f"rung Program(s), not fewer than bucketed's "
            f"{b['warmup_executables']} — the capacity ladder did not "
            "collapse"
        )
        rc = 1
    if (
        b["fill_ratio_mean"] is not None
        and p["fill_ratio_mean"] is not None
        and p["fill_ratio_mean"] <= b["fill_ratio_mean"]
    ):
        print(
            f"DEVICEPATH FAIL: packed mean fill "
            f"{p['fill_ratio_mean']:.3f} did not improve on bucketed's "
            f"{b['fill_ratio_mean']:.3f}"
        )
        rc = 1
    if (
        args.devicepath_min_fill is not None
        and (p["fill_ratio_mean"] or 0.0) < args.devicepath_min_fill
    ):
        print(
            f"DEVICEPATH FAIL: packed mean fill "
            f"{p['fill_ratio_mean']:.3f} under the --devicepath-min-fill "
            f"floor {args.devicepath_min_fill:g}"
        )
        rc = 1
    p99_b = b["latency_ms"]["p99"]
    p99_p = p["latency_ms"]["p99"]
    if p99_b and p99_p and p99_p > p99_b * args.devicepath_p99_slack:
        print(
            f"DEVICEPATH FAIL: packed client p99 {p99_p:.2f} ms worse "
            f"than bucketed {p99_b:.2f} ms x slack "
            f"{args.devicepath_p99_slack:g}"
        )
        rc = 1
    device_ab = {
        "offered_rate_rps": args.rate,
        "requests": args.requests,
        "max_request": args.max_request,
        "buckets": [int(x) for x in args.buckets.split(",")],
        "replicas": args.replicas,
        "fill_wait_ms": args.fill_wait_ms,
        "rungs": rungs,
        "warmup_executables_bucketed": b["warmup_executables"],
        "warmup_executables_packed": p["warmup_executables"],
        "fill_ratio_mean_bucketed": b["fill_ratio_mean"],
        "fill_ratio_mean_packed": p["fill_ratio_mean"],
        "p99_ratio_packed_vs_bucketed": (
            p99_p / p99_b if p99_b else None
        ),
        "passed": rc == 0,
    }
    # One hot-path ledger: merge into the hostpath report rather than
    # scattering a second bench file (the host A/B's sections survive).
    doc = {"mode": "hostpath-ab"}
    if os.path.exists(args.hostpath_report):
        try:
            with open(args.hostpath_report) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            pass
    doc["device_ab"] = device_ab
    _write_json(args.hostpath_report, doc)
    print(f"devicepath report: {args.hostpath_report} (device_ab section)")
    for mode in ("bucketed", "packed"):
        r = rungs[mode]
        fill = r["fill_ratio_mean"]
        print(
            f"  {mode}: {r['warmup_executables']} warmed rung Program(s), "
            "mean fill "
            + (f"{100.0 * fill:.1f}%" if fill is not None else "n/a")
            + f", p50 {r['latency_ms']['p50']:.2f} ms / "
            f"p99 {r['latency_ms']['p99']:.2f} ms, "
            f"{r['rejected']} rejected, {r['timed_out']} timed out"
        )
    return rc


# ---------------------------------------------------------------------------
# Model-registry drive modes (serving/registry.py, rollout.py):
# --swap-at-s T fires a live /admin/swap T seconds into the drive and
# fails on any lost request, torn response (logits matching neither the
# full-old nor the full-new weights), or post-warmup compile;
# --canary-sweep P1,P2 climbs the canary rungs verifying the EXACT
# deterministic split against the offline assignment recomputation.


def _spin_registry_serve(args):
    """Self-serve stack in registry mode: a temp registry directory with
    v1 (seed) and v2 (seed+1) published, the engine serving v1, and the
    rollout controller wired in.  The response cache stays OFF so every
    outcome is a real dispatch the verdicts can count."""
    import shutil
    import tempfile

    import torch

    from ..models.net import Net
    from ..obs.events import open_sink
    from ..serving import InferenceEngine, ServingMetrics
    from ..serving.registry import ModelRegistry
    from ..serving.rollout import RolloutController
    from ..serving.server import make_server
    from ..utils.checkpoint import model_state_dict, save_state_dict

    metrics = ServingMetrics()
    buckets = [int(b) for b in args.buckets.split(",")]
    sink = open_sink(args.telemetry_dir)
    regdir = tempfile.mkdtemp(prefix="loadgen_registry_")
    registry = ModelRegistry(regdir, sink=sink)
    base_seed = args.seed or 1
    for i, seed in enumerate((base_seed, base_seed + 1), start=1):
        path = os.path.join(regdir, f"v{i}.pt")
        save_state_dict(model_state_dict(Net(torch.Generator().manual_seed(seed))), path)
        registry.publish("mnist", f"v{i}", path, make_default=(i == 1))
    entry = registry.resolve()
    engine = InferenceEngine(
        registry.load(entry), device=args.device, buckets=buckets,
        metrics=metrics, version=entry.version,
    )
    print(
        f"registry self-serve: {regdir} (v1 seed {base_seed} default, "
        f"v2 seed {base_seed + 1}); warming buckets {list(engine.buckets)}"
    )
    engine.warmup()
    rollout = RolloutController(
        registry, engine, metrics=metrics, sink=sink,
    )
    server = make_server(
        engine, metrics, port=0, sink=sink, rollout=rollout,
        linger_ms=args.linger_ms, queue_depth=args.queue_depth,
        timeout_ms=args.timeout_ms, max_inflight=args.max_inflight,
        adaptive_linger=not args.no_adaptive_linger,
    )
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    print(f"registry self-serve: {url}")
    cleanup = lambda: shutil.rmtree(regdir, ignore_errors=True)  # noqa: E731
    return server, sink, url, engine, cleanup


def _registry_payloads(args, count: int):
    """Distinct seeded payloads: ``(raw_pixels, model_ready_rows)`` per
    request, sizes cycling 1..max_request.  The model-ready bytes are
    what the server hashes for the canary split, so the offline
    assignment audit recomputes from ``x4.tobytes()`` exactly."""
    import numpy as np

    rng = np.random.RandomState(args.seed or 0)
    payloads = []
    for i in range(count):
        n = 1 + i % max(1, args.max_request)
        raw = rng.randint(0, 256, (n, 784)).astype(np.float32)
        payloads.append((raw, raw.reshape(-1, 28, 28, 1)))
    return payloads


def _registry_predict(url, raw, timeout):
    import numpy as np

    status, body = fetch_json(
        f"{url}/predict",
        {"instances": raw.tolist(), "normalized": True,
         "return_log_probs": True},
        timeout=timeout,
    )
    if status != 200:
        return status, None
    return status, np.asarray(body.get("log_probs"), np.float32)


def _answers(engine, x4, dtype: str | None = None) -> list:
    """A payload's log-probs at every warmed rung that holds it.  A
    request coalesced with others is served at a larger bucket than its
    own, and on the card a row's f32 sums depend on the bucket (cuDNN
    chooses its algorithm by shape), so an answer is the old or the new
    weights' when it equals one of these.  A packed engine has one
    capacity: one answer."""
    import numpy as np

    fits = [b for b in engine.buckets if b >= len(x4)]
    if not fits:
        return [engine.predict_logits(x4, dtype=dtype).copy()]
    pad = np.zeros((fits[-1] - len(x4), *x4.shape[1:]), x4.dtype)
    return [
        engine.predict_logits(np.concatenate([x4, pad[: b - len(x4)]]),
                              dtype=dtype)[: len(x4)].copy()
        for b in fits
    ]


def _matches(logits, answers: list) -> bool:
    import numpy as np

    return any(np.array_equal(logits, a) for a in answers)


def run_registry(args) -> int:
    """The swap/canary drive: see the module docstring's registry
    section.  Writes ``--registry-report`` and exits nonzero on any
    lost/torn/misrouted outcome or post-warmup compile."""
    rc = 0
    report: dict = {"mode": "registry"}
    server, sink, url, engine, cleanup = _spin_registry_serve(args)

    def compile_count() -> int:
        return _compile_count(fetch_json(f"{url}/metrics")[1])

    try:
        compiles0 = compile_count()
        payloads = _registry_payloads(args, min(args.requests, 48))
        expected_v1 = [_answers(engine, x4) for _raw, x4 in payloads]

        # -- swap round -------------------------------------------------------
        if args.swap_at_s is not None:
            results: list[tuple[int, int, object]] = []
            swap_result: dict = {}
            stop = threading.Event()

            def do_swap():
                status, body = fetch_json(
                    f"{url}/admin/swap", {"version": "v2"},
                    timeout=args.timeout_s,
                )
                swap_result["status"] = status
                swap_result["body"] = body

            timer = threading.Timer(args.swap_at_s, do_swap)
            timer.start()
            deadline = time.perf_counter() + 2.0 * args.swap_at_s + 0.5

            def hammer(wid, nworkers=4):
                i = wid
                while time.perf_counter() < deadline and not stop.is_set():
                    k = i % len(payloads)
                    i += nworkers
                    status, logits = _registry_predict(
                        url, payloads[k][0], args.timeout_s
                    )
                    results.append((k, status, logits))

            workers = [
                threading.Thread(target=hammer, args=(w,)) for w in range(4)
            ]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=args.timeout_s + 2 * args.swap_at_s)
            timer.join()
            expected_v2 = [_answers(engine, x4) for _raw, x4 in payloads]
            non_200 = sum(1 for _k, s, _l in results if s != 200)
            torn = sum(
                1 for k, s, logits in results
                if s == 200 and not (
                    _matches(logits, expected_v1[k])
                    or _matches(logits, expected_v2[k])
                )
            )
            served_new = sum(
                1 for k, s, logits in results
                if s == 200 and _matches(logits, expected_v2[k])
            )
            added = compile_count() - compiles0
            swap_row = {
                "swap_at_s": args.swap_at_s,
                "requests": len(results),
                "lost_or_failed": non_200,
                "torn": torn,
                "served_old": len(results) - non_200 - torn - served_new,
                "served_new": served_new,
                "swap_http_status": swap_result.get("status"),
                "additional_compiles": added,
            }
            report["swap"] = swap_row
            if swap_result.get("status") != 200:
                print(f"REGISTRY FAIL [swap]: /admin/swap answered "
                      f"{swap_result.get('status')} "
                      f"({swap_result.get('body')})")
                rc = 1
            if non_200:
                print(f"REGISTRY FAIL [swap]: {non_200} request(s) "
                      "without a 200 outcome during the swap window")
                rc = 1
            if torn:
                print(f"REGISTRY FAIL [swap]: {torn} TORN response(s) — "
                      "logits match neither the old nor the new weights")
                rc = 1
            if not served_new:
                print("REGISTRY FAIL [swap]: no request ever served the "
                      "new weights — the swap never landed in the drive "
                      "window")
                rc = 1
            if added:
                print(f"REGISTRY FAIL [swap]: {added} post-warmup "
                      "compile(s) — the weight republish rebuilt a rung")
                rc = 1
            if rc == 0:
                print(
                    f"swap: {len(results)} requests, "
                    f"{swap_row['served_old']} old / {served_new} new, "
                    "0 lost, 0 torn, 0 compiles"
                )

        # -- canary sweep ----------------------------------------------------
        if args.canary_sweep:
            from ..serving.rollout import canary_assignment

            # After a swap round the primary is v2; canary the OTHER
            # version so the split is between distinguishable weights.
            _status, desc = fetch_json(f"{url}/admin/rollout", {})
            primary = desc["version"]
            canary_version = "v2" if primary == "v1" else "v1"
            canary_rows = []
            compiles_before = compile_count()
            for pct_s in str(args.canary_sweep).split(","):
                pct = float(pct_s)
                status, body = fetch_json(
                    f"{url}/admin/canary",
                    {"version": canary_version, "pct": pct},
                    timeout=args.timeout_s,
                )
                if status != 200:
                    print(f"REGISTRY FAIL [canary {pct:g}%]: /admin/canary "
                          f"answered {status} ({body})")
                    rc = 1
                    break
                expected_pin = [
                    _answers(engine, x4, dtype=f"f32@{canary_version}")
                    for _raw, x4 in payloads
                ]
                expected_pri = [_answers(engine, x4) for _raw, x4 in payloads]
                misrouted = failed = canary_served = 0
                for k, (raw, x4) in enumerate(payloads):
                    assigned = canary_assignment(x4.tobytes(), pct)
                    status, logits = _registry_predict(
                        url, raw, args.timeout_s
                    )
                    if status != 200:
                        failed += 1
                        continue
                    want = expected_pin[k] if assigned else expected_pri[k]
                    if not _matches(logits, want):
                        misrouted += 1
                    canary_served += bool(assigned)
                row = {
                    "pct": pct,
                    "requests": len(payloads),
                    "expected_canary": canary_served,
                    "failed": failed,
                    "misrouted": misrouted,
                }
                canary_rows.append(row)
                if failed or misrouted:
                    print(
                        f"REGISTRY FAIL [canary {pct:g}%]: {failed} "
                        f"failed, {misrouted} response(s) not matching "
                        "the deterministic assignment"
                    )
                    rc = 1
                else:
                    print(
                        f"canary {pct:g}%: {canary_served}/{len(payloads)}"
                        " split to the canary, exact deterministic match"
                    )
            status, _body = fetch_json(
                f"{url}/admin/rollback", {"reason": "sweep_done"},
                timeout=args.timeout_s,
            )
            if status != 200:
                print(f"REGISTRY FAIL [canary]: rollback answered {status}")
                rc = 1
            added = compile_count() - compiles_before
            if added:
                print(f"REGISTRY FAIL [canary]: {added} post-warmup "
                      "compile(s) across the sweep")
                rc = 1
            report["canary_sweep"] = {
                "version": canary_version,
                "rungs": canary_rows,
                "additional_compiles": added,
            }
        _status, rollout_desc = fetch_json(f"{url}/admin/rollout", {})
        report["final_rollout"] = rollout_desc
        report["additional_compiles"] = compile_count() - compiles0
    finally:
        _teardown_self_serve(server, sink)
        cleanup()
    _write_json(args.registry_report, report)
    print(f"registry report: {args.registry_report}")
    print(f"REGISTRY {'PASS' if rc == 0 else 'FAIL'}")
    return rc


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m pytorch_mnist_ddp_tpu_torch.tools.serve_loadgen",
        description=__doc__.split("\n\n")[0],
    )
    parser.add_argument(
        "--url", default=None,
        help="serving endpoint (http://host:port); omitted = --self-serve",
    )
    parser.add_argument(
        "--self-serve", action="store_true",
        help="spin up an in-process server on a loopback port (fresh "
        "seed weights; the default when --url is omitted)",
    )
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="--self-serve mode and --fleet-sweep's real backends: where "
        "the engines run (cuda raises without a card; cpu on request, as "
        "the serving CLI's --device)",
    )
    parser.add_argument("--requests", type=int, default=200)
    parser.add_argument(
        "--concurrency", type=int, default=8,
        help="closed-loop client threads; in --open-loop mode, the cap on "
        "simultaneously outstanding requests (size it above rate x "
        "latency — a saturated pool shows up as client-side queueing in "
        "the latency percentiles, which are measured from the scheduled "
        "arrival)",
    )
    parser.add_argument(
        "--open-loop", action="store_true",
        help="Poisson arrivals at --rate req/s, independent of "
        "completions (closed-loop client threads otherwise)",
    )
    parser.add_argument(
        "--rate", type=float, default=200.0,
        help="open-loop offered arrival rate, requests/second",
    )
    parser.add_argument(
        "--max-request", type=int, default=16,
        help="request sizes are drawn uniformly from [1, this]",
    )
    parser.add_argument(
        "--dtype", default="f32", choices=("f32", "bf16", "int8"),
        help="route every request to this serving variant (the /predict "
        "\"dtype\" field) — the reduced-precision A/B knob; in "
        "--self-serve mode the variant is warmed and parity-gated "
        "before the run",
    )
    parser.add_argument(
        "--wire", default="json", choices=("json", "binary"),
        help="request wire format: json = the default "
        "text protocol; binary = application/x-mnist-f32 (fixed header "
        "+ raw float32 rows, responses as raw logits bytes) — the "
        "host-path A/B knob.  Bodies are pre-encoded before the "
        "arrival clock either way",
    )
    parser.add_argument(
        "--repeat-dist", default=None, metavar="zipf:S[:K]",
        help="repeated-payload workload: draw each request's payload "
        "from a catalog of K distinct payloads (default 16) with "
        "zipf(S) popularity — the realistic hit distribution for the "
        "response-cache A/B; the report gains a first-occurrence vs "
        "repeat client percentile split",
    )
    parser.add_argument(
        "--response-cache", type=int, default=None, metavar="N",
        help="--self-serve mode: enable the server's content-addressed "
        "response cache + single-flight dedup, bounded at N entries "
        "(serving/cache.py; the /predict --response-cache flag)",
    )
    parser.add_argument(
        "--hostpath-ab", action="store_true",
        help="host hot-path A/B: drive the SAME "
        "open-loop trace with --wire json then --wire binary at equal "
        "offered rate, then a zipf repeat workload with the response "
        "cache on; write goodput/latency ratios + cache hit stats to "
        "--hostpath-report and FAIL on lost/duplicated responses, "
        "post-warmup compiles, zero hits, or a hit-path p99 not under "
        "the miss-path p99",
    )
    parser.add_argument(
        "--hostpath-report", default=os.path.join(REPORT_DIR, "BENCH_hostpath.json"),
        help="where --hostpath-ab writes its report",
    )
    parser.add_argument(
        "--cache-rate", type=float, default=None, metavar="RPS",
        help="offered rate for --hostpath-ab's cache round (default "
        "--rate).  The wire A/B deliberately saturates the host; the "
        "cache round wants a rate the MISS path can sustain, so the "
        "hit/miss latency split measures the cache, not client-side "
        "queueing",
    )
    parser.add_argument(
        "--packed", action="store_true",
        help="--self-serve mode: packed ragged batching (requests "
        "concatenated into one rows-capacity buffer + segment ids "
        "instead of pow2 padding)",
    )
    parser.add_argument(
        "--fill-wait-ms", type=float, default=None,
        help="packed mode: how long a forming batch may wait for more "
        "rows before dispatching part-full (the linger ceiling in "
        "packed mode)",
    )
    parser.add_argument(
        "--int8-impl", default="dot", choices=("dot", "pallas"),
        help="--self-serve int8 dense head (dot = two library int8 "
        "GEMMs, pallas = the int8_head CUDA kernel; its plain version "
        "on the CPU)",
    )
    parser.add_argument(
        "--devicepath-ab", action="store_true",
        help="device hot-path A/B: the SAME "
        "open-loop trace bucketed then packed at equal offered rate; "
        "merge the rung table into --hostpath-report under 'device_ab' "
        "and FAIL unless packed warms strictly fewer rung Programs, "
        "improves mean fill, holds client p99 within "
        "--devicepath-p99-slack, and loses/duplicates nothing",
    )
    parser.add_argument(
        "--devicepath-p99-slack", type=float, default=1.0,
        help="multiplier on the bucketed rung's client p99 the packed "
        "rung must stay within (1.0 = literally equal-or-better; CI "
        "smokes on noisy shared hosts may loosen)",
    )
    parser.add_argument(
        "--devicepath-min-fill", type=float, default=None,
        help="optional hard floor on the packed rung's mean fill ratio "
        "(the SLO gate ratchets this permanently; here it guards ad-hoc "
        "A/Bs)",
    )
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--timeout-s", type=float, default=30.0)
    parser.add_argument(
        "--buckets", default="8,16,32",
        help="bucket ladder for --self-serve mode",
    )
    parser.add_argument(
        "--linger-ms", type=float, default=2.0,
        help="batcher linger for --self-serve mode",
    )
    parser.add_argument(
        "--queue-depth", type=int, default=64,
        help="admission bound for --self-serve mode",
    )
    parser.add_argument(
        "--timeout-ms", type=float, default=1000.0,
        help="per-request server-side deadline for --self-serve mode; "
        "raise it (with --queue-depth) for no-shed capacity A/Bs where "
        "every request must complete",
    )
    parser.add_argument(
        "--max-inflight", type=int, default=2,
        help="in-flight window for --self-serve mode (1 = a serial "
        "pipeline, for A/B throughput comparisons)",
    )
    parser.add_argument(
        "--no-adaptive-linger", action="store_true",
        help="pin the linger at --linger-ms in --self-serve mode",
    )
    parser.add_argument(
        "--no-deadline-close", action="store_true",
        help="--self-serve mode: disable deadline-aware batch close "
        "(batches then honor the global linger even when the oldest "
        "member's deadline budget is nearly spent)",
    )
    parser.add_argument(
        "--qos-mix", default=None, metavar="CLASS=FRAC,...",
        help="per-request QoS class mix, e.g. interactive=0.8,batch=0.2: "
        "each request is labeled from this distribution (seeded) and "
        "the label is sent as the /predict \"qos\" field; the report "
        "gains per-class latency percentiles",
    )
    parser.add_argument(
        "--hedge", action="store_true",
        help="--self-serve pool mode: enable hedged dispatch with the "
        "per-class p99 digest delay",
    )
    parser.add_argument(
        "--hedge-delay-ms", type=float, default=None, metavar="MS",
        help="fixed hedge delay in ms (implies --hedge); straggler "
        "requests re-dispatch to a second replica after this wait, "
        "first completion wins",
    )
    parser.add_argument(
        "--ab-tail", action="store_true",
        help="tail-latency A/B: drive the SAME open-loop trace against "
        "a feature-off pool (no QoS, global linger, no hedging) and a "
        "feature-on pool (QoS mix + deadline-aware close + hedging), "
        "report per-class p50/p95/p99 deltas to --tail-report, and FAIL "
        "on any lost response or duplicated client-visible outcome",
    )
    parser.add_argument(
        "--tail-report", default=os.path.join(REPORT_DIR, "BENCH_tail.json"),
        help="where --ab-tail writes its report",
    )
    parser.add_argument(
        "--telemetry-dir", default=None,
        help="--self-serve mode: write serving JSONL telemetry here",
    )
    parser.add_argument(
        "--prom-dump", default=None,
        help="after the run, save the endpoint's Prometheus exposition "
        "(/metrics?format=prom) to this file",
    )
    parser.add_argument(
        "--replicas", type=int, default=None, metavar="N",
        help="--self-serve mode: serve an N-replica engine pool behind "
        "the queue-aware router instead of one engine (0 = one per "
        "visible device, as in the serving CLI)",
    )
    parser.add_argument(
        "--replica-shapes", default=None, metavar="SPEC",
        help="--self-serve pool mode: comma-separated per-replica shard "
        "shape, e.g. 'tp4,dp,dp,dp,dp'; count must match --replicas",
    )
    parser.add_argument(
        "--router-policy", default="cost",
        choices=("roundrobin", "least-loaded", "cost"),
        help="replica placement policy for --replicas / --replicas-sweep",
    )
    parser.add_argument(
        "--replicas-sweep", default=None, metavar="N1,N2,...",
        help="scale-out sweep: run the SAME workload against self-serve "
        "pools of each listed replica count and report goodput vs. "
        "replicas at fixed p99 with scaling efficiency "
        "(--scaleout-report; --prom-dump saves the last rung's "
        "exposition)",
    )
    parser.add_argument(
        "--scaleout-report",
        default=os.path.join(REPORT_DIR, "BENCH_serving_scaleout.json"),
        help="where --replicas-sweep writes its report",
    )
    parser.add_argument(
        "--fleet-sweep", default=None, metavar="N1,N2,...",
        help="multi-PROCESS fleet sweep: "
        "bring up a fleet of each listed backend count (real serving "
        "subprocesses sharing one --aot-cache store, or fakes with "
        "--fleet-fake), drive the SAME open-loop trace through the "
        "front tier, then run a recovery-under-kill round at the top "
        "rung — goodput/p99/scaling-efficiency per count plus the "
        "recovery receipt land in --fleet-report; requires --open-loop",
    )
    parser.add_argument(
        "--fleet-fake", action="store_true",
        help="with --fleet-sweep: in-process fake backends with SERIAL "
        "capacity over real sockets — the structural scaling pin for "
        "host-bound boxes (N real serving processes on a few cores "
        "flatten at the host bound; the fakes do not)",
    )
    parser.add_argument(
        "--fleet-service-ms", type=float, default=20.0,
        help="fake-backend per-request service time (--fleet-fake)",
    )
    parser.add_argument(
        "--no-fleet-kill", action="store_true",
        help="skip the recovery-under-kill round after the sweep",
    )
    parser.add_argument(
        "--no-fleet-autoscale", action="store_true",
        help="skip the autoscale round (--fleet-fake sweeps only: "
        "1 backend under sustained over-capacity load must scale to 2, "
        "then drain back at idle with nothing lost)",
    )
    parser.add_argument(
        "--fleet-report", default=os.path.join(REPORT_DIR, "BENCH_fleet.json"),
        help="where --fleet-sweep writes its report",
    )
    parser.add_argument(
        "--fleet-base-port", type=int, default=18411,
        help="first real-backend port for --fleet-sweep",
    )
    parser.add_argument(
        "--fleet-max-503-rate", type=float, default=0.25,
        help="maximum tolerated client-visible 503 fraction during the "
        "kill round (the bounded-shed contract at fleet scope)",
    )
    parser.add_argument(
        "--fleet-recovery-wait", type=float, default=60.0,
        help="post-drive wait for the killed backend's replacement to "
        "serve again before the kill round fails",
    )
    parser.add_argument(
        "--aot-cache", default=None, metavar="DIR",
        help="the kernel-library store (compile/aot.ExecutableStore) "
        "shared by the self-served engine(s) and by every --fleet-sweep "
        "backend: a warm start loads the libraries with no nvcc run",
    )
    parser.add_argument(
        "--chaos", default=None, metavar="SPEC",
        help="drive a fault schedule against the self-serve pool while "
        "the workload runs (requires --replicas; serving/faults.py's "
        "grammar, e.g. 'fail:launch:r1:count=6;hang:complete:r0:for=2'). "
        "The run then FAILS on any lost or duplicated response, any "
        "transport error, a 503 rate above --chaos-max-503-rate, or any "
        "post-restart compile, and the report gains a \"chaos\" section "
        "with restarts, recovery times, and final replica states",
    )
    parser.add_argument(
        "--chaos-seed", type=int, default=0,
        help="seed for the fault schedule's probabilistic clauses and "
        "the supervisor's backoff jitter (determinism receipt)",
    )
    parser.add_argument(
        "--chaos-max-503-rate", type=float, default=0.25,
        help="maximum tolerated client-visible 503 fraction under "
        "--chaos (the bounded-shed contract)",
    )
    parser.add_argument(
        "--chaos-stall-timeout", type=float, default=0.5,
        help="supervisor completion-stall threshold under --chaos "
        "(seconds; compressed from the serving CLI's 5s default to "
        "match a compressed fault schedule)",
    )
    parser.add_argument(
        "--chaos-recovery-wait", type=float, default=15.0,
        help="after the workload, wait up to this long (driving probe "
        "requests through half-open circuits) for every replica to "
        "heal before the final metrics/prom snapshot",
    )
    parser.add_argument(
        "--report", default=os.path.join(REPORT_DIR, "BENCH_serving.json"))
    parser.add_argument(
        "--no-check-compiles", action="store_true",
        help="don't fail when the run triggered additional compiles",
    )
    parser.add_argument(
        "--swap-at-s", type=float, default=None,
        help="registry drive: fire a live /admin/swap to v2 this many "
        "seconds into a closed-loop hammer; FAIL on any lost request, "
        "torn response, or post-warmup compile",
    )
    parser.add_argument(
        "--canary-sweep", default=None,
        help="registry drive: comma-separated canary percentages (e.g. "
        "25,50); each rung verifies the EXACT deterministic split "
        "against the offline assignment recomputation, then rolls back",
    )
    parser.add_argument(
        "--registry-report", default=os.path.join(REPORT_DIR, "BENCH_registry.json"),
        help="where the registry drive writes its verdict JSON",
    )
    return parser


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    refusal = _lockwatch_gate() or _replica_plan_refusal(args.replica_shapes, args.device)
    if refusal:
        print(refusal)
        return 2
    if args.url and args.replicas is not None:
        # Silently measuring a remote single endpoint while the report
        # claims N replicas is exactly the confusion a benchmark tool
        # must not allow.
        parser.error("--replicas is --self-serve only; a --url endpoint "
                     "chooses its own replica count")
    if args.chaos and (args.url or args.replicas_sweep):
        parser.error("--chaos drives a single self-serve pool; drop "
                     "--url / --replicas-sweep")
    if args.chaos and args.replicas is None:
        parser.error("--chaos needs --replicas N: fault tolerance is a "
                     "pool property (a lone engine has no survivors to "
                     "retry on)")
    if args.hedge or args.hedge_delay_ms is not None:
        if args.url:
            parser.error("--hedge is --self-serve pool only; a --url "
                         "endpoint configures its own hedging")
        if args.replicas is None and not args.ab_tail and not args.replicas_sweep:
            # The single-engine self-serve branch has no hedger; running
            # it under a --hedge flag would measure an unhedged engine
            # while the operator believes otherwise (the serving CLI
            # hard-errors on the same combination).
            parser.error("--hedge needs --replicas N (>= 2): a lone "
                         "engine has no second replica to hedge onto")
    if args.response_cache is not None and args.url:
        parser.error("--response-cache is --self-serve only; a --url "
                     "endpoint configures its own cache")
    if args.response_cache is not None and args.response_cache < 1:
        # Fail at the flag surface, not after minutes of warmup (the
        # serving CLI's pre-flight rule).
        parser.error(f"--response-cache must be >= 1, got "
                     f"{args.response_cache}")
    if args.swap_at_s is not None or args.canary_sweep:
        if args.url or args.replicas is not None or args.replicas_sweep \
                or args.chaos or args.ab_tail or args.fleet_sweep \
                or args.hostpath_ab or args.devicepath_ab:
            parser.error("--swap-at-s / --canary-sweep drive their own "
                         "single-engine registry stack; drop --url / "
                         "--replicas / --replicas-sweep / --chaos / "
                         "--ab-tail / --fleet-sweep / --hostpath-ab / "
                         "--devicepath-ab")
        if args.swap_at_s is not None and args.swap_at_s <= 0:
            parser.error(f"--swap-at-s must be > 0, got {args.swap_at_s}")
        if args.response_cache is not None:
            parser.error("the registry drive keeps the response cache "
                         "off so every outcome is a countable dispatch; "
                         "drop --response-cache")
        return run_registry(args)
    if args.hostpath_ab:
        if args.url or args.replicas_sweep or args.chaos or args.ab_tail \
                or args.fleet_sweep:
            parser.error("--hostpath-ab drives its own self-serve "
                         "stacks; drop --url / --replicas-sweep / "
                         "--chaos / --ab-tail / --fleet-sweep")
        return run_hostpath(args)
    if args.devicepath_ab:
        if args.url or args.replicas_sweep or args.chaos or args.ab_tail \
                or args.fleet_sweep:
            parser.error("--devicepath-ab drives its own self-serve "
                         "stacks; drop --url / --replicas-sweep / "
                         "--chaos / --ab-tail / --fleet-sweep")
        if args.packed:
            parser.error("--devicepath-ab toggles packing itself; drop "
                         "--packed")
        return run_devicepath(args)
    if args.fleet_sweep:
        if args.url or args.replicas_sweep or args.chaos or args.ab_tail:
            parser.error("--fleet-sweep drives its own fleets; drop "
                         "--url / --replicas-sweep / --chaos / --ab-tail")
        if args.replicas is not None:
            parser.error("--fleet-sweep backends choose their own "
                         "replica layout; drop --replicas")
        return run_fleet_sweep(args)
    if args.ab_tail:
        if args.url or args.replicas_sweep or args.chaos:
            parser.error("--ab-tail drives its own pair of self-serve "
                         "pools; drop --url / --replicas-sweep / --chaos")
        return run_ab_tail(args)
    if args.replicas_sweep:
        if args.url:
            parser.error("--replicas-sweep drives self-serve pools; "
                         "drop --url")
        return run_replica_sweep(args)

    server = None
    sink = None
    if args.url and not args.self_serve:
        url = args.url.rstrip("/")
    else:
        server, sink, url = _spin_self_serve(args, replicas=args.replicas)

    chaos_section = None
    try:
        if args.chaos:
            raw, before, after, chaos_section = run_chaos(
                args, server, sink, url
            )
        else:
            _status, before = fetch_json(f"{url}/metrics")
            raw = _drive(args, url)
            _status, after = fetch_json(f"{url}/metrics")
        if args.prom_dump:
            with open(args.prom_dump, "w") as f:
                f.write(fetch_text(f"{url}/metrics?format=prom"))
            print(f"prometheus exposition: {args.prom_dump}")
    finally:
        _teardown_self_serve(server, sink)

    report = summarize(raw, before, after)
    chaos_rc = 0
    if chaos_section is not None:
        # The chaos verdict: every submitted
        # request got exactly one terminal HTTP outcome (no losses, no
        # transport errors = no duplicated/abandoned work visible to a
        # client), shed stayed bounded, and the pool healed.
        results = raw["results"]
        lost = args.requests - len(results)
        transport = sum(1 for status, *_ in results if status == 0)
        rate_503 = (
            report["rejected"] / len(results) if results else 0.0
        )
        chaos_section["lost"] = lost
        chaos_section["transport_errors"] = transport
        chaos_section["rejected_rate"] = rate_503
        report["chaos"] = chaos_section
        if lost or transport:
            print(
                f"CHAOS FAIL: {lost} request(s) without a terminal "
                f"outcome, {transport} transport error(s)"
            )
            chaos_rc = 1
        if rate_503 > args.chaos_max_503_rate:
            print(
                f"CHAOS FAIL: 503 rate {rate_503:.1%} exceeds the "
                f"--chaos-max-503-rate bound {args.chaos_max_503_rate:.1%}"
            )
            chaos_rc = 1
        if not chaos_section["recovered"]:
            print(
                "CHAOS FAIL: replicas did not settle within "
                f"--chaos-recovery-wait ({chaos_section['replica_states']})"
            )
            chaos_rc = 1
        if chaos_section["unfired"]:
            # A green run whose schedule never fired proves nothing —
            # fail loudly instead of narrating a fault drill that did
            # not happen.
            print(
                "CHAOS FAIL: clause(s) never fired: "
                f"{chaos_section['unfired']} (warmup/aot_load sites are "
                "already past by the time --chaos arms; the fault tests "
                "drive those)"
            )
            chaos_rc = 1
        for clause in chaos_section["unfired_probabilistic"]:
            print(f"chaos: WARNING probabilistic clause never fired: {clause}")
        restarts = chaos_section["restarts"]
        print(
            "chaos: "
            f"{sum(chaos_section['fired'].values())} fault(s) fired, "
            f"restarts {restarts}, "
            f"mean recovery {chaos_section['mean_recovery_s'] or 0.0:.3f} s, "
            f"retries {chaos_section['retries']}, "
            f"503 rate {rate_503:.1%}, lost {lost}, "
            f"final states {chaos_section['replica_states']}"
        )
    _write_json(args.report, report)

    lat = report["latency_ms"]
    print(
        f"done in {report['wall_s']:.2f}s ({report['mode']}"
        + (f", dtype {report['dtype']}" if report["dtype"] != "f32" else "")
        + (f", offered {report['offered_rate_rps']:.0f} req/s"
           if report["offered_rate_rps"] else "")
        + "): "
        f"{report['throughput_rps']:.1f} req/s, "
        f"p50 {lat['p50']:.2f} ms / p95 {lat['p95']:.2f} ms / "
        f"p99 {lat['p99']:.2f} ms, "
        f"{report['rejected']} rejected (503), "
        f"occupancy {report['server_batch_occupancy_pct']:.1f}%"
        if report["server_batch_occupancy_pct"] is not None
        else "done (no server occupancy reported)"
    )
    print(f"report: {args.report}")
    extra = report["additional_compiles"]
    if extra is None:
        print("warning: endpoint reports no compile gauge; retrace check skipped")
    elif extra > 0:
        print(
            f"RETRACE: {extra} additional compile(s) during the run — "
            "request shapes escaped the bucket policy"
        )
        if not args.no_check_compiles:
            return 1
    else:
        print("zero additional compiles (bucket firewall held)")
    return chaos_rc


def _lockwatch_gate() -> str | None:
    """The JAX tool checks its runtime lock-order tracer after the load
    under ``JAXLINT_LOCKWATCH=1``.  The port has no such tracer yet (the
    counterpart of the JAX package's ``analysis/lockwatch.py``, ROADMAP.md
    item 20), so the flag is refused before anything runs: a gate that
    passed silently would claim a check nobody made."""
    value = os.environ.get(LOCKWATCH_ENV, "").strip().lower()
    if value in ("", "0", "false", "no", "off"):
        return None
    return (
        f"error: {LOCKWATCH_ENV}={value} asks for the runtime lock-order "
        "check, and the port has no lock tracer yet (ROADMAP.md item 20, "
        "the port's counterpart of analysis/lockwatch.py); unset it"
    )


def _replica_plan_refusal(spec: str | None, device: str | None) -> str | None:
    """A ``--replica-shapes`` plan the pool would refuse (a malformed entry,
    more devices than ``device`` shows), in the serving CLI's words (its
    exit code is the caller's: 2)."""
    if not spec:
        return None
    from ..serving.devices import parse_replica_shapes, plan_replica_meshes, visible_devices

    try:
        plan_replica_meshes(parse_replica_shapes(spec), visible_devices(device))
    except ValueError as e:
        return f"error: --replica-shapes {spec!r}: {e}"
    return None


if __name__ == "__main__":
    sys.exit(main())
