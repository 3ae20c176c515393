"""Multi-process serving fleet: front router, control plane, autoscaler.

One serving process is host-bound: under concurrent clients its time
goes to Python's HTTP, JSON and the GIL, not to the card.  This module
adds the tier past one process: N backend serving processes behind a
front that owns no device and imports no ``torch``.

- **Backend** — one serving process (``python -m
  pytorch_mnist_ddp_tpu_torch.serving``: engine or replica pool,
  supervisor, QoS batcher) on its own port, reached over a keep-alive
  HTTP connection pool with per-attempt timeouts.
- **FleetRouter** — the replica router's placement policies
  (roundrobin / least-loaded / cost) over network backends, fed from
  each backend's polled ``/metrics`` snapshot (queue depth, in-flight)
  plus a front-measured latency EWMA, with a circuit breaker
  (serving/circuit.py) per backend and at most ONE attempt per backend
  on the remaining deadline: exactly one client-visible outcome per
  request, however many backends were tried.
- **FleetSupervisor** — liveness (process poll), ``/readyz`` probes and
  heartbeat files (liveness.py) find a dead or wedged backend; it is
  grace-killed and REPLACED under a seeded-backoff restart budget, and
  the replacement warm-starts off the shared ``--aot-cache`` store
  (every kernel library a hit: no ``nvcc`` run, ``compiles`` 0).
- **FleetAutoscaler** — adds a backend when the smoothed load signal
  breaches the high-water mark for a sustained window, and drains the
  newest backend (drain → settle → kill, nothing lost) at the low-water
  mark, with hysteresis (separate watermarks + cooldown) and min/max
  bounds.

Telemetry: ``fleet_backends{state=}``, ``fleet_route_decisions_total
{backend=}``, ``fleet_backend_restarts_total{backend=}``,
``fleet_scale_events_total{direction=}`` plus ``fleet_route`` /
``backend_death`` / ``backend_replace`` / ``backend_eject`` /
``backend_drain`` / ``fleet_scale`` JSONL events, the JAX package's
names.

The standard library, numpy (the wire's content type) and the obs
registry only: the front supervises the processes that own the card, so
nothing here may depend on the thing being supervised.
:class:`FakeBackendServer` is the structural test harness: a real-HTTP
fake backend with serial capacity, so routing, replacement and scaling
run over genuine sockets at interactive speed.
"""

from __future__ import annotations

import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..liveness import (
    BackoffLadder,
    Heartbeat,
    grace_stop,
    heartbeat_age_s,
    heartbeat_path,
)
from ..obs.export import render_prometheus
from .cache import COALESCED, HIT, FlightTimeout, ResponseCache
from .circuit import (
    CIRCUIT_HALF_OPEN,
    CIRCUIT_OPEN,
    CircuitBreaker,
)
from .metrics import ServingMetrics
from .wire import WIRE_REQUEST_TYPE

FLEET_POLICIES = ("roundrobin", "least-loaded", "cost")

# Backend lifecycle states (the fleet_backends{state=} gauge keys).
STARTING = "starting"      # spawned, waiting for /readyz
ACTIVE = "active"          # routable
DRAINING = "draining"      # scale-down in progress: no new placements
REPLACING = "replacing"    # dead/hung; killed, awaiting backoff respawn
EJECTED = "ejected"        # restart budget spent; permanently out
RETIRED = "retired"        # drained down cleanly (scale-down complete)
BACKEND_STATES = (STARTING, ACTIVE, DRAINING, REPLACING, EJECTED, RETIRED)

# Env contract between the fleet front and its backend processes: the
# serving CLI beats this file from the batcher's dispatch loop, so a
# backend that still answers poll() but stopped dispatching is found by
# the file's age (liveness.py).
ENV_FLEET_HEARTBEAT_FILE = "SERVE_HEARTBEAT_FILE"

# Front-measured latency EWMA smoothing (serving/router.py's constant).
EWMA_ALPHA = 0.2

_JSON_TYPE = "application/json"


class Backend:
    """One network backend: a name, its URL, an optional owned process,
    and a keep-alive HTTP connection pool with per-attempt timeouts.

    ``proc`` is duck-typed (``poll()``/``send_signal()``/``wait()``): a
    ``subprocess.Popen`` for the CLI fleet, a :class:`FakeBackendServer`
    handle in tests.  The object is swapped whole on replacement (same
    name, carried breaker), so the router never sees a half-rebuilt
    backend.
    """

    def __init__(
        self,
        name: str,
        host: str,
        port: int,
        proc=None,
        heartbeat_file: str | None = None,
        pool_size: int = 8,
    ):
        self.name = name
        self.host = host
        self.port = int(port)
        self.proc = proc
        self.heartbeat_file = heartbeat_file
        self.state = STARTING
        self.breaker: CircuitBreaker | None = None
        self.started_at = time.perf_counter()
        # Load signals: polled from the backend's /metrics by the fleet's
        # poller; front_inflight counts this front's own in-flight proxied
        # requests (a request can be in a backend's HTTP handler before it
        # shows in that backend's queue gauge).
        self.polled_depth = 0
        self.polled_inflight = 0
        self.polled_latency_ms: float | None = None
        self.polled_compiles: int | None = None
        self.polled_at: float | None = None
        self.front_inflight = 0
        self._inflight_lock = threading.Lock()
        self._ewma_s: float | None = None
        self._pool_size = pool_size
        self._idle: list[http.client.HTTPConnection] = []
        self._conn_lock = threading.Lock()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- transport ------------------------------------------------------------

    def _exchange(
        self, conn, method, path, body, timeout_s, headers,
    ) -> tuple[int, bytes, str, bool]:
        """One raw exchange on ``conn``; (status, body, content-type,
        keep-alive?).  ``headers`` override the JSON default: a proxied
        binary-wire body must reach the backend under its own content
        type, never re-labeled."""
        conn.timeout = timeout_s
        if conn.sock is not None:
            conn.sock.settimeout(timeout_s)
        hdrs = {"Content-Type": "application/json"}
        if headers:
            hdrs.update(headers)
        conn.request(method, path, body=body, headers=hdrs)
        resp = conn.getresponse()
        data = resp.read()
        ctype = resp.headers.get("Content-Type") or "application/json"
        return resp.status, data, ctype, not resp.will_close

    def request(
        self,
        method: str,
        path: str,
        body: bytes | None = None,
        timeout_s: float = 5.0,
        headers: dict | None = None,
    ) -> tuple[int, bytes]:
        """:meth:`request_full` without the response content type (the
        probe and metrics callers' surface)."""
        status, data, _ctype = self.request_full(
            method, path, body=body, timeout_s=timeout_s, headers=headers
        )
        return status, data

    def request_full(
        self,
        method: str,
        path: str,
        body: bytes | None = None,
        timeout_s: float = 5.0,
        headers: dict | None = None,
    ) -> tuple[int, bytes, str]:
        """One HTTP exchange over a pooled keep-alive connection,
        returning ``(status, body, content_type)``: the proxy passes a
        binary response through under its own content type.

        ``timeout_s`` is the per-attempt socket timeout (this attempt's
        connect and reads): the front never blocks without bound on one
        backend.  Transport failures raise (``OSError`` /
        ``http.client.HTTPException``) and close the connection, never
        returning it to the pool, EXCEPT that a failure on a REUSED
        pooled connection gets one retry on a fresh connection first: the
        backend's handler idle timeout (serving/server.py
        ``request_timeout_s``) closes keep-alives that sat in this pool
        too long, and that routine FIN is no failure of the backend.
        """
        with self._conn_lock:
            conn = self._idle.pop() if self._idle else None
        reused = conn is not None
        if conn is None:
            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=timeout_s
            )
        try:
            status, data, ctype, keep = self._exchange(
                conn, method, path, body, timeout_s, headers
            )
        except Exception as e:
            try:
                conn.close()
            except Exception:
                pass
            # Stale keep-alive: one fresh-connection retry, ONLY for the
            # connection-level errors an idle-timed-out keep-alive gives
            # (broken pipe / reset at send, RemoteDisconnected / empty
            # status line at read).  A read TIMEOUT is excluded: retrying
            # it would re-send to a merely slow backend and double the
            # attempt's deadline.  Re-sending is safe: /predict is
            # idempotent.
            stale = (
                reused
                and not isinstance(e, TimeoutError)
                and isinstance(e, (
                    ConnectionResetError, BrokenPipeError,
                    ConnectionAbortedError, http.client.BadStatusLine,
                ))
            )
            if not stale:
                raise
            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=timeout_s
            )
            try:
                status, data, ctype, keep = self._exchange(
                    conn, method, path, body, timeout_s, headers
                )
            except Exception:
                try:
                    conn.close()
                except Exception:
                    pass
                raise
        if keep:
            with self._conn_lock:
                if len(self._idle) < self._pool_size:
                    self._idle.append(conn)
                    conn = None
        if conn is not None:
            # The server asked to close, or the pool is full: this
            # connection ends here, not at GC time (an overflow socket
            # left to the finalizer leaks FDs under sustained load).
            conn.close()
        return status, data, ctype

    def metrics_json(self, timeout_s: float = 0.5) -> dict | None:
        """The backend's /metrics JSON snapshot, or None when it cannot
        be fetched (the caller decides whether that is an incident)."""
        try:
            status, data = self.request("GET", "/metrics", timeout_s=timeout_s)
            if status != 200:
                return None
            return json.loads(data)
        except (OSError, http.client.HTTPException, ValueError):
            return None

    def probe_ready(self, timeout_s: float = 0.5) -> bool:
        """/readyz == 200.  Transport failure and non-200 both read as
        not ready (the supervisor counts consecutive misses)."""
        try:
            status, _data = self.request("GET", "/readyz", timeout_s=timeout_s)
            return status == 200
        except (OSError, http.client.HTTPException):
            return False

    # -- load / health signals -------------------------------------------------

    def observe_latency(self, latency_s: float) -> None:
        prev = self._ewma_s
        self._ewma_s = (
            latency_s if prev is None
            else EWMA_ALPHA * latency_s + (1.0 - EWMA_ALPHA) * prev
        )

    @property
    def ewma_latency_s(self) -> float | None:
        if self._ewma_s is not None:
            return self._ewma_s
        # Until the front has its own samples, the backend's reported
        # mean (from the polled snapshot) is the prior.
        if self.polled_latency_ms is not None:
            return self.polled_latency_ms / 1e3
        return None

    def load(self) -> int:
        """Polled backlog + this front's own in-flight proxies."""
        with self._inflight_lock:
            front_inflight = self.front_inflight
        return self.polled_depth + self.polled_inflight + front_inflight

    def inflight_enter(self) -> None:
        with self._inflight_lock:
            self.front_inflight += 1

    def inflight_exit(self) -> None:
        with self._inflight_lock:
            self.front_inflight -= 1

    def alive(self) -> bool:
        return self.proc is None or self.proc.poll() is None

    def heartbeat_age(self) -> float | None:
        if not self.heartbeat_file:
            return None
        return heartbeat_age_s(self.heartbeat_file)

    # -- lifecycle -------------------------------------------------------------

    def close_connections(self) -> None:
        with self._conn_lock:
            idle, self._idle = self._idle, []
        for conn in idle:
            try:
                conn.close()
            except Exception:
                pass

    def stop(self, grace_s: float = 5.0) -> None:
        """Grace-kill the owned process: SIGTERM (the serving CLI's
        draining shutdown), SIGKILL whatever is left after the grace
        window.  External backends (no proc) just lose their pool."""
        self.close_connections()
        p = self.proc
        if p is None or p.poll() is not None:
            return
        if isinstance(p, subprocess.Popen):
            grace_stop([p], grace_s)
            return
        try:
            p.send_signal(signal.SIGTERM)
            deadline = time.monotonic() + grace_s
            while p.poll() is None and time.monotonic() < deadline:
                time.sleep(0.01)
            if p.poll() is None:
                p.send_signal(signal.SIGKILL)
        except (ProcessLookupError, OSError):
            pass


class FleetRouter:
    """Place proxied requests over the fleet's active backends.

    Placement order is recomputed per request from the live load
    signals.  ``submit`` returns the client-visible outcome: transport
    failures and backend 503s are absorbed by trying the next backend on
    the REMAINING deadline (one attempt per backend), and only when every
    backend refused does the caller see a single 503.
    """

    def __init__(
        self,
        fleet: "Fleet",
        policy: str = "cost",
        default_timeout_s: float = 1.0,
    ):
        if policy not in FLEET_POLICIES:
            raise ValueError(
                f"unknown fleet policy {policy!r}; have {FLEET_POLICIES}"
            )
        self.fleet = fleet
        self.policy = policy
        self.default_timeout_s = float(default_timeout_s)
        self._rr = 0
        self._lock = threading.Lock()

    # -- ordering (serving/router.py's shapes, over backends) -----------------

    @staticmethod
    def _trials_first(order: list[Backend]) -> list[Backend]:
        trials = [
            b for b in order
            if b.breaker is not None
            and b.breaker.state == CIRCUIT_HALF_OPEN
            and b.breaker.allows()
        ]
        if not trials:
            return order
        return trials + [b for b in order if b not in trials]

    def _order(self, active: list[Backend]) -> list[Backend]:
        with self._lock:
            rotation = self._rr
            self._rr += 1
        k = rotation % len(active)
        rotated = active[k:] + active[:k]
        if self.policy == "roundrobin":
            return self._trials_first(rotated)
        if self.policy == "least-loaded":
            key = lambda b: b.load()  # noqa: E731 - local sort key
        else:
            ewmas = [
                b.ewma_latency_s for b in active
                if b.ewma_latency_s is not None
            ]
            if not ewmas:
                key = lambda b: b.load()  # noqa: E731 - local sort key
            else:
                prior = sum(ewmas) / len(ewmas)

                def key(b: Backend):
                    ewma = b.ewma_latency_s
                    return (b.load() + 1) * (prior if ewma is None else ewma)
        return self._trials_first(sorted(rotated, key=key))

    def _note(self, backend: Backend) -> None:
        registry = self.fleet.metrics.registry
        registry.counter(
            "fleet_route_decisions_total",
            help="front-tier request placements by chosen backend",
            backend=backend.name,
        ).inc()
        if self.fleet.sink:
            self.fleet.sink.emit(
                "fleet_route", policy=self.policy, backend=backend.name,
            )

    # -- the data plane --------------------------------------------------------

    def submit(
        self,
        body: bytes,
        timeout_s: float | None = None,
        headers: dict | None = None,
    ) -> tuple[int, bytes, str]:
        """Proxy one /predict body; returns the client outcome as
        ``(status, body, content_type)``.  The body and its content type
        pass through unchanged in both directions: the front never
        decodes or re-encodes a payload."""
        metrics = self.fleet.metrics
        metrics.record_admitted()
        t0 = time.perf_counter()
        deadline = t0 + (
            self.default_timeout_s if timeout_s is None else timeout_s
        )
        active = self.fleet.active_backends()
        if not active:
            metrics.record_rejected()
            return 503, b'{"error": "no active backends"}', _JSON_TYPE
        last_503: tuple[bytes, str] | None = None
        transport_errors = 0
        for backend in self._order(active):
            breaker = backend.breaker
            if breaker is not None and not breaker.try_acquire():
                continue
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                if breaker is not None:
                    breaker.release()
                break
            self._note(backend)
            backend.inflight_enter()
            t_attempt = time.perf_counter()
            try:
                status, data, ctype = backend.request_full(
                    "POST", "/predict", body,
                    timeout_s=remaining, headers=headers,
                )
            except (OSError, http.client.HTTPException):
                # Transport: the backend may be dead or being replaced.
                # /predict is idempotent, so the retry on the next backend
                # (remaining budget) cannot duplicate a client-visible
                # outcome: the client holds exactly one socket.
                if breaker is not None:
                    breaker.record_failure()
                transport_errors += 1
                continue
            finally:
                backend.inflight_exit()
            if status == 503:
                # Backpressure, no verdict on the backend: return any
                # trial token and try the next one.  Only a fleet-wide
                # refusal surfaces (exactly one 503).
                if breaker is not None:
                    breaker.release()
                last_503 = (data, ctype)
                continue
            if status == 504:
                # The backend's own deadline verdict, before the >= 500
                # failure branch: a 504 under a load spike is queueing,
                # not sickness, and a breaker failure would open a healthy
                # backend's circuit that nothing (the supervisor replaces
                # dead or unready backends, not loaded ones) closes again.
                if breaker is not None:
                    breaker.release()
                metrics.record_timeout()
            elif status >= 500:
                if breaker is not None:
                    breaker.record_failure()
                metrics.record_failed()
            elif status == 200:
                if breaker is not None:
                    breaker.record_success()
                backend.observe_latency(time.perf_counter() - t_attempt)
                metrics.record_completed(time.perf_counter() - t0)
            else:
                # 4xx: a client error is no verdict on the backend.
                if breaker is not None:
                    breaker.release()
            return status, data, ctype
        if time.perf_counter() >= deadline:
            metrics.record_timeout()
            return 504, b'{"error": "fleet deadline expired"}', _JSON_TYPE
        metrics.record_rejected()
        if last_503 is not None:
            return 503, last_503[0], last_503[1]
        return 503, json.dumps({
            "error": "no routable backends "
            f"({transport_errors} unreachable, every circuit open or "
            "backend draining)"
        }).encode(), _JSON_TYPE


class _BackendWatch:
    """Supervisor bookkeeping for one backend's restart ladder."""

    __slots__ = (
        "attempts", "restarts", "next_restart_t", "down_since",
        "probe_misses", "recovery_s", "healthy_since", "replacing",
    )

    def __init__(self):
        self.attempts = 0
        self.restarts = 0
        self.next_restart_t: float | None = None
        self.down_since: float | None = None
        self.probe_misses = 0
        self.recovery_s: list[float] = []
        self.healthy_since: float | None = None
        self.replacing = False


class FleetSupervisor:
    """Replace dead or hung backends under a seeded-backoff restart budget.

    The launcher's gang supervisor applied per backend (replace ONE,
    never restart the world)::

        active ──dead/hung/unready──▶ replacing (grace kill, backoff)
           ▲                              │ attempts > restart_budget
           │ /readyz 200                  ▼
        starting ◀──── respawn        ejected (permanent)

    Health reads per tick: process liveness (``poll()``), heartbeat-file
    age (a backend whose dispatch loop stopped beating is wedged even if
    the process answers), and consecutive failed ``/readyz`` probes.  A
    replacement spawns under the SAME name and port, warm-starts off the
    shared store, carries the old backend's breaker (re-admitted
    half-open), and counts on ``fleet_backend_restarts_total{backend=}``
    and a ``backend_replace`` event whose ``downtime_s`` is incident to
    serving.
    """

    def __init__(
        self,
        fleet: "Fleet",
        interval_s: float = 0.5,
        probe_timeout_s: float = 0.5,
        probe_failures: int = 3,
        heartbeat_timeout_s: float = 0.0,
        grace_s: float = 5.0,
        restart_budget: int = 3,
        backoff_base_s: float = 0.5,
        backoff_max_s: float = 10.0,
        backoff_jitter: float = 0.25,
        seed: int = 0,
        ready_timeout_s: float = 120.0,
        healthy_after_s: float = 30.0,
    ):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.fleet = fleet
        self.interval_s = interval_s
        self.probe_timeout_s = probe_timeout_s
        self.probe_failures = max(1, probe_failures)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.grace_s = grace_s
        self.restart_budget = max(0, restart_budget)
        self.ready_timeout_s = ready_timeout_s
        self.healthy_after_s = healthy_after_s
        self._ladder = BackoffLadder(
            base_s=backoff_base_s, max_s=backoff_max_s,
            jitter=backoff_jitter, seed=seed,
        )
        self._watch: dict[str, _BackendWatch] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "FleetSupervisor":
        if self._thread is not None:
            raise RuntimeError("fleet supervisor already started")
        self._thread = threading.Thread(
            target=self._run, name="fleet-supervisor", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _run(self) -> None:
        last_err = 0.0
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as e:
                # One bad tick (a backend torn down mid-inspection) must
                # not end supervision, but a tick that keeps failing is a
                # supervisor that silently does nothing: say so, one line
                # a window.
                now = time.monotonic()
                if now - last_err > 5.0:
                    last_err = now
                    print(
                        f"fleet-supervisor: tick failed: "
                        f"{type(e).__name__}: {e}",
                        file=sys.stderr,
                    )
                    if self.fleet.sink:
                        self.fleet.sink.emit(
                            "supervisor_tick_error",
                            error=f"{type(e).__name__}: {e}",
                        )

    # -- the state machine -----------------------------------------------------

    def tick(self, now: float | None = None) -> None:
        """One inspection pass (public so tests step deterministically)."""
        now = now if now is not None else time.perf_counter()
        for backend in self.fleet.backends_snapshot():
            watch = self._watch.setdefault(backend.name, _BackendWatch())
            if backend.state == ACTIVE:
                reason = self._sick_reason(backend, watch)
                if reason is not None:
                    self._incident(backend, watch, reason, now)
                elif (
                    watch.attempts
                    and watch.healthy_since is not None
                    and now - watch.healthy_since > self.healthy_after_s
                ):
                    # A healed spell: the next incident starts a fresh
                    # ladder.
                    watch.attempts = 0
            elif backend.state == STARTING and watch.replacing:
                if not backend.alive():
                    self._incident(backend, watch, "died_starting", now)
                elif backend.probe_ready(self.probe_timeout_s):
                    self._serving_again(backend, watch, now)
                elif (
                    time.perf_counter() - backend.started_at
                    > self.ready_timeout_s
                ):
                    self._incident(backend, watch, "start_timeout", now)
            elif (
                backend.state == REPLACING
                and watch.next_restart_t is not None
                and now >= watch.next_restart_t
            ):
                self._respawn(backend, watch, now)

    def _sick_reason(self, backend: Backend, watch: _BackendWatch) -> str | None:
        if not backend.alive():
            return "dead"
        if (backend.breaker is not None
                and backend.breaker.state == CIRCUIT_OPEN):
            # The data plane tripped on consecutive request failures: a
            # backend that answers /readyz but fails /predict.  An open
            # circuit heals only through this replacement path (half-open
            # after respawn), so leaving it would strand the backend.
            return "circuit_open"
        if self.heartbeat_timeout_s > 0:
            age = backend.heartbeat_age()
            if age is not None:
                self.fleet.metrics.registry.gauge(
                    "fleet_backend_heartbeat_age_seconds",
                    help="seconds since each backend's last dispatch-loop "
                    "heartbeat (absent backends are still starting up)",
                    backend=backend.name,
                ).set(age)
                if age > self.heartbeat_timeout_s:
                    return "heartbeat"
        if backend.probe_ready(self.probe_timeout_s):
            watch.probe_misses = 0
            if watch.healthy_since is None:
                watch.healthy_since = time.perf_counter()
        else:
            watch.probe_misses += 1
            watch.healthy_since = None
            if watch.probe_misses >= self.probe_failures:
                return "unready"
        return None

    def _incident(self, backend, watch, reason, now) -> None:
        watch.probe_misses = 0
        watch.healthy_since = None
        if watch.down_since is None:
            watch.down_since = now
        if self.fleet.sink:
            self.fleet.sink.emit(
                "backend_death", backend=backend.name, reason=reason,
            )
        if backend.breaker is not None:
            backend.breaker.force_open(reason)
        self.fleet.set_state(backend, REPLACING)
        backend.stop(self.grace_s)
        if watch.attempts >= self.restart_budget:
            self._eject(backend, watch, reason)
            return
        backoff = self._ladder.delay_s(watch.attempts)
        watch.next_restart_t = now + backoff
        if self.fleet.sink:
            self.fleet.sink.emit(
                "backend_replace_scheduled", backend=backend.name,
                reason=reason, attempt=watch.attempts + 1,
                backoff_s=round(backoff, 3),
            )

    def _respawn(self, backend, watch, now) -> None:
        watch.attempts += 1
        watch.next_restart_t = None
        watch.replacing = True
        try:
            replacement = self.fleet.respawn(backend)
        except Exception as e:
            # The spawn itself failed (a port race, an exec error).  The
            # budget applies here too, or a spawn that always raises
            # would cycle through replacing forever.
            if watch.attempts >= self.restart_budget:
                self._eject(backend, watch, f"respawn_failed: {e}")
                return
            backoff = self._ladder.delay_s(watch.attempts)
            watch.next_restart_t = now + backoff
            if self.fleet.sink:
                self.fleet.sink.emit(
                    "backend_replace_scheduled", backend=backend.name,
                    reason="respawn_failed", attempt=watch.attempts + 1,
                    backoff_s=round(backoff, 3),
                    error=f"{type(e).__name__}: {e}",
                )
            return
        self.fleet.set_state(replacement, STARTING)

    def _serving_again(self, backend, watch, now) -> None:
        """The replacement answered /readyz: route to it (half-open
        trials first) and close the incident."""
        watch.replacing = False
        watch.probe_misses = 0
        watch.restarts += 1
        watch.healthy_since = time.perf_counter()
        self.fleet.set_state(backend, ACTIVE)
        if backend.breaker is not None:
            backend.breaker.half_open()
        downtime = (
            now - watch.down_since if watch.down_since is not None else 0.0
        )
        watch.down_since = None
        watch.recovery_s.append(downtime)
        self.fleet.metrics.registry.counter(
            "fleet_backend_restarts_total",
            help="backend processes replaced by the fleet supervisor "
            "(warm start off the shared AOT cache; zero new traces)",
            backend=backend.name,
        ).inc()
        if self.fleet.sink:
            self.fleet.sink.emit(
                "backend_replace", backend=backend.name,
                attempt=watch.attempts, downtime_s=round(downtime, 3),
            )

    def _eject(self, backend, watch, reason) -> None:
        watch.next_restart_t = None
        watch.replacing = False
        self.fleet.set_state(backend, EJECTED)
        if backend.breaker is not None:
            backend.breaker.force_open("ejected")
        backend.stop(self.grace_s)
        if self.fleet.sink:
            self.fleet.sink.emit(
                "backend_eject", backend=backend.name, reason=str(reason),
                attempts=watch.attempts,
            )

    # -- reads -----------------------------------------------------------------

    def stats(self) -> dict:
        per_backend = {
            name: {
                "restarts": w.restarts,
                "attempts_since_healthy": w.attempts,
                "recovery_s": list(w.recovery_s),
            }
            for name, w in self._watch.items()
        }
        recoveries = [s for w in self._watch.values() for s in w.recovery_s]
        return {
            "backends": per_backend,
            "restarts_total": sum(w.restarts for w in self._watch.values()),
            "mean_recovery_s": (
                sum(recoveries) / len(recoveries) if recoveries else None
            ),
        }


class FleetAutoscaler:
    """Add or drain whole backends from the smoothed load signal.

    The signal is the mean backlog per active backend (polled queue depth
    + in-flight) smoothed by an EWMA, or, with ``signal="p99"``, the
    front's recent p99 latency in seconds.  A breach must SUSTAIN for
    ``window_s`` before acting, a scale event starts a ``cooldown_s``
    during which no further event fires, and the two watermarks are
    apart: three layers of hysteresis, so a signal oscillating between
    the marks never flaps the fleet.

    Scale-up spawns a NEW backend (fresh name) and waits for /readyz;
    scale-down drains the NEWEST active backend: unroutable first, then
    settle (backend queue + in-flight + this front's own proxies all
    zero), then grace-kill: nothing admitted is lost.
    """

    def __init__(
        self,
        fleet: "Fleet",
        high_water: float = 8.0,
        low_water: float = 1.0,
        signal: str = "depth",
        window_s: float = 2.0,
        cooldown_s: float = 5.0,
        min_backends: int = 1,
        max_backends: int = 4,
        interval_s: float = 0.25,
        alpha: float = 0.3,
    ):
        if signal not in ("depth", "p99"):
            raise ValueError(f"unknown autoscale signal {signal!r}")
        if low_water >= high_water:
            raise ValueError(
                f"low_water {low_water} must be < high_water {high_water} "
                "(the hysteresis band)"
            )
        if min_backends < 1 or max_backends < min_backends:
            raise ValueError(
                f"need 1 <= min_backends <= max_backends, got "
                f"{min_backends}..{max_backends}"
            )
        self.fleet = fleet
        self.high_water = float(high_water)
        self.low_water = float(low_water)
        self.signal = signal
        self.window_s = float(window_s)
        self.cooldown_s = float(cooldown_s)
        self.min_backends = int(min_backends)
        self.max_backends = int(max_backends)
        self.interval_s = float(interval_s)
        self.alpha = float(alpha)
        self.smoothed: float | None = None
        self._high_since: float | None = None
        self._low_since: float | None = None
        self._cooldown_until = 0.0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "FleetAutoscaler":
        if self._thread is not None:
            raise RuntimeError("autoscaler already started")
        self._thread = threading.Thread(
            target=self._run, name="fleet-autoscaler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _run(self) -> None:
        last_err = 0.0
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as e:
                # The supervisor's rule: one bad tick must not end
                # autoscaling, and a silent no-op loop must not be possible.
                now = time.monotonic()
                if now - last_err > 5.0:
                    last_err = now
                    print(
                        f"fleet-autoscaler: tick failed: "
                        f"{type(e).__name__}: {e}",
                        file=sys.stderr,
                    )
                    if self.fleet.sink:
                        self.fleet.sink.emit(
                            "autoscaler_tick_error",
                            error=f"{type(e).__name__}: {e}",
                        )

    # -- the control loop ------------------------------------------------------

    def _raw_signal(self) -> float | None:
        active = self.fleet.active_backends()
        if not active:
            return None
        if self.signal == "p99":
            lat = sorted(self.fleet.metrics._latency.values())
            if not lat:
                return 0.0
            from ..obs.registry import percentile

            return percentile(lat, 99)
        return sum(b.load() for b in active) / len(active)

    def observe(self, raw: float) -> float:
        """Fold one raw reading into the EWMA (public for tests)."""
        self.smoothed = (
            raw if self.smoothed is None
            else self.alpha * raw + (1.0 - self.alpha) * self.smoothed
        )
        return self.smoothed

    def tick(self, now: float | None = None, raw: float | None = None) -> None:
        """One control decision (public so tests drive a synthetic signal
        deterministically through ``raw`` and ``now``)."""
        now = now if now is not None else time.perf_counter()
        raw = raw if raw is not None else self._raw_signal()
        if raw is None:
            return
        sig = self.observe(raw)
        n = self.fleet.scalable_count()
        if sig > self.high_water:
            self._low_since = None
            if self._high_since is None:
                self._high_since = now
            elif (
                now - self._high_since >= self.window_s
                and now >= self._cooldown_until
                and n < self.max_backends
            ):
                self._scale("up", sig, now)
        elif sig < self.low_water:
            self._high_since = None
            if self._low_since is None:
                self._low_since = now
            elif (
                now - self._low_since >= self.window_s
                and now >= self._cooldown_until
                and n > self.min_backends
            ):
                self._scale("down", sig, now)
        else:
            # Inside the hysteresis band: both breach clocks reset, so an
            # oscillation between the marks never accumulates.
            self._high_since = None
            self._low_since = None

    def _scale(self, direction: str, sig: float, now: float) -> None:
        fleet = self.fleet
        before = fleet.scalable_count()
        t_scale = time.perf_counter()
        try:
            if direction == "up":
                fleet.add_backend()
            else:
                fleet.remove_backend()
            # Count and emit only an action that took effect: a spawn that
            # missed its ready window or a refused drain must not inflate
            # the scraped tally.
            fleet.metrics.registry.counter(
                "fleet_scale_events_total",
                help="autoscaler actions by direction",
                direction=direction,
            ).inc()
            if fleet.sink:
                fleet.sink.emit(
                    "fleet_scale", direction=direction,
                    backends=before, signal=round(sig, 4),
                    kind=self.signal,
                )
        except Exception:
            if fleet.sink:
                fleet.sink.emit(
                    "fleet_scale_failed", direction=direction,
                    backends=before, signal=round(sig, 4),
                )
            raise
        finally:
            # Cooldown from AFTER the (blocking) bring-up or drain, on the
            # CALLER'S clock (tests tick a synthetic one), and the breach
            # clocks restart: the post-scale fleet proves a breach anew.
            self._cooldown_until = (
                now + (time.perf_counter() - t_scale) + self.cooldown_s
            )
            self._high_since = None
            self._low_since = None
            self.smoothed = None  # the signal's regime just changed


class Fleet:
    """Backends + router + poller (+ optional supervisor/autoscaler).

    ``spawn(name) -> Backend`` is the backend factory: the CLI fleet's
    launches ``python -m pytorch_mnist_ddp_tpu_torch.serving`` processes
    on assigned ports (a name's port reused on replacement); tests spawn
    :class:`FakeBackendServer`\\ s.  Every membership change (add, drain,
    replace, eject) goes through this object, so the router's snapshot
    is always consistent.
    """

    def __init__(
        self,
        spawn,
        policy: str = "cost",
        metrics: ServingMetrics | None = None,
        sink=None,
        default_timeout_s: float = 1.0,
        poll_s: float = 0.25,
        poll_timeout_s: float = 0.5,
        failure_threshold: int = 3,
        trial_limit: int = 1,
        trial_successes: int = 1,
        settle_timeout_s: float = 30.0,
        grace_s: float = 5.0,
        name_prefix: str = "b",
        response_cache: int | None = None,
    ):
        self.spawn = spawn
        self.metrics = metrics if metrics is not None else ServingMetrics()
        self.sink = sink
        # Wire-format accounting for the proxy and, with
        # ``response_cache``, a content-addressed cache keyed on the RAW
        # proxied body: a hit answers without touching a backend, and
        # concurrent identical bodies coalesce onto one proxied dispatch.
        # Every backend serves the same weights for the fleet's life
        # (replacements re-exec the same argv), so the raw body is the
        # content address; ``admin_rollout`` invalidates it.
        self.metrics.ensure_wire()
        self.response_cache = (
            ResponseCache(
                response_cache, metrics=self.metrics, sink=sink,
                scope="front",
            )
            if response_cache else None
        )
        self.poll_s = poll_s
        self.poll_timeout_s = poll_timeout_s
        self.settle_timeout_s = settle_timeout_s
        self.grace_s = grace_s
        self.name_prefix = name_prefix
        self.router = FleetRouter(
            self, policy=policy, default_timeout_s=default_timeout_s
        )
        self._breaker_kwargs = dict(
            failure_threshold=failure_threshold,
            trial_limit=trial_limit,
            trial_successes=trial_successes,
        )
        self.backends: list[Backend] = []
        self.retired: list[Backend] = []
        self._seq = 0
        self._lock = threading.Lock()
        self.supervisor: FleetSupervisor | None = None
        self.autoscaler: FleetAutoscaler | None = None
        self._poller: threading.Thread | None = None
        self._stop_poll = threading.Event()
        # Both scale directions and every state gauge exist from the
        # first exposition, before any event.
        self.metrics.ensure_fleet()
        self._refresh_state_gauges()

    # -- membership reads ------------------------------------------------------

    def backends_snapshot(self) -> list[Backend]:
        with self._lock:
            return list(self.backends)

    def active_backends(self) -> list[Backend]:
        with self._lock:
            return [b for b in self.backends if b.state == ACTIVE]

    def scalable_count(self) -> int:
        """Backends that count toward the autoscaler's bounds: anything
        not permanently out (a replacing backend is still capacity the
        supervisor is bringing back)."""
        with self._lock:
            return sum(
                1 for b in self.backends if b.state not in (EJECTED,)
            )

    def routable_count(self) -> int:
        with self._lock:
            return sum(
                1 for b in self.backends
                if b.state == ACTIVE
                and (b.breaker is None or b.breaker.allows())
            )

    def backend(self, name: str) -> Backend:
        with self._lock:
            for b in self.backends:
                if b.name == name:
                    return b
        raise KeyError(f"no backend named {name!r}")

    def admin_rollout(
        self, path: str, body: bytes, timeout_s: float = 30.0
    ) -> tuple[int, dict]:
        """Forward one rollout admin verb (``POST /admin/*``,
        serving/server.py) to every ACTIVE backend, one after another:
        each backend swaps its weights by reference while its peers keep
        serving, so the fleet drops no request; the canary split needs no
        coordination (every backend hashes a payload to the same side).

        After a mutation the FRONT response cache (keyed on raw request
        bodies, blind to weights) is invalidated; each backend already
        moved its own cache's generation.  A partial failure returns 502
        with per-backend detail and still invalidates (some backends DID
        move); every verb is idempotent at each backend, so the operator
        sends it again to converge."""
        results: dict = {}
        ok = True
        mutation = path != "/admin/rollout"
        for b in self.active_backends():
            try:
                status, data, _ctype = b.request_full(
                    "POST", path, body, timeout_s=timeout_s,
                    headers={"Content-Type": "application/json"},
                )
                try:
                    detail = json.loads(data)
                except ValueError:
                    detail = data.decode("utf-8", errors="replace")
                results[b.name] = {"status": status, "body": detail}
                ok = ok and status == 200
            except (OSError, http.client.HTTPException) as e:
                results[b.name] = {"error": f"{type(e).__name__}: {e}"}
                ok = False
        if mutation and self.response_cache is not None:
            self.response_cache.invalidate()
        if self.sink and mutation:
            self.sink.emit(
                "fleet_admin", path=path, ok=ok,
                backends=sorted(results),
            )
        return (200 if ok else 502), {"ok": ok, "backends": results}

    def set_state(self, backend: Backend, state: str) -> None:
        if state not in BACKEND_STATES:
            raise ValueError(f"unknown backend state {state!r}")
        with self._lock:
            backend.state = state
        self._refresh_state_gauges()

    def _refresh_state_gauges(self) -> None:
        with self._lock:
            counts = {state: 0 for state in BACKEND_STATES}
            for b in self.backends:
                counts[b.state] += 1
            counts[RETIRED] += len(self.retired)
        for state, n in counts.items():
            self.metrics.registry.gauge(
                "fleet_backends",
                help="backend processes by lifecycle state",
                state=state,
            ).set(n)

    # -- lifecycle -------------------------------------------------------------

    def start(
        self,
        n: int,
        wait_ready_s: float = 120.0,
        supervise: bool = True,
        supervisor_kwargs: dict | None = None,
        autoscale: bool = False,
        autoscaler_kwargs: dict | None = None,
    ) -> "Fleet":
        """Spawn the initial backends, wait for every /readyz, then start
        the poller (+ supervisor/autoscaler)."""
        if n < 1:
            raise ValueError(f"fleet size must be >= 1, got {n}")
        for _ in range(n):
            self._spawn_next()
        deadline = time.perf_counter() + wait_ready_s
        for b in self.backends_snapshot():
            self._wait_ready(b, deadline)
        self._poller = threading.Thread(
            target=self._poll_loop, name="fleet-poller", daemon=True
        )
        self._poller.start()
        if supervise:
            self.supervisor = FleetSupervisor(
                self, **(supervisor_kwargs or {})
            ).start()
        if autoscale:
            self.autoscaler = FleetAutoscaler(
                self, **(autoscaler_kwargs or {})
            ).start()
        return self

    def stop(self, grace_s: float | None = None) -> None:
        """Autoscaler and supervisor first (a replacement racing the
        teardown would spawn into a dying fleet), then the poller, then
        grace-stop every backend: SIGTERM is the serving CLI's draining
        shutdown, so admitted work finishes."""
        if self.autoscaler is not None:
            self.autoscaler.stop()
            self.autoscaler = None
        if self.supervisor is not None:
            self.supervisor.stop()
            self.supervisor = None
        self._stop_poll.set()
        if self._poller is not None:
            self._poller.join()
            self._poller = None
        for b in self.backends_snapshot() + list(self.retired):
            b.stop(self.grace_s if grace_s is None else grace_s)

    # -- spawning --------------------------------------------------------------

    def _register(self, backend: Backend, breaker: CircuitBreaker | None) -> None:
        backend.breaker = breaker if breaker is not None else CircuitBreaker(
            backend.name, registry=self.metrics.registry, sink=self.sink,
            **self._breaker_kwargs,
        )
        # The restart family exists per backend from registration (a zero
        # is a statement; an absent family is a flaky grep).
        self.metrics.registry.counter(
            "fleet_backend_restarts_total",
            help="backend processes replaced by the fleet supervisor "
            "(warm start off the shared AOT cache; zero new traces)",
            backend=backend.name,
        )

    def _spawn_next(self) -> Backend:
        with self._lock:
            name = f"{self.name_prefix}{self._seq}"
            self._seq += 1
        backend = self.spawn(name)
        self._register(backend, None)
        with self._lock:
            self.backends.append(backend)
        self._refresh_state_gauges()
        return backend

    def respawn(self, old: Backend) -> Backend:
        """Replacement under the SAME name (the supervisor's mechanics):
        the factory reuses the name's port, the new Backend carries the
        old breaker (open until the half-open trial passes), and the swap
        is atomic under the membership lock."""
        replacement = self.spawn(old.name)
        self._register(replacement, old.breaker)
        with self._lock:
            idx = self.backends.index(old)
            self.backends[idx] = replacement
        self._refresh_state_gauges()
        return replacement

    def _wait_ready(self, backend: Backend, deadline: float) -> None:
        while time.perf_counter() < deadline:
            if not backend.alive():
                raise RuntimeError(
                    f"backend {backend.name} exited during bring-up "
                    f"(code {backend.proc.poll()})"
                )
            if backend.probe_ready(self.poll_timeout_s):
                self.set_state(backend, ACTIVE)
                return
            time.sleep(0.05)
        raise RuntimeError(
            f"backend {backend.name} not ready within the bring-up window"
        )

    # -- elasticity ------------------------------------------------------------

    def add_backend(self, wait_ready_s: float = 120.0) -> str:
        """Scale-up: spawn a NEW backend (fresh name) and block until it
        serves (off the shared store: no nvcc run).  A backend that dies
        or misses its ready window is torn down and REMOVED before the
        error propagates: a zombie "starting" member would count toward
        the autoscaler's max bound forever while serving nothing."""
        backend = self._spawn_next()
        try:
            self._wait_ready(backend, time.perf_counter() + wait_ready_s)
        except Exception:
            backend.stop(self.grace_s)
            with self._lock:
                if backend in self.backends:
                    self.backends.remove(backend)
            self._refresh_state_gauges()
            raise
        return backend.name

    def remove_backend(self, name: str | None = None) -> str:
        """Scale-down: drain → settle → kill, nothing lost.

        The default target is the NEWEST active backend (last in: the
        fleet's stable core stays warm).  The order is the correctness:
        unroutable FIRST (state draining), then wait until the backend's
        own queue and in-flight window are empty AND this front has no
        proxied request open against it, then SIGTERM (the backend's own
        draining shutdown is the second belt)."""
        with self._lock:
            active = [b for b in self.backends if b.state == ACTIVE]
            if name is not None:
                targets = [b for b in active if b.name == name]
                if not targets:
                    raise RuntimeError(f"no active backend named {name!r}")
                target = targets[0]
            else:
                if not active:
                    raise RuntimeError("no active backend to remove")
                target = active[-1]
            if len(active) == 1:
                raise RuntimeError(
                    f"refusing to drain {target.name!r}: it is the last "
                    "active backend (stop the fleet instead)"
                )
            target.state = DRAINING
        self._refresh_state_gauges()
        t0 = time.perf_counter()
        deadline = t0 + self.settle_timeout_s
        while time.perf_counter() < deadline:
            if target.front_inflight == 0:
                snap = target.metrics_json(self.poll_timeout_s)
                if snap is not None:
                    depth = snap.get("queue_depth", 0) or 0
                    inflight = (snap.get("pipeline") or {}).get("inflight", 0) or 0
                    if depth == 0 and inflight == 0:
                        break
            time.sleep(0.05)
        target.stop(self.grace_s)
        with self._lock:
            self.backends.remove(target)
            target.state = RETIRED
            self.retired.append(target)
        self._refresh_state_gauges()
        if self.sink:
            self.sink.emit(
                "backend_drain", backend=target.name,
                duration_s=round(time.perf_counter() - t0, 3),
            )
        return target.name

    # -- the poller ------------------------------------------------------------

    def _poll_loop(self) -> None:
        while not self._stop_poll.wait(self.poll_s):
            for b in self.backends_snapshot():
                if b.state not in (ACTIVE, DRAINING):
                    continue
                self._poll_one(b)

    def _poll_one(self, b: Backend) -> None:
        snap = b.metrics_json(self.poll_timeout_s)
        if snap is None:
            return
        b.polled_depth = int(snap.get("queue_depth", 0) or 0)
        b.polled_inflight = int(
            (snap.get("pipeline") or {}).get("inflight", 0) or 0
        )
        lat = (snap.get("latency_ms") or {}).get("mean")
        if lat:
            b.polled_latency_ms = float(lat)
        compiles = snap.get("compiles")
        if compiles is not None:
            b.polled_compiles = int(compiles)
        b.polled_at = time.perf_counter()

    # -- the /metrics surface --------------------------------------------------

    def snapshot(self, refresh: bool = True) -> dict:
        """The front's /metrics JSON: the ServingMetrics snapshot (the
        front's outcomes and latency) plus the per-backend block and the
        fleet aggregates.  ``refresh`` re-polls each live backend so the
        ``compiles`` tally is current, not ``poll_s`` stale."""
        if refresh:
            for b in self.backends_snapshot():
                if b.state in (ACTIVE, DRAINING):
                    self._poll_one(b)
        with self._lock:
            everything = list(self.backends) + list(self.retired)
            per_backend = {
                b.name: {
                    "state": b.state,
                    "url": b.url,
                    "circuit": (
                        b.breaker.state if b.breaker is not None else None
                    ),
                    "queue_depth": b.polled_depth,
                    "inflight": b.polled_inflight,
                    "front_inflight": b.front_inflight,
                    "ewma_latency_ms": (
                        1e3 * b.ewma_latency_s
                        if b.ewma_latency_s is not None else None
                    ),
                    "compiles": b.polled_compiles,
                }
                for b in everything
            }
            depth_total = sum(
                b.polled_depth for b in self.backends if b.state == ACTIVE
            )
            compiles_total = sum(
                b.polled_compiles or 0 for b in everything
            )
        snap = self.metrics.snapshot(
            queue_depth=depth_total, compiles=compiles_total
        )
        snap["backends"] = per_backend
        snap["fleet"] = {
            "policy": self.router.policy,
            "routable": self.routable_count(),
            "supervisor": (
                self.supervisor.stats() if self.supervisor is not None
                else None
            ),
            "autoscaler": (
                {
                    "signal": self.autoscaler.signal,
                    "smoothed": self.autoscaler.smoothed,
                    "high_water": self.autoscaler.high_water,
                    "low_water": self.autoscaler.low_water,
                    "min": self.autoscaler.min_backends,
                    "max": self.autoscaler.max_backends,
                }
                if self.autoscaler is not None else None
            ),
        }
        return snap


# ---------------------------------------------------------------------------
# The front HTTP surface


class FleetHandler(BaseHTTPRequestHandler):
    server_version = "mnist-fleet/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, format, *args):  # noqa: A002 - stdlib signature
        pass

    def setup(self):
        # A dead or stalled client must not pin a handler thread forever,
        # and a fleet front multiplies held connections by fan-in.
        self.timeout = getattr(self.server, "request_timeout_s", 30.0)
        super().setup()

    def _send_json(self, status: int, payload: dict) -> None:
        self._send_raw(status, json.dumps(payload).encode())

    def _send_raw(
        self, status: int, body: bytes,
        content_type: str = "application/json",
    ) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 - stdlib casing
        fleet: Fleet = self.server.fleet  # type: ignore[attr-defined]
        if self.path == "/healthz":
            self._send_json(200, {
                "status": "ok",
                "backends": {
                    b.name: b.state for b in fleet.backends_snapshot()
                },
            })
        elif self.path == "/readyz":
            n = fleet.routable_count()
            self._send_json(200 if n > 0 else 503, {
                "status": "ready" if n > 0 else "unready",
                "routable_backends": n,
                "backends": {
                    b.name: b.state for b in fleet.backends_snapshot()
                },
                "circuits": {
                    b.name: (b.breaker.state if b.breaker else None)
                    for b in fleet.backends_snapshot()
                },
            })
        elif self.path.startswith("/metrics"):
            wants_prom = (
                "format=prom" in self.path
                or "text/plain" in self.headers.get("Accept", "")
            )
            if wants_prom:
                # Mirror the aggregate gauges from the poller's cache
                # (refresh=False): a scrape must not trigger N synchronous
                # backend round trips whose JSON is then discarded.
                fleet.snapshot(refresh=False)
                self._send_raw(
                    200, render_prometheus(fleet.metrics.registry).encode(),
                    content_type="text/plain; version=0.0.4; charset=utf-8",
                )
            else:
                self._send_json(200, fleet.snapshot())
        else:
            self._send_json(404, {"error": f"no such path {self.path!r}"})

    def do_POST(self):  # noqa: N802 - stdlib casing
        fleet: Fleet = self.server.fleet  # type: ignore[attr-defined]
        admin = self.path.startswith("/admin/")
        if self.path != "/predict" and not admin:
            self._send_json(404, {"error": f"no such path {self.path!r}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            self._send_json(400, {"error": "malformed Content-Length"})
            return
        try:
            body = self.rfile.read(length)
        except (TimeoutError, OSError):
            # The client went silent mid-body: 408 and drop the
            # connection (serving/server.py's idle-client contract).
            try:
                self._send_json(408, {"error": "request body read timed out"})
            except OSError:
                pass
            self.close_connection = True
            return
        if admin:
            # Rolling per-backend forwarding: the fleet tier of
            # swap/canary/rollback.
            status, payload = fleet.admin_rollout(self.path, body)
            self._send_json(status, payload)
            return
        # Pass-through proxy: the request's content type rides to the
        # backend and the backend's rides back; a binary-wire body
        # (serving/wire.py) is never decoded, re-encoded or re-labeled here.
        req_ctype = self.headers.get("Content-Type") or "application/json"
        fmt = (
            "binary"
            if req_ctype.split(";")[0].strip().lower() == WIRE_REQUEST_TYPE
            else "json"
        )
        headers = {"Content-Type": req_ctype}
        cache = fleet.response_cache

        def reply(status, data, ctype):
            fleet.metrics.record_wire(
                fmt, bytes_in=len(body), bytes_out=len(data)
            )
            self._send_raw(status, data, content_type=ctype)

        if cache is None:
            status, data, ctype = fleet.router.submit(body, headers=headers)
            reply(status, data, ctype)
            return
        # Front cache + single flight: the content address is the RAW body
        # under its content type (identical bytes -> identical backend
        # answer, since every backend serves the same weights).  Only 200s
        # fill the cache; any other outcome resolves the current waiters
        # and is dropped, so a refused or failed proxy never becomes a
        # stale fill.  The hash takes the parts in turn: the body is never
        # concatenated or copied on this pass-through tier.
        key = cache.key(req_ctype.encode(), b"\x00", body)
        outcome, val = cache.claim(key)
        if outcome == HIT:
            reply(*val)
            return
        if outcome == COALESCED:
            try:
                result = val.result(fleet.router.default_timeout_s + 1.0)
            except FlightTimeout:
                # This joiner's own deadline, counted like any other
                # client-visible 504 (the claimant's outcome is counted by
                # router.submit).
                fleet.metrics.record_timeout()
                reply(
                    504, b'{"error": "fleet deadline expired"}',
                    "application/json",
                )
                return
            except BaseException as e:
                # The claimant's submit raised (cache.fail re-raised it to
                # every joiner): each waiter still gets exactly one HTTP
                # outcome, never a dropped connection.
                reply(
                    500,
                    json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}
                    ).encode(),
                    "application/json",
                )
                return
            reply(*result)
            return
        try:
            status, data, ctype = fleet.router.submit(body, headers=headers)
        except BaseException as e:
            cache.fail(key, val, e)
            raise
        cache.complete(
            key, val, (status, data, ctype), store=status == 200
        )
        reply(status, data, ctype)


class FleetHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer carrying the fleet for its handlers."""

    daemon_threads = True

    def __init__(
        self, address: tuple[str, int], fleet: Fleet,
        request_timeout_s: float = 30.0,
    ):
        super().__init__(address, FleetHandler)
        self.fleet = fleet
        self.request_timeout_s = request_timeout_s


def make_fleet_server(
    fleet: Fleet,
    host: str = "127.0.0.1",
    port: int = 0,
    request_timeout_s: float = 30.0,
) -> FleetHTTPServer:
    """Wire a (started) fleet into a front HTTP server (port 0 =
    OS-assigned; the bound port is ``server.server_address[1]``)."""
    return FleetHTTPServer((host, port), fleet, request_timeout_s)


# ---------------------------------------------------------------------------
# The structural fake backend (tests)


class _FakeProc:
    """Process-handle duck type for an in-process fake backend."""

    def __init__(self, server: "FakeBackendServer"):
        self._server = server

    def poll(self):
        return None if self._server.running else 0

    def send_signal(self, signum) -> None:
        if signum == signal.SIGKILL:
            self._server.kill()
        else:
            self._server.shutdown()

    def terminate(self) -> None:
        self._server.shutdown()

    def kill(self) -> None:
        self._server.kill()

    def wait(self, timeout=None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while self._server.running:
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired("fake-backend", timeout)
            time.sleep(0.005)
        return 0


class _FakeBackendHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, format, *args):  # noqa: A002 - stdlib signature
        pass

    def _send(self, status: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 - stdlib casing
        fake: FakeBackendServer = self.server.fake  # type: ignore[attr-defined]
        if self.path == "/readyz":
            ready = fake.ready and fake.running
            self._send(200 if ready else 503,
                       {"status": "ready" if ready else "unready"})
        elif self.path == "/healthz":
            self._send(200, {"status": "ok"})
        elif self.path.startswith("/metrics"):
            self._send(200, fake.metrics_snapshot())
        else:
            self._send(404, {"error": self.path})

    def do_POST(self):  # noqa: N802 - stdlib casing
        fake: FakeBackendServer = self.server.fake  # type: ignore[attr-defined]
        length = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(length)
        if fake.fail_predict:
            fake.failed += 1
            self._send(500, {"error": "injected backend failure"})
            return
        try:
            n = len(json.loads(raw or b"{}").get("instances") or [None])
        except ValueError:
            n = 1
        with fake.depth_lock:
            fake.waiting += 1
        # A serial "device": one request at a time per backend, the
        # structural reason N backends beat 1.
        with fake.slot:
            with fake.depth_lock:
                fake.waiting -= 1
                fake.inflight += 1
            time.sleep(fake.service_s)
            with fake.depth_lock:
                fake.inflight -= 1
        if fake.killed:
            # An abrupt kill mid-service: the response is never written
            # (the client sees a transport error, as after a real SIGKILL).
            self.close_connection = True
            return
        fake.completed += 1
        self._send(200, {"predictions": [0] * n})


class FakeBackendServer:
    """A real-HTTP fake serving backend with SERIAL capacity.

    Each fake serves one request at a time, taking ``service_s``, so wall
    time over a fixed workload scales with the backend count, and the
    fleet's routing, replacement and scaling run over genuine sockets
    without N serving processes fighting for the host's cores.
    ``warm_store`` plays the shared ``--aot-cache`` store: a name already
    in it "warm-starts" reporting zero compiles, as a real replacement
    that finds every kernel library in the store.
    """

    def __init__(
        self,
        name: str = "fake",
        service_s: float = 0.02,
        buckets: tuple[int, ...] = (4, 8),
        warm_store: set | None = None,
        heartbeat_file: str | None = None,
        heartbeat_interval_s: float = 0.05,
        port: int = 0,
    ):
        self.name = name
        self.service_s = float(service_s)
        self.ready = True
        self.fail_predict = False
        self.killed = False
        self.waiting = 0
        self.inflight = 0
        self.completed = 0
        self.failed = 0
        self.depth_lock = threading.Lock()
        self.slot = threading.Lock()
        if warm_store is not None and name in warm_store:
            self.compiles = 0
        else:
            self.compiles = len(buckets)
            if warm_store is not None:
                warm_store.add(name)
        self._httpd = ThreadingHTTPServer(
            ("127.0.0.1", port), _FakeBackendHandler
        )
        self._httpd.daemon_threads = True
        self._httpd.fake = self  # type: ignore[attr-defined]
        self.port = self._httpd.server_address[1]
        self.running = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name=f"fake-backend-{name}",
        )
        self._thread.start()
        self._hb_stop = threading.Event()
        self._hb_thread: threading.Thread | None = None
        if heartbeat_file:
            hb = Heartbeat(heartbeat_file, interval_s=heartbeat_interval_s)

            def _beat() -> None:
                while not self._hb_stop.wait(heartbeat_interval_s):
                    hb.beat(force=True)

            self._hb_thread = threading.Thread(target=_beat, daemon=True)
            self._hb_thread.start()

    @property
    def proc(self) -> _FakeProc:
        return _FakeProc(self)

    def metrics_snapshot(self) -> dict:
        with self.depth_lock:
            waiting, inflight = self.waiting, self.inflight
        return {
            "queue_depth": waiting,
            "pipeline": {"inflight": inflight},
            "compiles": self.compiles,
            "requests": {"completed": self.completed, "failed": self.failed},
            "latency_ms": {"mean": 1e3 * self.service_s},
        }

    def stop_heartbeat(self) -> None:
        """Simulate a wedged dispatch loop: alive, answering HTTP, but no
        longer beating (the supervisor's file-age signal)."""
        self._hb_stop.set()

    def shutdown(self) -> None:
        """Graceful stop (the SIGTERM analogue): in-flight requests
        finish, then the server goes away."""
        if not self.running:
            return
        self.running = False
        self._hb_stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()

    def kill(self) -> None:
        """Abrupt stop (the SIGKILL analogue): in-flight requests get
        their connections dropped without a response."""
        if not self.running:
            return
        self.killed = True
        self.running = False
        self._hb_stop.set()
        self._httpd.shutdown()
        self._httpd.server_close()


def fake_backend_spawner(
    service_s: float = 0.02,
    buckets: tuple[int, ...] = (4, 8),
    warm_store: set | None = None,
    heartbeat_dir: str | None = None,
    registry: dict | None = None,
):
    """A ``spawn(name) -> Backend`` factory over fake backends.

    ``warm_store`` (a plain set, shared across spawns) makes every
    REPLACEMENT warm-start with zero compiles; ``registry`` (a dict, if
    given) maps name -> live FakeBackendServer so tests can reach the
    fake to kill or hang it.
    """
    store = warm_store if warm_store is not None else set()

    def spawn(name: str) -> Backend:
        hb = (
            heartbeat_path(heartbeat_dir, name) if heartbeat_dir else None
        )
        fake = FakeBackendServer(
            name=name, service_s=service_s, buckets=buckets,
            warm_store=store, heartbeat_file=hb,
        )
        if registry is not None:
            registry[name] = fake
        return Backend(
            name, "127.0.0.1", fake.port, proc=fake.proc,
            heartbeat_file=hb,
        )

    return spawn


def subprocess_backend_spawner(
    backend_args: list[str],
    host: str = "127.0.0.1",
    base_port: int = 8101,
    heartbeat_dir: str | None = None,
    log_dir: str | None = None,
):
    """A ``spawn(name) -> Backend`` factory over REAL serving processes:
    ``python -m pytorch_mnist_ddp_tpu_torch.serving <backend_args> --host
    H --port P``.  Ports are assigned by name, so a REPLACEMENT reuses
    its predecessor's port (``HTTPServer.allow_reuse_address`` makes the
    rebind safe); ``backend_args`` should carry a shared ``--aot-cache``
    so replacements warm-start.  ``spawn.handles`` maps backend name ->
    its open log file (one per name, reused across respawns; the owner
    closes them at fleet exit)."""
    ports: dict[str, int] = {}
    handles: dict[str, object] = {}

    def spawn(name: str) -> Backend:
        port = ports.setdefault(name, base_port + len(ports))
        hb = heartbeat_path(heartbeat_dir, name) if heartbeat_dir else None
        cmd = [
            sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.serving",
            *backend_args, "--host", host, "--port", str(port),
        ]
        if log_dir:
            # A telemetry subdirectory a backend: the front strips the
            # operator's --telemetry-dir from backend argv (two backends
            # sharing one dir would collide on the JSONL file name), so it
            # is added back scoped by name.  A replacement reuses its
            # predecessor's subdirectory; the sink appends, so the event
            # trail survives respawns.
            cmd += ["--telemetry-dir", os.path.join(log_dir, name)]
        env = dict(os.environ)
        if hb:
            env[ENV_FLEET_HEARTBEAT_FILE] = hb
        # The backend imports this package whatever the operator's CWD.
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))
        ))
        env["PYTHONPATH"] = (
            pkg_root + os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH") else pkg_root
        )
        stdout = stderr = None
        if log_dir:
            # ONE append-mode handle per name, reused across respawns: a
            # replacement inherits its predecessor's log file, and a
            # flapping backend cannot leak an FD per incident.
            stdout = handles.get(name)
            if stdout is None:
                stdout = handles[name] = open(
                    os.path.join(log_dir, f"backend-{name}.log"), "ab"
                )
            stderr = subprocess.STDOUT
        proc = subprocess.Popen(
            cmd, env=env, start_new_session=True,
            stdout=stdout, stderr=stderr,
        )
        return Backend(name, host, port, proc=proc, heartbeat_file=hb)

    spawn.ports = ports
    spawn.handles = handles  # the owner closes these at fleet exit
    return spawn


# ---------------------------------------------------------------------------
# The CLI fleet (python -m pytorch_mnist_ddp_tpu_torch.serving --fleet N)

# Front-only flags that must NOT reach a backend's command line (the
# backend is this same CLI, without a fleet, on its own port).
_FLEET_VALUE_FLAGS = {
    "--fleet", "--fleet-base-port", "--fleet-restart-budget",
    "--fleet-heartbeat-timeout-s", "--fleet-ready-timeout-s",
    "--scale-high", "--scale-low", "--scale-min", "--scale-max",
    "--scale-window-s", "--scale-cooldown-s",
    "--port", "--host", "--telemetry-dir", "--aot-cache",
}
_FLEET_BOOL_FLAGS = {"--autoscale"}


def backend_argv(argv: list[str]) -> list[str]:
    """Strip the front's flags (and those set per backend: port, host,
    telemetry dir, store) from the CLI argv, so a backend runs the
    ORIGINAL serving configuration."""
    out: list[str] = []
    skip = False
    for arg in argv:
        if skip:
            skip = False
            continue
        if arg in _FLEET_VALUE_FLAGS:
            skip = True
            continue
        if arg in _FLEET_BOOL_FLAGS:
            continue
        if any(arg.startswith(flag + "=")
               for flag in _FLEET_VALUE_FLAGS | _FLEET_BOOL_FLAGS):
            continue
        out.append(arg)
    return out


def run_fleet(args, argv: list[str]) -> int:
    """The ``--fleet N`` entry point (serving/__main__.py delegates here
    before anything imports torch): spawn N backend serving processes,
    front them with the router + supervisor (+ autoscaler), serve."""
    import shutil
    import tempfile

    from ..obs.events import EventSink, NullSink

    sink = (
        EventSink(args.telemetry_dir, filename="events-fleet.jsonl")
        if args.telemetry_dir else NullSink()
    )
    if sink:
        print(f"fleet telemetry: {sink.path}")
    metrics = ServingMetrics()
    scratch: list[str] = []
    aot_cache = args.aot_cache
    if aot_cache is None:
        # Warm replacements need ONE store every backend (and every
        # replacement) shares: without an operator-named one, a store a
        # run still makes a replacement run no nvcc; only warmth across
        # runs needs --aot-cache.
        aot_cache = tempfile.mkdtemp(prefix="fleet-aot-")
        scratch.append(aot_cache)
    hb_dir = tempfile.mkdtemp(prefix="fleet-hb-")
    scratch.append(hb_dir)
    base_port = (
        args.fleet_base_port if args.fleet_base_port is not None
        else args.port + 1
    )
    spawn = subprocess_backend_spawner(
        backend_argv(argv) + ["--aot-cache", aot_cache],
        host=args.host, base_port=base_port, heartbeat_dir=hb_dir,
        log_dir=args.telemetry_dir,
    )
    logs = spawn.handles.values()
    fleet = Fleet(
        spawn, policy=args.router_policy, metrics=metrics, sink=sink,
        # The front's routing deadline: the backend's own --timeout-ms
        # plus slack, so a loaded backend answers its OWN 504 (the
        # informative one) and the front's 504 only backs up a hung
        # transport.
        default_timeout_s=args.timeout_ms / 1e3 + 2.0,
        # Two tiers of caching: the flag also rides backend_argv (it is
        # not a front-only flag), so backends cache at their own admission
        # while the front absorbs exact-repeat bodies here.
        response_cache=args.response_cache,
    )
    print(
        f"fleet: spawning {args.fleet} backend(s) on ports "
        f"{base_port}..{base_port + args.fleet - 1} "
        f"(shared AOT cache {aot_cache})"
    )
    try:
        fleet.start(
            args.fleet,
            wait_ready_s=args.fleet_ready_timeout_s,
            supervise=True,
            supervisor_kwargs=dict(
                restart_budget=args.fleet_restart_budget,
                heartbeat_timeout_s=args.fleet_heartbeat_timeout_s,
                ready_timeout_s=args.fleet_ready_timeout_s,
                seed=args.seed,
            ),
            autoscale=args.autoscale,
            autoscaler_kwargs=dict(
                high_water=args.scale_high,
                low_water=args.scale_low,
                min_backends=args.scale_min,
                max_backends=args.scale_max,
                window_s=args.scale_window_s,
                cooldown_s=args.scale_cooldown_s,
            ) if args.autoscale else None,
        )
    except Exception as e:
        print(f"fleet: bring-up failed: {type(e).__name__}: {e}",
              file=sys.stderr)
        fleet.stop()
        sink.close()
        for f in logs:
            f.close()
        return 1
    server = make_fleet_server(
        fleet, host=args.host, port=args.port,
        request_timeout_s=args.request_timeout_s,
    )
    host, port = server.server_address[:2]
    print(
        f"fleet front on http://{host}:{port} (POST /predict, GET /metrics, "
        f"/healthz, /readyz; {args.fleet} backends, policy "
        f"{args.router_policy}, autoscale "
        + (f"on [{args.scale_low:g}..{args.scale_high:g} depth, "
           f"{args.scale_min}..{args.scale_max} backends]"
           if args.autoscale else "off")
        + ")",
        flush=True,
    )

    def _shutdown(signum, frame):
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _shutdown)
    signal.signal(signal.SIGINT, _shutdown)
    try:
        server.serve_forever()
    finally:
        print("fleet: draining backends...")
        fleet.stop()
        server.server_close()
        print(metrics.report_lines())
        sink.close()
        for f in logs:
            f.close()
        for path in scratch:
            shutil.rmtree(path, ignore_errors=True)
    return 0
