"""Queue-aware admission router over a pool of serving replicas (the JAX
package's ``serving/router.py``).

HTTP handlers (or any caller) ``submit()`` here, and the router places
each request onto one replica's micro-batcher, which then coalesces it
with that replica's other requests.

Placement policies (``--router-policy``):

- **roundrobin** — rotate over the active replicas, load-blind;
- **least-loaded** — smallest ``queue depth + in-flight batches``;
- **cost** (default) — expected time to answer, ``(load + 1) x EWMA
  latency`` of the request's shape class on that replica, fed by each
  batcher's completion worker (``on_complete``); a replica without samples
  in the class scores with the class's pool mean, and with no samples at
  all the policy is least-loaded.

Each decision lands on ``serving_router_decisions_total{policy=,replica=}``
and ``serving_router_shape_decisions_total{policy=,shape_class=}`` (and,
with a sink, as a ``router_decision`` event).

**Oversize requests.**  A request larger than one replica's top bucket is
split into near-equal chunks placed independently; :class:`ShardedRequest`
puts the chunks' rows back in arrival order.  The cap becomes ``active
replicas x max batch``.

**Elasticity.**  :meth:`Router.drain` marks a replica unroutable first,
then stops its batcher with ``drain=True`` (nothing admitted is lost);
:meth:`Router.attach` re-adds one with a fresh batcher.

**Fault tolerance.**  Every replica has a
:class:`~.circuit.CircuitBreaker`: consecutive batch failures open it and
placement skips the replica; :meth:`Router.quarantine` (the supervisor's,
serving/pool.py) forces it open and aborts the batcher, whose requests
complete with :class:`~.batcher.ReplicaDeadError` so the server retries
them on a survivor; after a restart the circuit is half-open and admits
trial requests until one passes.  :class:`HedgeManager` re-dispatches a
straggler to a second replica; the first completion wins.

Standard library and numpy only; the JAX package's logic, decision for
decision (tests/test_torch_router.py holds the two routers, hedgers and
supervisors to the same scripted loads).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..analysis.lockwatch import make_lock
from .batcher import MicroBatcher, PendingRequest, RejectedError
from .circuit import CIRCUIT_CLOSED, CIRCUIT_HALF_OPEN, CircuitBreaker
from .qos import DEFAULT_QOS

POLICIES = ("roundrobin", "least-loaded", "cost")

# EWMA smoothing for per-replica request latency: ~5 requests of memory,
# fast enough to notice a replica going slow, smooth enough not to
# thrash on one outlier.
EWMA_ALPHA = 0.2


def shape_class(rows: int | None) -> str:
    """Pow2-ceiling shape-class label (``"b8"`` holds 5..8 rows).

    The cost policy's latency samples are bucketed the way the engine
    pads, so one class aggregates requests that cost the SAME device
    work — in a heterogeneous pool (a 4-device TP replica beside
    1-device DP replicas) a replica's big-batch speedup must not be
    credited to its small-batch requests, or vice versa."""
    if not rows or rows < 1:
        return "b1"
    b = 1
    while b < rows:
        b *= 2
    return f"b{b}"


class Replica:
    """One routable replica: a name, its (started) batcher, optionally
    the engine behind it, and the router-side load state.

    The object is persistent across drain/re-add cycles — the router
    holds it forever and :meth:`reactivate` swaps in a fresh batcher —
    so membership changes never race list mutation in the hot path.
    """

    def __init__(self, name: str, batcher: MicroBatcher, engine=None):
        self.name = name
        self.batcher = batcher
        self.engine = engine
        # active | draining | drained | quarantined | restarting | ejected
        # (the last three are supervisor-owned, serving/pool.py).
        self.state = "active"
        # Assigned by the Router (it owns registry + sink); standalone
        # Replica objects in tests stay breaker-less and unrestricted.
        self.breaker: CircuitBreaker | None = None
        self._ewma_s: float | None = None
        # Per-shape-class EWMAs (cost policy): {"b8": seconds, ...}.
        self._class_ewma_s: dict[str, float] = {}

    # -- load signals --------------------------------------------------------

    def observe_latency(self, latency_s: float, rows: int | None = None) -> None:
        """Completion-worker hook (MicroBatcher ``on_complete``): feed
        the per-replica EWMAs the cost policy scores with, and count the
        success toward the circuit breaker.  ``rows`` (the completed
        request's row count) additionally lands the sample on its
        shape class, so a heterogeneous replica's per-shape profile —
        a TP replica that is fast at b64 but ordinary at b1 — is scored
        per class, not smeared into one number.  ``rows=None`` (legacy
        callers) keeps only the global EWMA."""
        prev = self._ewma_s
        self._ewma_s = (
            latency_s if prev is None
            else EWMA_ALPHA * latency_s + (1.0 - EWMA_ALPHA) * prev
        )
        if rows is not None:
            cls = shape_class(rows)
            prev_c = self._class_ewma_s.get(cls)
            self._class_ewma_s[cls] = (
                latency_s if prev_c is None
                else EWMA_ALPHA * latency_s + (1.0 - EWMA_ALPHA) * prev_c
            )
        if self.breaker is not None:
            self.breaker.record_success()

    def class_latency_s(self, cls: str) -> float | None:
        """This replica's EWMA latency for one shape class (None until
        a request of that class completes here)."""
        return self._class_ewma_s.get(cls)

    def observe_failure(self, count: int = 1) -> None:
        """Worker failure hook (MicroBatcher ``on_failure``): one failed
        BATCH is one breaker strike regardless of how many requests rode
        it — the breaker measures replica health, not blast radius."""
        if self.breaker is not None:
            self.breaker.record_failure()

    def observe_expiry(self, count: int = 1) -> None:
        """Queue-expiry hook (MicroBatcher ``on_expire``): a request
        that timed out before dispatch is no verdict on the replica, but
        any half-open trial token it held must come back — otherwise the
        breaker stays half-open forever with its whole trial quota
        leaked to requests that never ran."""
        if self.breaker is not None:
            for _ in range(count):
                self.breaker.release()

    @property
    def ewma_latency_s(self) -> float | None:
        return self._ewma_s

    def load(self) -> int:
        """Queue depth + in-flight batches — the live backlog."""
        return self.batcher.depth() + self.batcher.inflight()

    # -- membership ----------------------------------------------------------

    @property
    def active(self) -> bool:
        return self.state == "active"

    def reactivate(self, batcher: MicroBatcher) -> None:
        # "restarting" is the supervisor's restart path (serving/pool.py)
        # — same fresh-batcher-around-a-warm-engine move as a re-add.
        if self.state not in ("drained", "restarting"):
            raise RuntimeError(
                f"replica {self.name!r} is {self.state}, not drained; "
                "drain it before attaching a new batcher"
            )
        self.batcher = batcher
        self._ewma_s = None  # stale latency must not bias placement
        self._class_ewma_s = {}
        self.state = "active"


class ShardedRequest:
    """N chunk requests posing as one: data-parallel sharded dispatch.

    ``result()`` concatenates chunk results in submit (= arrival) order,
    so the caller sees exactly the rows it sent, reassembled.  Any chunk
    error propagates as the request's error (remaining chunks still
    complete on their replicas; device work is never torn mid-batch).
    """

    def __init__(self, parts: list[PendingRequest]):
        self._parts = parts
        self._value: np.ndarray | None = None

    @property
    def n(self) -> int:
        return sum(p.n for p in self._parts)

    def result(self, grace_s: float = 1.0) -> np.ndarray:
        if self._value is None:
            self._value = np.concatenate(
                [p.result(grace_s) for p in self._parts]
            )
        return self._value


class _HedgeEntry:
    """One tracked request awaiting its hedge decision."""

    __slots__ = ("req", "origin", "due_t", "placed", "attempted")

    def __init__(self, req: PendingRequest, origin: str, due_t: float):
        self.req = req
        self.origin = origin
        self.due_t = due_t
        self.placed: str | None = None   # hedge replica once dispatched
        self.attempted = False           # a due hedge tried to place


class HedgeManager:
    """Hedged dispatch: re-submit the straggler request to a SECOND
    replica after a tail-derived delay; first completion wins.

    The tail-latency move: once a request has waited
    past its class's p99, the most likely explanation is that its
    replica is having a bad time (deep batch, slow device, noisy
    neighbor) — a copy on a healthy replica usually answers first, at
    the cost of ~1% duplicated work.  Safety comes from primitives that
    already exist: the hedge enqueues the SAME :class:`~.batcher
    .PendingRequest` (``MicroBatcher.submit_hedge``), so the request's
    first-wins lock guarantees exactly one client-visible outcome, and
    the batcher's win-gated accounting keeps the loser's completion off
    the metrics and breaker surfaces — a hedge can never double-count
    (tests/test_torch_router.py pins it).

    Delay: ``delay_ms`` fixed, or — when None — the request class's
    ONLINE p99 from the per-QoS latency digest
    (``ServingMetrics.qos_p99_s``); no hedging until the digest has
    ``min_samples`` observations, so a cold start never hedges on noise.

    Placement: least-loaded active replica other than the origin, with
    a CLOSED breaker only — half-open circuits carry supervised trial
    traffic, and a hedge must neither consume a trial token it cannot
    return nor evict real work (``submit_hedge`` never sheds).

    Outcomes land on ``serving_hedges_total{outcome=}`` +
    ``hedge_dispatch``/``hedge_outcome`` events: **won** (the hedge's
    completion was the client-visible one), **lost** (the primary
    answered first; the duplicate was discarded by first-wins),
    **cancelled** (a due hedge was abandoned — target queues full, no
    eligible replica, or the request settled/expired before a decisive
    dispatch).  Requests that complete before their delay elapses are
    simply untracked: they were never hedges.
    """

    def __init__(
        self,
        router: "Router",
        delay_ms: float | None = None,
        poll_s: float = 0.005,
        min_samples: int = 20,
        digest_refresh_s: float = 0.25,
    ):
        self.router = router
        self.delay_ms = delay_ms
        self.poll_s = poll_s
        self.min_samples = min_samples
        self.digest_refresh_s = digest_refresh_s
        self._entries: list[_HedgeEntry] = []
        self._lock = make_lock("router.hedge")
        self._p99: dict[str, tuple[float, float | None]] = {}  # qos -> (t, p99)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if router.metrics is not None:
            # The outcome family must be scrapeable before the first
            # hedge fires (CI greps a short smoke's exposition).
            router.metrics.ensure_hedges()

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "HedgeManager":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="serve-hedger", daemon=True
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- tracking (router submit path) ----------------------------------------

    def _delay_s(self, qos: str, now: float) -> float | None:
        if self.delay_ms is not None:
            return self.delay_ms / 1e3
        cached = self._p99.get(qos)
        if cached is None or now - cached[0] > self.digest_refresh_s:
            metrics = self.router.metrics
            p99 = (
                metrics.qos_p99_s(qos, min_samples=self.min_samples)
                if metrics is not None else None
            )
            self._p99[qos] = cached = (now, p99)
        return cached[1]

    def track(self, req: PendingRequest, origin: str) -> None:
        now = time.perf_counter()
        delay = self._delay_s(getattr(req, "qos", DEFAULT_QOS), now)
        if delay is None:
            return  # digest still cold: no hedging on noise
        due = now + delay
        if due >= req.deadline:
            return  # the hedge could never answer inside the deadline
        with self._lock:
            self._entries.append(_HedgeEntry(req, origin, due))

    # -- the decision loop ----------------------------------------------------

    def _run(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.tick()
            except Exception:
                # One bad tick (a replica torn down mid-inspection) must
                # not end hedging for the life of the process.
                pass
        # Shutdown: resolve what we can so counters don't dangle —
        # resolve ONLY: dispatching a new hedge here would land it on a
        # batcher about to drain (the reason Router.stop stops the
        # hedger first) with nobody left to resolve its outcome.
        try:
            self.tick(dispatch=False)
        except Exception:
            pass  # a replica torn down concurrently with shutdown

    def tick(self, now: float | None = None, dispatch: bool = True) -> None:
        """One inspection pass (public so tests step deterministically).
        ``dispatch=False`` resolves settled entries without placing new
        hedges (the shutdown pass)."""
        now = now if now is not None else time.perf_counter()
        with self._lock:
            entries = list(self._entries)
        done: set[_HedgeEntry] = set()
        for entry in entries:
            if entry.req.done():
                if entry.placed is not None:
                    # completed_by is set only by a WINNING completion
                    # worker: the hedge replica -> won; another replica
                    # (the primary) -> lost; None -> the outcome was an
                    # error with no replica behind it (expiry, flush) —
                    # nobody's dispatch was decisive, so it counts as
                    # cancelled, not as a primary win ("lost" would
                    # deflate the reported win rate with every 504).
                    by = entry.req.completed_by
                    self._resolve(
                        entry,
                        "won" if by == entry.placed
                        else ("lost" if by is not None else "cancelled"),
                    )
                elif entry.attempted:
                    self._resolve(entry, "cancelled")
                done.add(entry)
            elif entry.req.expired(now):
                if entry.placed is not None or entry.attempted:
                    self._resolve(entry, "cancelled")
                done.add(entry)
            elif (dispatch and entry.placed is None
                    and now >= entry.due_t):
                entry.attempted = True
                self._dispatch_hedge(entry)
        if done:
            with self._lock:
                self._entries = [
                    e for e in self._entries if e not in done
                ]

    def _dispatch_hedge(self, entry: _HedgeEntry) -> None:
        req = entry.req
        candidates = [
            r for r in self.router.active()
            if r.name != entry.origin
            and (r.breaker is None or r.breaker.state == CIRCUIT_CLOSED)
        ]
        candidates.sort(key=lambda r: r.load())
        for r in candidates:
            if not hasattr(r.batcher, "submit_hedge"):
                continue  # a fake/legacy batcher without the surface
            try:
                r.batcher.submit_hedge(req)
            except RejectedError:
                # Full queue / draining: try the next candidate this
                # tick, the rest next tick.  (Deliberately NOT catching
                # AttributeError here — a bug inside submit_hedge must
                # stay loud, not read as "replica declined".)
                continue
            entry.placed = r.name
            if self.router._registry is not None:
                self.router._registry.counter(
                    "serving_hedge_dispatches_total",
                    help="hedge re-dispatches placed, by target replica",
                    replica=r.name,
                ).inc()
            if self.router._sink:
                self.router._sink.emit(
                    "hedge_dispatch", origin=entry.origin, replica=r.name,
                    qos=getattr(req, "qos", DEFAULT_QOS),
                    waited_ms=1e3 * (time.perf_counter() - req.t_submit),
                )
            return

    def _resolve(self, entry: _HedgeEntry, outcome: str) -> None:
        if self.router.metrics is not None:
            self.router.metrics.record_hedge(outcome)
        if self.router._sink:
            self.router._sink.emit(
                "hedge_outcome", outcome=outcome, origin=entry.origin,
                **({"replica": entry.placed} if entry.placed else {}),
                qos=getattr(entry.req, "qos", DEFAULT_QOS),
            )

    def pending(self) -> int:
        with self._lock:
            return len(self._entries)


class Router:
    """Shared admission front: place requests over replica batchers.

    ``submit()`` mirrors the MicroBatcher surface (the HTTP handlers
    cannot tell a router from a batcher), plus the
    aggregate ``depth``/``inflight`` reads the server's ``/metrics``
    snapshot uses.  Thread-safe: any number of handler threads submit
    concurrently; membership changes (:meth:`drain`/:meth:`attach`)
    take the same lock as placement ordering.
    """

    def __init__(
        self,
        replicas: list[Replica],
        policy: str = "cost",
        registry=None,
        sink=None,
        metrics=None,
        failure_threshold: int = 3,
        trial_limit: int = 1,
        trial_successes: int = 1,
        hedge: bool = False,
        hedge_delay_ms: float | None = None,
        hedge_poll_s: float = 0.005,
    ):
        if policy not in POLICIES:
            raise ValueError(f"unknown router policy {policy!r}; have {POLICIES}")
        if not replicas:
            raise ValueError("router needs at least one replica")
        names = [r.name for r in replicas]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate replica names: {names}")
        self.policy = policy
        self.replicas = list(replicas)
        self.metrics = metrics
        self._registry = registry
        self._sink = sink
        self._lock = make_lock("router.replicas")
        self._rr = 0
        self._breaker_kwargs = dict(
            failure_threshold=failure_threshold,
            trial_limit=trial_limit,
            trial_successes=trial_successes,
        )
        for r in self.replicas:
            r.breaker = CircuitBreaker(
                r.name, registry=registry, sink=sink, **self._breaker_kwargs
            )
        self._drain_hist = (
            registry.histogram(
                "serving_replica_drain_seconds",
                help="wall time of a graceful replica drain (queue + "
                "in-flight window finished, nothing dropped)",
            )
            if registry is not None
            else None
        )
        # Hedged dispatch: off by
        # default; ``hedge_delay_ms=None`` derives the delay from each
        # class's online p99 digest.  One replica cannot hedge.
        self.hedger: HedgeManager | None = None
        if hedge and len(self.replicas) > 1:
            self.hedger = HedgeManager(
                self, delay_ms=hedge_delay_ms, poll_s=hedge_poll_s
            ).start()

    # -- membership / aggregate reads ----------------------------------------

    def active(self) -> list[Replica]:
        with self._lock:
            return [r for r in self.replicas if r.active]

    def routable_count(self) -> int:
        """Active replicas whose circuit currently admits placement —
        the readiness signal (``/readyz``): zero
        means every replica is draining, quarantined, ejected, or
        circuit-blocked, and new requests can only 503."""
        with self._lock:
            return sum(
                1 for r in self.replicas
                if r.active and (r.breaker is None or r.breaker.allows())
            )

    def replica(self, name: str) -> Replica:
        for r in self.replicas:
            if r.name == name:
                return r
        raise KeyError(f"no replica named {name!r}")

    def depth(self) -> int:
        """Summed admission-queue depth over ALL replicas — a draining
        replica's queued work still occupies its device and must not
        read as load that vanished (drained batchers report 0)."""
        return sum(r.batcher.depth() for r in self.replicas)

    def inflight(self) -> int:
        """Summed launched-not-yet-read batches over ALL replicas (see
        :meth:`depth` — draining work is still live work)."""
        return sum(r.batcher.inflight() for r in self.replicas)

    @property
    def max_inflight(self) -> int:
        return sum(r.batcher.max_inflight for r in self.active())

    @property
    def qos_classes(self) -> tuple[str, ...]:
        """The pool's QoS classes (batchers are built identically, so
        replica 0 speaks for all) — the server's 400-validation list."""
        batcher = self.replicas[0].batcher
        return getattr(batcher, "qos_classes", ())

    @property
    def timeout_s(self) -> float:
        """The pool's default per-request deadline (min over replicas)
        — lets the handler's drain-race retry pass the REMAINING budget
        instead of granting the resubmission a fresh full deadline."""
        return min(r.batcher.timeout_s for r in self.replicas)

    @property
    def current_linger_ms(self) -> float:
        lingers = [r.batcher.current_linger_ms for r in self.active()]
        return sum(lingers) / len(lingers) if lingers else 0.0

    def replica_stats(self) -> dict[str, dict]:
        """Per-replica live state: the ``/metrics`` ``replicas`` block."""
        return {
            r.name: {
                "state": r.state,
                "circuit": r.breaker.state if r.breaker is not None else None,
                "queue_depth": r.batcher.depth(),
                "qos_depth": (
                    r.batcher.qos_depths()
                    if hasattr(r.batcher, "qos_depths") else None
                ),
                "inflight": r.batcher.inflight(),
                "ewma_latency_ms": (
                    1e3 * r.ewma_latency_s
                    if r.ewma_latency_s is not None else None
                ),
                "class_ewma_ms": {
                    cls: 1e3 * s
                    for cls, s in sorted(r._class_ewma_s.items())
                },
            }
            for r in self.replicas
        }

    # -- placement ------------------------------------------------------------

    @staticmethod
    def _trials_first(order: list[Replica]) -> list[Replica]:
        """Stable-partition half-open replicas with free trial tokens to
        the front.  A half-open circuit can only close by carrying trial
        traffic, and policy order alone may never offer it any: the cost
        policy ranks a restarted replica by its persisted EWMA, so a
        slow-but-recovered replica sorts last and a light request stream
        (or the post-chaos recovery probe) lands every request on its
        healthier peers — leaving it half-open forever.  Preferring it
        is safe because ``try_acquire`` bounds exposure to
        ``trial_limit`` concurrent trials; everything past the quota
        falls through to normal policy order on the same pass."""
        trials = [
            r for r in order
            if r.breaker is not None
            and r.breaker.state == CIRCUIT_HALF_OPEN
            and r.breaker.allows()
        ]
        if not trials:
            return order
        return trials + [r for r in order if r not in trials]

    def _order(
        self, active: list[Replica], rows: int | None = None
    ) -> list[Replica]:
        """Active replicas, best placement first, under the lock."""
        with self._lock:
            rotation = self._rr
            self._rr += 1
        if self.policy == "roundrobin":
            k = rotation % len(active)
            return self._trials_first(active[k:] + active[:k])
        if self.policy == "least-loaded":
            key = lambda r: r.load()  # noqa: E731 - local sort key
        else:
            # cost: expected time-to-answer = (backlog + this request) x
            # EWMA latency for THIS request's shape class.  Per-class
            # scoring is what makes heterogeneous pools routable: a
            # 4-device TP replica is several times faster at the top
            # bucket but ordinary at b1, and one smeared EWMA would
            # either hide the big-batch win or falsely promote it for
            # small requests.  A replica without samples in the class
            # scores with the CLASS's pool-mean as its prior — not the
            # replica's other-shape samples (a fresh TP replica's b1
            # latency says nothing about its b64), and not last place,
            # which would starve it of the very traffic that builds its
            # estimate.  No samples in the class anywhere -> the legacy
            # global-EWMA score; no samples at all -> least-loaded (the
            # documented fallback).
            cls = shape_class(rows) if rows is not None else None
            class_ewmas = (
                [
                    e for e in
                    (r.class_latency_s(cls) for r in active)
                    if e is not None
                ]
                if cls is not None else []
            )
            if class_ewmas:
                prior = sum(class_ewmas) / len(class_ewmas)

                def key(r: Replica):
                    ewma = r.class_latency_s(cls)
                    return (r.load() + 1) * (prior if ewma is None else ewma)
            else:
                ewmas = [
                    r.ewma_latency_s for r in active
                    if r.ewma_latency_s is not None
                ]
                if not ewmas:
                    key = lambda r: r.load()  # noqa: E731 - local sort key
                else:
                    prior = sum(ewmas) / len(ewmas)

                    def key(r: Replica):
                        ewma = r.ewma_latency_s
                        return (r.load() + 1) * (
                            prior if ewma is None else ewma
                        )
        # Rotate before the stable sort so exact ties spread over
        # replicas instead of always landing on the first name.
        k = rotation % len(active)
        return self._trials_first(sorted(active[k:] + active[:k], key=key))

    def _note(self, replica: Replica, rows: int) -> None:
        cls = shape_class(rows)
        if self._registry is not None:
            self._registry.counter(
                "serving_router_decisions_total",
                help="request placements by policy and chosen replica",
                policy=self.policy,
                replica=replica.name,
            ).inc()
            # A separate family, not an extra label on the one above:
            # the shape tally answers which classes the policy routed.
            self._registry.counter(
                "serving_router_shape_decisions_total",
                help="request placements by policy and request shape "
                "class (pow2-ceiling rows bucket)",
                policy=self.policy,
                shape_class=cls,
            ).inc()
        if self._sink:
            self._sink.emit(
                "router_decision", policy=self.policy,
                replica=replica.name, rows=rows, shape_class=cls,
            )

    def submit(
        self,
        x: np.ndarray,
        timeout_ms: float | None = None,
        dtype: str | None = None,
        qos: str | None = None,
    ) -> PendingRequest | ShardedRequest:
        """Place one request (or its shards) onto the pool.

        Tries replicas in policy order: a replica that rejects (queue
        full, or a drain racing this submit) is transparently skipped —
        only when EVERY active replica refuses does the caller see the
        503.  Per-attempt rejections are not double-counted on the
        metrics surface (only the final, client-visible one is).
        ``qos`` rides through to each batcher's weighted admission
        queue (serving/qos.py); placed requests are registered with the
        hedger when hedging is on (sharded chunks are not hedged — a
        chunk's twin would race its own reassembly).
        """
        active = self.active()
        if not active:
            if self.metrics is not None:
                self.metrics.record_rejected()
            raise RejectedError("no active replicas")
        x = np.asarray(x, np.float32)
        cap = min(r.batcher.max_batch for r in active)
        if len(x) > cap:
            return self._submit_sharded(x, active, cap, timeout_ms, dtype, qos)
        req, placed = self._place(x, active, timeout_ms, dtype, qos)
        if self.hedger is not None and (
            placed.breaker is None
            or placed.breaker.state == CIRCUIT_CLOSED
        ):
            # Never hedge a request placed on a non-closed origin: a
            # half-open placement holds one of the breaker's trial
            # tokens, and the token only returns through THAT replica's
            # own outcome paths (record_success / record_failure /
            # on_expire).  A hedge twin winning elsewhere would leave
            # the origin's copy to be silently discarded — token leaked,
            # breaker pinned half-open forever.  Semantically the trial
            # must run on the origin anyway: hedging around the probe
            # defeats it.
            self.hedger.track(req, placed.name)
        return req

    def _place(self, x, active, timeout_ms, dtype, qos=None):
        # ``active`` is the submit-time snapshot (one lock round-trip
        # per request, shared across a sharded request's chunks).  A
        # replica drained after the snapshot rejects at its batcher and
        # is skipped like any other refusal.  An OPEN circuit blocks
        # placement outright; a half-open one
        # admits at most its trial quota, so a freshly restarted replica
        # proves itself on a trickle, not the full stream.
        order = self._order(active, len(x))
        saw_error: RejectedError | None = None
        for r in order:
            if r.breaker is not None and not r.breaker.try_acquire():
                continue
            try:
                req = r.batcher.submit(
                    x, timeout_ms=timeout_ms, dtype=dtype, qos=qos,
                    count_reject=False,
                )
            except RejectedError as e:
                # Admission refused before any work dispatched — return
                # the trial token; this is backpressure, not a failure.
                if r.breaker is not None:
                    r.breaker.release()
                saw_error = e
                continue
            self._note(r, len(x))
            return req, r
        # Exactly one client-visible 503 however many replicas were
        # tried (the per-attempt skips are not client outcomes).
        if self.metrics is not None:
            self.metrics.record_rejected()
        raise saw_error if saw_error is not None else RejectedError(
            "no routable replicas (every circuit open or replica draining)"
        )

    def _submit_sharded(
        self, x, active, cap, timeout_ms, dtype, qos=None
    ) -> ShardedRequest:
        """Chunks are placed sequentially; a rejection mid-placement
        (every replica full) propagates to the client as one 503, while
        chunks already admitted drain normally on their replicas — their
        finished device work is discarded, exactly as for a client that
        disconnects mid-request.  The client-visible contract stays
        atomic: one request, one answer or one error, never a partial
        result."""
        if len(x) > cap * len(active):
            if self.metrics is not None:
                self.metrics.record_rejected()
            raise RejectedError(
                f"request of {len(x)} samples exceeds pool capacity "
                f"({len(active)} replicas x {cap} max batch)"
            )
        # Near-equal chunks preserve arrival order (chunk i = rows
        # [offsets[i], offsets[i+1])) and spread the work instead of
        # filling replica 1 and sending replica 2 the remainder.
        n_chunks = -(-len(x) // cap)
        bounds = np.linspace(0, len(x), n_chunks + 1).astype(int)
        parts = [
            self._place(x[lo:hi], active, timeout_ms, dtype, qos)[0]
            for lo, hi in zip(bounds[:-1], bounds[1:])
        ]
        return ShardedRequest(parts)

    # -- elasticity ------------------------------------------------------------

    def drain(self, name: str) -> float:
        """Gracefully remove one replica under live traffic.

        Ordering is the correctness: the replica is marked unroutable
        BEFORE its batcher drains, so no new placement can land on it
        mid-drain; ``stop(drain=True)`` then finishes its queue and
        in-flight window (the batcher's drain — nothing lost, nothing
        duplicated).  Returns (and records) the drain wall seconds.
        """
        replica = self.replica(name)
        with self._lock:
            if not replica.active:
                raise RuntimeError(
                    f"replica {name!r} is {replica.state}, not active"
                )
            if sum(1 for r in self.replicas if r.active) == 1:
                raise RuntimeError(
                    f"refusing to drain {name!r}: it is the last active "
                    "replica (stop the server instead)"
                )
            replica.state = "draining"
        t0 = time.perf_counter()
        replica.batcher.stop(drain=True)
        duration = time.perf_counter() - t0
        replica.state = "drained"
        if self._drain_hist is not None:
            self._drain_hist.observe(duration)
        if self._sink:
            self._sink.emit(
                "replica_drain", replica=name, duration_s=duration
            )
        return duration

    def attach(self, name: str, batcher: MicroBatcher) -> Replica:
        """Re-add a drained (or supervisor-restarting) replica with a
        fresh (started) batcher, or register a brand-new one.  Routable
        as soon as this returns — subject to the replica's circuit
        (a restart leaves it half-open until a trial passes)."""
        with self._lock:
            for r in self.replicas:
                if r.name == name:
                    r.reactivate(batcher)
                    return r
            replica = Replica(name, batcher)
            replica.breaker = CircuitBreaker(
                name, registry=self._registry, sink=self._sink,
                **self._breaker_kwargs,
            )
            self.replicas.append(replica)
            return replica

    # -- fault tolerance (the supervisor's surface, serving/pool.py) ---------

    def quarantine(self, name: str, reason: str = "sick") -> int:
        """Forcibly remove a SICK replica from rotation: trip its
        circuit open, mark it quarantined, and abort its batcher —
        queued and in-flight requests complete with
        :class:`~.batcher.ReplicaDeadError` so their handlers retry on
        survivors.  Unlike :meth:`drain`, this never waits on the
        replica (a dead one would park the drain forever) and it IS
        allowed to take the last active replica down — a sick lone
        replica serving poison is worse than an honest 503.  Returns the
        flushed-request count."""
        replica = self.replica(name)
        with self._lock:
            if replica.state != "active":
                raise RuntimeError(
                    f"replica {name!r} is {replica.state}, not active"
                )
            replica.state = "quarantined"
        if replica.breaker is not None:
            replica.breaker.force_open(reason)
        flushed = replica.batcher.abort()
        if self._sink:
            self._sink.emit(
                "replica_quarantine", replica=name, reason=reason,
                flushed=flushed,
            )
        return flushed

    def record_retry(self) -> None:
        """One handler-side resubmission of a never-executed request
        (drain race or replica death) — the failure-aware retry tally
        (``serving_request_retries_total``)."""
        if self.metrics is not None:
            self.metrics.record_retry()
        if self._sink:
            self._sink.emit("request_retry")

    # -- lifecycle -------------------------------------------------------------

    def stop(self, drain: bool = True) -> None:
        """Stop every active replica's batcher (draining by default).
        Replicas already drained are left alone; quarantined/ejected
        ones were aborted by the supervisor, and their ``stop`` is a
        no-op (the aborted completion worker may be unjoinable).  Drains
        run concurrently — each replica's queue/window finishes on its
        own device, so shutdown wall time is the slowest drain, not the
        sum of all of them."""
        if self.hedger is not None:
            # Hedger first: a hedge placed onto a draining batcher would
            # either race its flush or delay the drain for nothing.
            self.hedger.stop()
        stopping = [
            r for r in self.replicas if r.state not in ("drained", "ejected")
        ]
        for r in stopping:
            if r.state != "quarantined":
                r.state = "draining"
        if not stopping:
            return

        def _stop(r: Replica) -> None:
            r.batcher.stop(drain=drain)
            if r.state != "quarantined":
                r.state = "drained"

        with ThreadPoolExecutor(max_workers=len(stopping)) as pool:
            list(pool.map(_stop, stopping))
