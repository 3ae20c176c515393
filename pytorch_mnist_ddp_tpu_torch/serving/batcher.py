"""Pipelined micro-batching: QoS admission, overlap, backpressure, the
tail machinery (the JAX package's ``serving/batcher.py``, single engine).

One 64-row dispatch costs barely more device time than a 1-row dispatch
at these shapes, so coalescing concurrent requests multiplies throughput —
at the price of waiting.  The batcher takes the first queued request, then
keeps pulling until the batch would exceed the top bucket or the batch's
**close time** passes.

Two threads:

- the **dispatch worker** coalesces same-variant requests, pads them into
  a preallocated staging buffer and calls ``engine.launch``, which returns
  without waiting for the device;
- the **completion worker** waits on each launched batch's own CUDA event
  (:class:`~.engine.DeviceResult`), slices the rows to their requests and
  recycles the staging buffer.

A semaphore bounds the launched-not-yet-read window (``max_inflight``):
batch N+1's host work overlaps batch N's device work, and time the
dispatch worker spends blocked on a full window is recorded as stall.

The close time:

- the **adaptive linger** (:class:`AdaptiveLinger`) halves the linger
  while the admission queue is deep (the next batch is already there;
  waiting is pure latency) and relaxes it back toward the configured
  ceiling when the queue empties;
- the **deadline-aware close** (:meth:`MicroBatcher._close_at`) clamps it
  so the OLDEST member's remaining deadline still covers the estimated
  service time (an EWMA of launch -> read-back fed by the completion
  worker).

Admission is a bounded **QoS-weighted** queue (serving/qos.py): requests
carry a class (``interactive``/``batch``), dequeue is weighted
round-robin, and a full queue first sweeps expired entries, then sheds
the newest request of a strictly lower class before rejecting
(:class:`RejectedError`, HTTP 503).  A request whose deadline passes while
queued completes with :class:`RequestTimeout` (504) without being
dispatched, eagerly, on the workers' cadence.

**Packed ragged batching** (``engine.packed``): batches are segment lists
— ``(request, start, rows)`` — concatenated into one rows-capacity buffer
with a segment-id vector.  A request that would overflow the forming
batch is SPLIT: its head fills this batch exactly to capacity and the
remainder leads the next one.  The completion worker reassembles split
requests by segment, bit for bit the unsplit answer (rows are independent
through the eval forward).  The fill wait (``fill_wait_ms``) replaces the
linger as the adaptive controller's ceiling in packed mode.

The dispatch and completion paths carry the fault points ``launch`` and
``complete`` (serving/faults.py), and, given an event sink, the spans
``serving_pad``, ``serving_dispatch``, ``serving_complete`` and the events
``serving_request``, ``serving_batch``, ``qos_shed``.  ``stop()`` closes
admission and, by default, drains the queue and the in-flight window so
nothing admitted is lost.

**Pool mode** (``replica=`` names the batcher, serving/pool.py): the fault
points and the in-flight gauge carry the replica's name, the hooks
``on_complete(latency_s, rows)`` / ``on_failure(batches)`` /
``on_expire(n)`` feed the router's latency averages and circuit breaker,
and a launch or read-back failure completes its requests with
:class:`ReplicaDeadError`, which the server resubmits on a surviving
replica.  :meth:`MicroBatcher.abort` tears down a dead replica without
waiting on it; :meth:`MicroBatcher.submit_hedge` enqueues an admitted
request a second time (hedged dispatch, serving/router.py), and the
request's live-copy count keeps every eviction path silent while another
copy still owns the outcome.  Without ``replica`` the single-engine
behaviour is unchanged.
"""

from __future__ import annotations

import functools
import queue
import threading
import time

import numpy as np

from ..analysis.lockwatch import make_lock
from ..models.net import INPUT_SHAPE
from ..obs.spans import span
from .buckets import StagingPool, segment_ids
from .faults import fault_point
from .metrics import ServingMetrics
from .qos import DEFAULT_QOS, QOS_CLASSES, QoSQueue


class RejectedError(RuntimeError):
    """Admission refused (queue full, shed, server draining, unservable
    request) — HTTP 503."""


class ReplicaDeadError(RejectedError):
    """A pool replica failed or was torn down with this request aboard; the
    work produced no result, so resubmitting it on a surviving replica
    cannot duplicate a response.  A :class:`RejectedError`, so the server's
    retry and the router's skip treat a dead replica like a draining one."""


class RequestTimeout(RuntimeError):
    """Deadline expired before a result was produced — HTTP 504."""


class PendingRequest:
    """One admitted request: rows, dtype (the engine variant key), QoS
    class, deadline and a result slot.  The first outcome set wins; later
    ones are ignored.

    ``completed_by`` names the replica whose completion won (hedged
    dispatch tells won from lost by it).  The live-copy count is 1, plus
    one per hedge twin (:meth:`add_copy`); an eviction path (shed, flush,
    abort, a launch or read-back failure) consumes a copy
    (:meth:`drop_copy`) and sets an error only on the last one."""

    __slots__ = ("x", "dtype", "qos", "deadline", "t_submit", "completed_by", "_copies",
                 "_event", "_lock", "_value", "_error")

    def __init__(self, x: np.ndarray, deadline: float, dtype: str = "f32",
                 qos: str = DEFAULT_QOS):
        self.x = x
        self.dtype = dtype
        self.qos = qos
        self.deadline = deadline
        self.t_submit = time.perf_counter()
        self.completed_by: str | None = None
        self._copies = 1
        self._event = threading.Event()
        self._lock = make_lock("batcher.pending")
        self._value: np.ndarray | None = None
        self._error: BaseException | None = None

    @property
    def n(self) -> int:
        return len(self.x)

    def expired(self, now: float | None = None) -> bool:
        return (now if now is not None else time.perf_counter()) > self.deadline

    def done(self) -> bool:
        return self._event.is_set()

    def add_copy(self) -> None:
        """A hedge twin is being enqueued: one more live copy."""
        with self._lock:
            self._copies += 1

    def drop_copy(self) -> int:
        """One copy was evicted without an outcome; returns the live copies
        left (non-zero: another copy owns the outcome, stay silent)."""
        with self._lock:
            self._copies = max(0, self._copies - 1)
            return self._copies

    def set_result(self, value: np.ndarray, by: str | None = None) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._value = value
            self.completed_by = by
            self._event.set()
            return True

    def set_error(self, error: BaseException, by: str | None = None) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._error = error
            self.completed_by = by
            self._event.set()
            return True

    def result(self, grace_s: float = 1.0) -> np.ndarray:
        """Block until completed; raises the worker's error if it set one.
        Waits until the deadline plus ``grace_s`` (which covers a batch
        already launched when the deadline passed)."""
        timeout = max(0.0, self.deadline - time.perf_counter()) + grace_s
        if not self._event.wait(timeout):
            raise RequestTimeout("request deadline expired")
        with self._lock:
            if self._error is not None:
                raise self._error
            return self._value


class AdaptiveLinger:
    """Queue-depth-driven linger: shrink under load, relax when idle.

    Halves the linger whenever the admission queue is at least
    ``deep_depth`` requests deep (snapping to 0 below ``floor_s``) and
    relaxes it additively by ``relax_frac`` of the ceiling on an empty
    queue; in-between depths hold.  Both moves keep the value inside
    ``[0, ceiling_s]``.  The current value is the
    ``serving_linger_seconds`` gauge (``{replica=}`` in pool mode).  The
    JAX package's controller, value for value.
    """

    def __init__(
        self,
        ceiling_s: float,
        enabled: bool = True,
        registry=None,
        replica: str | None = None,
        deep_depth: int = 4,
        shrink: float = 0.5,
        relax_frac: float = 0.25,
        floor_s: float = 1e-4,
    ):
        if not 0.0 < shrink < 1.0:
            raise ValueError(f"shrink factor must be in (0, 1), got {shrink}")
        if not 0.0 < relax_frac <= 1.0:
            raise ValueError(f"relax_frac must be in (0, 1], got {relax_frac}")
        self.ceiling_s = max(0.0, ceiling_s)
        self.enabled = enabled
        self.deep_depth = max(1, deep_depth)
        self.shrink = shrink
        self.relax_frac = relax_frac
        self.floor_s = floor_s
        self.current_s = self.ceiling_s
        self._gauge = (
            registry.gauge(
                "serving_linger_seconds",
                help="current adaptive linger (shrinks under queue depth, "
                "relaxes toward the configured ceiling when idle)",
                **({"replica": replica} if replica else {}),
            )
            if registry is not None
            else None
        )
        if self._gauge is not None:
            self._gauge.set(self.current_s)

    def update(self, queue_depth: int) -> float:
        """Observe the admission depth; return the linger to use now."""
        if not self.enabled:
            return self.ceiling_s
        if queue_depth >= self.deep_depth:
            self.current_s *= self.shrink
            if self.current_s < self.floor_s:
                self.current_s = 0.0
        elif queue_depth == 0:
            self.current_s = min(
                self.ceiling_s, self.current_s + self.relax_frac * self.ceiling_s
            )
        if self._gauge is not None:
            self._gauge.set(self.current_s)
        return self.current_s


class _InFlight:
    """One launched batch on its way to the completion worker: the member
    requests (``batch``, each once) and the row layout (``segments``:
    ``(request, start, rows)`` in staging order, ``start`` the block's
    offset within its request)."""

    __slots__ = ("batch", "segments", "result", "staged", "bucket", "n", "stall_s",
                 "dtype", "t_launch")

    def __init__(self, batch, segments, result, staged, bucket, n, stall_s, dtype):
        self.batch = batch
        self.segments = segments
        self.result = result
        self.staged = staged
        self.bucket = bucket
        self.n = n
        self.stall_s = stall_s
        self.dtype = dtype
        self.t_launch = time.perf_counter()


def _read_back(result) -> np.ndarray:
    """A launched batch's host log-probs: :class:`~.engine.DeviceResult`
    waits on its event; anything else (a test's fake) converts."""
    wait = getattr(result, "wait", None)
    return wait() if wait is not None else np.asarray(result)


class MicroBatcher:
    """Coalesce admitted requests into a pipelined engine dispatch chain.

    Exactly one dispatch worker calls ``engine.launch`` and exactly one
    completion worker reads results back; HTTP handler threads only
    ``submit()`` and wait.  The engine contract is ``engine.buckets`` plus
    ``engine.launch(staged, n)`` (with ``dtype=`` for other variants and
    ``seg_ids=`` when ``engine.packed``).
    """

    def __init__(
        self,
        engine,
        metrics: ServingMetrics | None = None,
        linger_ms: float = 2.0,
        queue_depth: int = 64,
        timeout_ms: float = 1000.0,
        max_inflight: int = 2,
        fill_wait_ms: float | None = None,
        adaptive_linger: bool = True,
        deadline_aware: bool = True,
        qos_classes: tuple[str, ...] = QOS_CLASSES,
        qos_weights: dict[str, int] | None = None,
        sink=None,
        heartbeat=None,
        replica: str | None = None,
    ):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self.engine = engine
        # Pool mode: the replica's name on the fault points, gauges and
        # events, and the router's hooks (set by the pool after
        # construction): on_complete(latency_s, rows) per completed
        # request, on_failure(n) per failed batch.
        self.replica = replica
        self.on_complete = None
        self.on_failure = None
        self.metrics = metrics if metrics is not None else getattr(engine, "metrics", None)
        self.max_batch = engine.buckets[-1]
        self.packed = bool(getattr(engine, "packed", False))
        self.linger_s = linger_ms / 1e3
        self.fill_wait_s = (
            fill_wait_ms / 1e3 if self.packed and fill_wait_ms is not None else None
        )
        self.timeout_s = timeout_ms / 1e3
        self.max_inflight = max_inflight
        self._default_dtype = getattr(engine, "default_dtype", "f32")
        registry = self.metrics.registry if self.metrics is not None else None
        self._registry = registry
        self._sink = sink
        self._linger = AdaptiveLinger(
            self.fill_wait_s if self.fill_wait_s is not None else self.linger_s,
            enabled=adaptive_linger, registry=registry, replica=replica,
        )
        self.deadline_aware = deadline_aware
        self._service_ewma_s: float | None = None
        self.qos_classes = tuple(qos_classes)
        self._queue = QoSQueue(maxsize=queue_depth, classes=self.qos_classes,
                               weights=qos_weights)
        if self.metrics is not None:
            for name in self.qos_classes:
                self.metrics.ensure_qos(name)
        # Expiry hook: called with 1 per request that expires in the queue.
        self.on_expire = None
        # Liveness hook: called once per dispatch-loop iteration.
        self._heartbeat = heartbeat
        self._window = threading.Semaphore(max_inflight)
        self._completions: queue.Queue[_InFlight | None] = queue.Queue()
        # One spare slot beyond the window: batch N+1 stages while the
        # window is still full.  Pinned on the card unless the engine's
        # device staging is off (--no-device-stage).
        device = getattr(engine, "device", None)
        self._staging = StagingPool(
            engine.buckets,
            INPUT_SHAPE,
            slots=max_inflight + 1,
            pin=(device is not None and device.type == "cuda"
                 and getattr(engine, "device_stage", True)),
        )
        # Packed-split reassembly (completion worker only): id(request)
        # -> [request, out buffer, rows filled].
        self._assembly: dict[int, list] = {}
        self._inflight_lock = make_lock("batcher.inflight")
        self._inflight = 0
        # The supervisor's health signals (serving/pool.py): launched
        # batches not yet read back (the oldest one's age) and the current
        # launch-failure streak.
        self._live: set[_InFlight] = set()
        self.consecutive_launch_failures = 0
        self._aborted = threading.Event()
        self._closed = threading.Event()
        self._stop_lock = make_lock("batcher.stop")
        self._worker: threading.Thread | None = None
        self._completer: threading.Thread | None = None

    # -- lifecycle --------------------------------------------------------------

    def start(self) -> "MicroBatcher":
        with self._stop_lock:
            if self._worker is not None:
                raise RuntimeError("batcher already started")
            self._worker = threading.Thread(
                target=self._run, name="serve-dispatch", daemon=True
            )
            self._completer = threading.Thread(
                target=self._complete_loop, name="serve-complete", daemon=True
            )
            self._completer.start()
            self._worker.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Close admission; by default finish the queue AND the window.

        ``drain=False`` completes every queued request with
        :class:`RejectedError`; batches already launched are always read
        back and completed.  Safe to call more than once; a no-op after
        :meth:`abort` (its completion worker may be stuck on a dead
        replica, and abort already completed every waiter)."""
        if self._aborted.is_set():
            return
        self._closed.set()
        with self._stop_lock:
            if not drain:
                self._flush_rejected()
            if self._worker is not None:
                self._worker.join()  # jaxlint: disable=JL021 -- the join IS the drain: stop() holds _stop_lock exactly so concurrent stops serialize behind worker exit; admission is already closed, so the wait is bounded
                self._worker = None
            # Every launched batch is enqueued by now; the sentinel lands
            # after them, so the join proves the window drained.
            if self._completer is not None:
                self._completions.put(None)
                self._completer.join()  # jaxlint: disable=JL021 -- stop-path serialization, same contract as the dispatch-worker join above; the sentinel just enqueued guarantees exit
                self._completer = None
            # A submit racing stop() can land after the worker exited.
            self._flush_rejected()

    def _flush_rejected(self) -> None:
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if req.drop_copy() > 0:
                continue  # a live hedge twin owns the outcome
            won = req.set_error(RejectedError("server shutting down"))
            # Pool mode: the server resubmits a flushed request on another
            # replica, so the flush is no client outcome yet; the router or
            # the server counts the one that is.
            if won and self.metrics is not None and self.replica is None:
                self.metrics.record_rejected()

    def abort(self) -> int:
        """Tear down a DEAD replica's pipeline without waiting on it (the
        supervisor's quarantine): every queued request and every
        launched-but-unread batch completes with :class:`ReplicaDeadError`,
        the dispatch worker is unstuck, a stuck completion worker is
        abandoned (daemon thread).  Returns the number of requests
        flushed.  First-wins completion discards a late read."""
        self._closed.set()
        with self._inflight_lock:
            self._aborted.set()
            live = list(self._live)
            self._live.clear()
            self._inflight = 0
            if self.metrics is not None:
                self.metrics.set_inflight(0, replica=self.replica)
        for _ in range(self.max_inflight):
            self._window.release()
        flushed = self._flush_dead()
        dead = ReplicaDeadError(f"replica {self.replica or '?'} aborted by the supervisor")
        for item in live:
            for req in item.batch:
                if req.drop_copy() > 0:
                    continue
                req.set_error(dead)
                flushed += 1
        self._completions.put(None)
        return flushed

    def _flush_dead(self) -> int:
        """Complete every queued request with :class:`ReplicaDeadError`
        (abort, and the submit-side re-check of abort's race)."""
        dead = ReplicaDeadError(f"replica {self.replica or '?'} aborted by the supervisor")
        flushed = 0
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return flushed
            if req.drop_copy() > 0:
                continue
            req.set_error(dead)
            flushed += 1

    def depth(self) -> int:
        return self._queue.qsize()

    def qos_depths(self) -> dict[str, int]:
        """Per-class admission-queue depths."""
        return self._queue.sizes()

    def oldest_inflight_age(self, now: float | None = None) -> float:
        """Seconds the oldest launched-but-unread batch has waited (0.0
        with nothing in flight): the supervisor's completion-stall signal."""
        with self._inflight_lock:
            if not self._live:
                return 0.0
            oldest = min(item.t_launch for item in self._live)
        return (now if now is not None else time.perf_counter()) - oldest

    def inflight(self) -> int:
        with self._inflight_lock:
            return self._inflight

    @property
    def current_linger_ms(self) -> float:
        """What the adaptive controller is currently waiting (ms)."""
        return 1e3 * (
            self._linger.current_s if self._linger.enabled else self._linger.ceiling_s
        )

    # -- admission (any thread) ---------------------------------------------------

    def _reject(self, message: str, count: bool = True) -> RejectedError:
        if count and self.metrics is not None:
            self.metrics.record_rejected()
        return RejectedError(message)

    def submit(
        self,
        x: np.ndarray,
        timeout_ms: float | None = None,
        dtype: str | None = None,
        qos: str | None = None,
        count_reject: bool = True,
    ) -> PendingRequest:
        """Admit one request of ``[n, 28, 28, 1]`` rows or reject now:
        draining, an unknown QoS class, a variant the engine does not
        serve or has not verified, too big for one batch, or a full queue
        with nothing expired to sweep and nothing of a lower class to
        shed.  ``count_reject=False`` (the router trying replicas in turn)
        raises without counting the rejection."""
        x = np.asarray(x, np.float32)
        reject = functools.partial(self._reject, count=count_reject)
        if self._closed.is_set():
            raise reject("server draining; not accepting requests")
        qos = qos or DEFAULT_QOS
        if qos not in self.qos_classes:
            raise reject(f"unknown QoS class {qos!r}; have {list(self.qos_classes)}")
        dtype = dtype or self._default_dtype
        if dtype != self._default_dtype:
            served = getattr(self.engine, "dtypes", (self._default_dtype,))
            if dtype not in served:
                raise reject(f"dtype {dtype!r} is not served (have {list(served)})")
            verified = getattr(self.engine, "variant_verified", None)
            if verified is not None and not verified(dtype):
                raise reject(
                    f"dtype {dtype!r} has not passed its parity gate; refusing to serve it"
                )
        if not 1 <= len(x) <= self.max_batch:
            raise reject(f"request of {len(x)} samples outside [1, {self.max_batch}]")
        timeout_s = self.timeout_s if timeout_ms is None else timeout_ms / 1e3
        req = PendingRequest(x, time.perf_counter() + timeout_s, dtype=dtype, qos=qos)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            if not self._admit_under_pressure(req):
                raise reject(
                    f"admission queue full ({self._queue.maxsize} deep)"
                ) from None
        if self.metrics is not None:
            self.metrics.record_admitted()
        # abort() may have flushed the queue between the admission check
        # and the enqueue; sweep this request too.
        if self._aborted.is_set():
            self._flush_dead()
        return req

    def _admit_under_pressure(self, req: PendingRequest) -> bool:
        """Full-queue admission: (1) sweep requests that expired while
        queued; (2) shed the newest queued request of a strictly lower
        class, again while a concurrent arrival takes the freed slot first
        and a lower class has requests left.  Returns True once ``req`` is
        queued.  (The JAX batcher sheds once and rejects if it loses that
        race: an interactive 503 with batch requests still queued.)"""
        self.sweep_expired()
        while True:
            try:
                self._queue.put_nowait(req)
                return True
            except queue.Full:
                pass
            victim = self._queue.shed_for(req.qos)
            if victim is None:
                return False
            self._shed(victim)

    def _shed(self, victim: PendingRequest) -> None:
        """Complete a load-shed victim with the 503 and count it (a hedged
        copy goes silently: its twin owns the outcome)."""
        if victim.drop_copy() > 0:
            return
        won = victim.set_error(RejectedError(
            f"shed under pressure (QoS {victim.qos!r} yielded the "
            "queue slot to a higher class)"
        ))
        if self.metrics is not None and won:
            self.metrics.record_shed(victim.qos)
            if self.replica is None:
                self.metrics.record_rejected()
        if self._sink and won:
            self._sink.emit("qos_shed", qos=victim.qos, n=victim.n,
                            **({"replica": self.replica} if self.replica else {}))
        if self.on_expire is not None and won:
            try:
                self.on_expire(1)  # returns a half-open trial token
            except Exception:
                pass

    def sweep_expired(self) -> int:
        """Expire every queued request whose deadline already passed
        (the workers call it on their cadence, admission under pressure
        too).  Returns the number expired."""
        expired = self._queue.sweep_expired()
        for req in expired:
            self._expire(req)
        return len(expired)

    def submit_hedge(self, req: PendingRequest) -> None:
        """Enqueue an ALREADY-ADMITTED request a second time (hedged
        dispatch): the same :class:`PendingRequest` rides this queue beside
        its twin, and the first completion wins.  No new deadline, no
        admitted count, no shedding; a full queue raises
        :class:`RejectedError` (the hedger's "declined")."""
        if self._closed.is_set():
            raise RejectedError("replica draining; not accepting hedges")
        if req.done() or req.expired():
            raise RejectedError("hedge target already settled")
        req.add_copy()
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            # Never enqueued: give the copy back; if an eviction took the
            # origin's copy meanwhile, this request has none left.
            if req.drop_copy() == 0 and not req.done():
                req.set_error(RejectedError("evicted under pressure while a hedge was declined"))
            raise RejectedError("admission queue full; hedge declined") from None
        if self._aborted.is_set():
            self._flush_dead()

    # -- dispatch worker ------------------------------------------------------------

    def _expire(self, req: PendingRequest) -> None:
        won = req.set_error(RequestTimeout("expired in queue before dispatch"))
        if won and self.metrics is not None:
            self.metrics.record_timeout()
        if self.on_expire is not None:
            try:
                self.on_expire(1)
            except Exception:
                pass  # a hook must not kill the worker

    def _close_at(self, now: float, linger: float, oldest_deadline: float) -> float:
        """When the forming batch must dispatch: the linger, clamped —
        when ``deadline_aware`` — so the oldest member's remaining budget
        still covers the estimated service time."""
        close = now + linger
        if self.deadline_aware:
            margin = self._service_ewma_s or 0.0
            close = min(close, oldest_deadline - margin)
        return close

    def _run(self) -> None:
        # The carried leader of the next batch: (request, start row);
        # start > 0 only for a packed split's remainder.
        carry: tuple[PendingRequest, int] | None = None
        while True:
            if self._heartbeat is not None:
                self._heartbeat()
            if carry is not None:
                (first, first_start), carry = carry, None
            else:
                try:
                    first = self._queue.get(timeout=0.05)
                except queue.Empty:
                    if self._closed.is_set():
                        return
                    # Idle tick: the controller relaxes, expired requests
                    # leave the queue.
                    self._linger.update(0)
                    self.sweep_expired()
                    continue
                first_start = 0
            if first.done():
                continue
            if first.expired():
                self._expire(first)
                continue
            segs = [(first, first_start, first.n - first_start)]
            total = first.n - first_start
            oldest_deadline = first.deadline
            # A draining batcher skips the linger: nothing new is coming.
            linger = 0.0 if self._closed.is_set() else self._linger.update(self._queue.qsize())
            close_at = self._close_at(time.perf_counter(), linger, oldest_deadline)
            while total < self.max_batch:
                remaining = close_at - time.perf_counter()
                try:
                    nxt = (
                        self._queue.get_nowait()
                        if remaining <= 0
                        else self._queue.get(timeout=remaining)
                    )
                except queue.Empty:
                    break
                if nxt.done():
                    continue
                if nxt.expired():
                    self._expire(nxt)
                    continue
                if nxt.dtype != first.dtype:
                    carry = (nxt, 0)  # another variant leads the next batch
                    break
                if total + nxt.n > self.max_batch:
                    if self.packed:
                        # The head fills this buffer exactly; the
                        # remainder leads the next batch.
                        head = self.max_batch - total
                        segs.append((nxt, 0, head))
                        total = self.max_batch
                        carry = (nxt, head)
                    else:
                        carry = (nxt, 0)  # does not fit: leads the next batch
                    break
                segs.append((nxt, 0, nxt.n))
                total += nxt.n
                if nxt.deadline < oldest_deadline:
                    # Weighted dequeue can hand over a member with an
                    # earlier deadline than the leader's.
                    oldest_deadline = nxt.deadline
                    close_at = min(close_at, self._close_at(
                        time.perf_counter(), linger, oldest_deadline))
            self._dispatch(segs)

    def _dispatch(self, segs: list[tuple[PendingRequest, int, int]]) -> None:
        """Stage, launch without waiting, hand off to the completion worker."""
        segs = [s for s in segs if not s[0].done()]
        if not segs:
            return
        batch = [s[0] for s in segs]  # unique: one segment per request
        parts = [r.x[start : start + rows] for r, start, rows in segs]
        total = sum(len(p) for p in parts)
        with span("serving_pad", sink=self._sink, registry=self._registry):
            staged, bucket = self._staging.stage(parts)
        seg = segment_ids([len(p) for p in parts], bucket) if self.packed else None
        if self._window.acquire(blocking=False):
            stall_s = 0.0
        else:
            t0 = time.perf_counter()
            self._window.acquire()
            stall_s = time.perf_counter() - t0
            if self.metrics is not None:
                self.metrics.record_stall(stall_s)
        dtype = batch[0].dtype
        try:
            with span("serving_dispatch", sink=self._sink, registry=self._registry):
                fault_point("launch", self.replica)
                if self.packed:
                    result = self.engine.launch(staged, total, dtype=dtype, seg_ids=seg)
                elif dtype == self._default_dtype:
                    result = self.engine.launch(staged, total)
                else:
                    result = self.engine.launch(staged, total, dtype=dtype)
        except Exception as e:  # complete every waiter, keep serving
            self._staging.release(staged, bucket)
            self._window.release()
            self.consecutive_launch_failures += 1
            self._fail(batch, self._pool_error(e, "launch"))
            return
        self.consecutive_launch_failures = 0
        item = _InFlight(batch, segs, result, staged, bucket, total, stall_s, dtype)
        with self._inflight_lock:
            aborted = self._aborted.is_set()
            if not aborted:
                self._live.add(item)
                self._inflight += 1
                if self.metrics is not None:
                    self.metrics.set_inflight(self._inflight, replica=self.replica)
        if aborted:
            # abort() ran between the launch and the bookkeeping above.
            for req in batch:
                if req.drop_copy() == 0:
                    req.set_error(ReplicaDeadError(
                        f"replica {self.replica or '?'} aborted by the supervisor"))
            return
        self._completions.put(item)

    def _pool_error(self, e: BaseException, where: str) -> BaseException:
        """In pool mode a failed launch or read-back produced no result, so
        it is retriable on a survivor: :class:`ReplicaDeadError`.  A single
        engine has no survivor; the raw error is the client's outcome."""
        if self.replica is None or isinstance(e, RejectedError):
            return e
        err = ReplicaDeadError(
            f"replica {self.replica} {where} failed: {type(e).__name__}: {e}")
        err.__cause__ = e
        return err

    def _fail(self, batch: list[PendingRequest], err: BaseException) -> None:
        """Complete a failed batch's requests (those whose last live copy
        this was) and strike the replica, unless the pipeline was aborted:
        then the requests were already flushed and retried, and a strike
        would hit the restarted replica's circuit."""
        failed = sum(1 for req in batch if req.drop_copy() == 0 and req.set_error(err))
        if self._aborted.is_set():
            return
        if self.metrics is not None and failed:
            self.metrics.record_failed(failed)
        if self.on_failure is not None:
            try:
                self.on_failure(len(batch))
            except Exception:
                pass  # a hook must not kill the worker

    # -- completion worker ------------------------------------------------------------

    def _complete_loop(self) -> None:
        """The only place the pipeline waits on the device."""
        while True:
            item = self._completions.get()
            if item is None:
                return
            tag = {"replica": self.replica} if self.replica else {}
            try:
                with span("serving_complete", sink=self._sink, registry=self._registry):
                    fault_point("complete", self.replica)
                    host = _read_back(item.result)
            except Exception as e:
                self._fail(item.batch, self._pool_error(e, "completion"))
            else:
                done = time.perf_counter()
                aborted = self._aborted.is_set()
                dur = done - item.t_launch
                self._service_ewma_s = (
                    dur if self._service_ewma_s is None
                    else 0.2 * dur + 0.8 * self._service_ewma_s
                )
                offset = 0
                for req, start, rows in item.segments:
                    part = host[offset : offset + rows].copy()
                    offset += rows
                    if rows == req.n:
                        won = req.set_result(part, by=self.replica)
                    else:
                        # A packed split: only the last part completes
                        # the waiter.
                        if req.done():
                            continue
                        entry = self._assembly.get(id(req))
                        if entry is None:
                            entry = [req, np.empty((req.n, *part.shape[1:]), part.dtype), 0]
                            self._assembly[id(req)] = entry
                        entry[1][start : start + rows] = part
                        entry[2] += rows
                        if entry[2] < req.n:
                            continue
                        del self._assembly[id(req)]
                        won = req.set_result(entry[1], by=self.replica)
                    # A read that unsticks after abort() belongs to a dead
                    # pipeline: its requests were retried elsewhere.
                    if not won or aborted:
                        continue
                    latency_s = done - req.t_submit
                    # Counted as the waiter wakes; nothing else settles a
                    # request once it is dispatched.
                    if self.metrics is not None:
                        self.metrics.record_completed(latency_s, dtype=req.dtype,
                                                      qos=req.qos)
                    if self.on_complete is not None:
                        try:
                            self.on_complete(latency_s, req.n)
                        except Exception:
                            pass  # a hook must not kill the worker
                    if self._sink:
                        self._sink.emit(
                            "serving_request", n=req.n, latency_s=latency_s,
                            dtype=req.dtype,
                            **({"qos": req.qos} if req.qos != DEFAULT_QOS else {}),
                            **tag,
                        )
            finally:
                self._staging.release(item.staged, item.bucket)
                with self._inflight_lock:
                    self._live.discard(item)
                    # abort() may have zeroed the count already.
                    self._inflight = max(0, self._inflight - 1)
                    if self.metrics is not None:
                        self.metrics.set_inflight(self._inflight, replica=self.replica)
                self._window.release()
            if self._sink:
                self._sink.emit(
                    "serving_batch", real=item.n, bucket=item.bucket,
                    fill_ratio=item.n / item.bucket, stall_s=item.stall_s,
                    dtype=item.dtype, **tag, **({"packed": True} if self.packed else {}),
                )
            # A split whose other part failed must not pin its buffer.
            if self._assembly:
                for key in [k for k, e in self._assembly.items() if e[0].done()]:
                    del self._assembly[key]
            # Eager expiry while the dispatch worker waits on the window.
            self.sweep_expired()
