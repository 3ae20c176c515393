"""Pipelined micro-batching: bounded admission, overlap, backpressure.

One 64-row dispatch costs barely more device time than a 1-row dispatch
at these shapes, so coalescing concurrent requests multiplies throughput —
at the price of waiting.  The batcher takes the first queued request, then
keeps pulling until the batch would exceed the top bucket or the **linger**
passes (in packed mode the **fill wait**, when set, replaces the linger:
waiting to fill the one rows-capacity buffer is worth more there).

Two threads:

- the **dispatch worker** coalesces same-dtype requests, pads them into a
  preallocated staging buffer and calls ``engine.launch``, which returns
  without waiting for the device;
- the **completion worker** waits on each launched batch's own CUDA event
  (:class:`~.engine.DeviceResult`), slices the rows to their requests and
  recycles the staging buffer.

A semaphore bounds the launched-not-yet-read window (``max_inflight``):
batch N+1's host work overlaps batch N's device work, and time the
dispatch worker spends blocked on a full window is recorded as stall.

Admission is a bounded queue: a full queue rejects at once
(:class:`RejectedError`, HTTP 503) instead of queueing without limit, and a
request whose deadline passes while queued completes with
:class:`RequestTimeout` (504) without being dispatched.  ``stop()`` closes
admission and, by default, drains the queue and the in-flight window so
nothing admitted is lost.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np

from ..models.net import INPUT_SHAPE
from .buckets import StagingPool, segment_ids
from .metrics import ServingMetrics


class RejectedError(RuntimeError):
    """Admission refused (queue full, server draining, unservable request)
    — HTTP 503."""


class RequestTimeout(RuntimeError):
    """Deadline expired before a result was produced — HTTP 504."""


class PendingRequest:
    """One admitted request: rows, dtype, deadline and a result slot.
    The first outcome set wins; later ones are ignored."""

    __slots__ = ("x", "dtype", "deadline", "t_submit", "_event", "_lock",
                 "_value", "_error")

    def __init__(self, x: np.ndarray, deadline: float, dtype: str):
        self.x = x
        self.dtype = dtype
        self.deadline = deadline
        self.t_submit = time.perf_counter()
        self._event = threading.Event()
        self._lock = threading.Lock()
        self._value: np.ndarray | None = None
        self._error: BaseException | None = None

    @property
    def n(self) -> int:
        return len(self.x)

    def expired(self) -> bool:
        return time.perf_counter() > self.deadline

    def done(self) -> bool:
        return self._event.is_set()

    def set_result(self, value: np.ndarray) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._value = value
            self._event.set()
            return True

    def set_error(self, error: BaseException) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._error = error
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


class _InFlight:
    """One launched batch on its way to the completion worker."""

    __slots__ = ("batch", "result", "staged", "bucket")

    def __init__(self, batch, result, staged, bucket):
        self.batch = batch
        self.result = result
        self.staged = staged
        self.bucket = bucket


class MicroBatcher:
    """Coalesce admitted requests into a pipelined engine dispatch chain.

    Exactly one dispatch worker calls ``engine.launch`` and exactly one
    completion worker reads results back; HTTP handler threads only
    ``submit()`` and wait.
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
    ):
        if max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got {max_inflight}")
        self.engine = engine
        self.metrics = metrics if metrics is not None else engine.metrics
        self.max_batch = engine.buckets[-1]
        self.packed = bool(engine.packed)
        self.linger_s = (
            fill_wait_ms / 1e3
            if self.packed and fill_wait_ms is not None
            else linger_ms / 1e3
        )
        self.timeout_s = timeout_ms / 1e3
        self.max_inflight = max_inflight
        self._queue: queue.Queue[PendingRequest] = queue.Queue(maxsize=queue_depth)
        self._window = threading.Semaphore(max_inflight)
        self._completions: queue.Queue[_InFlight | None] = queue.Queue()
        # One spare slot beyond the window: batch N+1 stages while the
        # window is still full.
        self._staging = StagingPool(
            engine.buckets,
            INPUT_SHAPE,
            slots=max_inflight + 1,
            pin=engine.device.type == "cuda",
        )
        self._inflight_lock = threading.Lock()
        self._inflight = 0
        self._closed = threading.Event()
        self._stop_lock = threading.Lock()
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
        back and completed.  Safe to call more than once."""
        self._closed.set()
        with self._stop_lock:
            if not drain:
                self._flush_rejected()
            if self._worker is not None:
                self._worker.join()
                self._worker = None
            # Every launched batch is enqueued by now; the sentinel lands
            # after them, so the join proves the window drained.
            if self._completer is not None:
                self._completions.put(None)
                self._completer.join()
                self._completer = None
            # A submit racing stop() can land after the worker exited.
            self._flush_rejected()

    def _flush_rejected(self) -> None:
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            won = req.set_error(RejectedError("server shutting down"))
            if won and self.metrics is not None:
                self.metrics.record_rejected()

    def depth(self) -> int:
        return self._queue.qsize()

    def inflight(self) -> int:
        with self._inflight_lock:
            return self._inflight

    # -- admission (any thread) ---------------------------------------------------

    def _reject(self, message: str) -> RejectedError:
        if self.metrics is not None:
            self.metrics.record_rejected()
        return RejectedError(message)

    def submit(
        self, x: np.ndarray, timeout_ms: float | None = None, dtype: str | None = None
    ) -> PendingRequest:
        """Admit one request of ``[n, 28, 28, 1]`` rows or reject now
        (draining, too big for one batch, queue full, or a dtype the engine
        does not serve or has not verified)."""
        x = np.asarray(x, np.float32)
        if self._closed.is_set():
            raise self._reject("server draining; not accepting requests")
        dtype = dtype or self.engine.default_dtype
        if dtype not in self.engine.dtypes:
            raise self._reject(
                f"dtype {dtype!r} is not served (have {list(self.engine.dtypes)})"
            )
        if not self.engine.variant_verified(dtype):
            raise self._reject(
                f"dtype {dtype!r} has not passed its parity gate; refusing to serve it"
            )
        if not 1 <= len(x) <= self.max_batch:
            raise self._reject(f"request of {len(x)} samples outside [1, {self.max_batch}]")
        timeout_s = self.timeout_s if timeout_ms is None else timeout_ms / 1e3
        req = PendingRequest(x, time.perf_counter() + timeout_s, dtype)
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            raise self._reject(
                f"admission queue full ({self._queue.maxsize} deep)"
            ) from None
        if self.metrics is not None:
            self.metrics.record_admitted()
        return req

    # -- dispatch worker ------------------------------------------------------------

    def _expire(self, req: PendingRequest) -> None:
        won = req.set_error(RequestTimeout("expired in queue before dispatch"))
        if won and self.metrics is not None:
            self.metrics.record_timeout()

    def _run(self) -> None:
        carry: PendingRequest | None = None
        while True:
            if carry is not None:
                first, carry = carry, None
            else:
                try:
                    first = self._queue.get(timeout=0.05)
                except queue.Empty:
                    if self._closed.is_set():
                        return
                    continue
            if first.expired():
                self._expire(first)
                continue
            batch, total = [first], first.n
            # A draining batcher skips the linger: nothing new is coming.
            linger = 0.0 if self._closed.is_set() else self.linger_s
            close_at = time.perf_counter() + linger
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
                if nxt.expired():
                    self._expire(nxt)
                    continue
                if nxt.dtype != first.dtype or total + nxt.n > self.max_batch:
                    carry = nxt  # another variant, or does not fit: leads the next batch
                    break
                batch.append(nxt)
                total += nxt.n
            self._dispatch(batch, total)

    def _dispatch(self, batch: list[PendingRequest], total: int) -> None:
        """Stage, launch without waiting, hand off to the completion worker."""
        staged, bucket = self._staging.stage([r.x for r in batch])
        seg = segment_ids([r.n for r in batch], bucket) if self.packed else None
        if not self._window.acquire(blocking=False):
            t0 = time.perf_counter()
            self._window.acquire()
            if self.metrics is not None:
                self.metrics.record_stall(time.perf_counter() - t0)
        dtype = batch[0].dtype
        try:
            result = self.engine.launch(staged, total, dtype=dtype, seg_ids=seg)
        except Exception as e:  # complete every waiter, keep serving
            self._staging.release(staged, bucket)
            self._window.release()
            failed = sum(1 for req in batch if req.set_error(e))
            if self.metrics is not None and failed:
                self.metrics.record_failed(failed)
            return
        with self._inflight_lock:
            self._inflight += 1
            if self.metrics is not None:
                self.metrics.set_inflight(self._inflight)
        self._completions.put(_InFlight(batch, result, staged, bucket))

    # -- completion worker ------------------------------------------------------------

    def _complete_loop(self) -> None:
        """The only place the pipeline waits on the device."""
        while True:
            item = self._completions.get()
            if item is None:
                return
            try:
                host = item.result.wait()
            except Exception as e:
                failed = sum(1 for req in item.batch if req.set_error(e))
                if self.metrics is not None and failed:
                    self.metrics.record_failed(failed)
            else:
                done = time.perf_counter()
                offset = 0
                for req in item.batch:
                    part = host[offset : offset + req.n].copy()
                    offset += req.n
                    # Counted before the waiter wakes, so a client that reads
                    # /metrics right after its reply sees its own request.
                    # Nothing else settles a request once it is dispatched.
                    if self.metrics is not None:
                        self.metrics.record_completed(done - req.t_submit, dtype=req.dtype)
                    req.set_result(part)
            finally:
                self._staging.release(item.staged, item.bucket)
                with self._inflight_lock:
                    self._inflight -= 1
                    if self.metrics is not None:
                        self.metrics.set_inflight(self._inflight)
                self._window.release()

