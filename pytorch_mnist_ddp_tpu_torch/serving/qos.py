"""QoS classes and the weighted per-class admission queue (the JAX
package's ``serving/qos.py``).

At load, queueing — not compute — owns p99, and one FIFO admission queue
makes every latency-sensitive request wait behind whatever bulk traffic
arrived first.  Two scheduler primitives fix it:

- **QoS classes.**  Every request carries a class name (``interactive`` /
  ``batch``), ordered by priority: earlier in the tuple = more
  latency-sensitive.  The class travels ``/predict`` ->
  ``MicroBatcher.submit(qos=)`` and lands on the per-class metric
  families (``serving_qos_requests_total{qos=}``,
  ``serving_qos_latency_seconds{qos=}``).
- :class:`QoSQueue` — the bounded admission queue, one deque a class.
  Dequeue is **weighted round-robin** over non-empty classes (default
  4:1 interactive:batch): a queued interactive request overtakes an
  arbitrarily deep batch backlog within one service cycle, and batch is
  never starved.  Under pressure the batcher **sheds the lowest class
  first** (:meth:`QoSQueue.shed_for`): the most recently admitted request
  of a strictly lower class yields its slot.  **Eager expiry**
  (:meth:`QoSQueue.sweep_expired`) removes requests whose deadline passed
  while queued the moment a worker looks.

The queue speaks the ``queue.Queue`` subset the batcher uses
(``put_nowait``/``get``/``get_nowait``/``qsize``/``maxsize``, raising
``queue.Full``/``queue.Empty``).  For the same arrivals it gives the same
order as the JAX package's queue.  Standard library only.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import deque

# Priority order, most latency-sensitive first.  The names are the label
# values on every per-class metric family, so keep them short and stable.
QOS_CLASSES: tuple[str, ...] = ("interactive", "batch")

# Requests that name no class get the most latency-sensitive one: a
# pre-QoS client keeps exactly its old behavior (every request in one
# class = plain FIFO), and bulk jobs OPT IN to being shed first.
DEFAULT_QOS = "interactive"

# Weighted-round-robin service shares when several classes have queued
# work: of every 5 dequeues under contention, 4 are interactive.  Batch
# is never starved outright — weight 0 would be starvation, not QoS.
DEFAULT_WEIGHTS: dict[str, int] = {"interactive": 4, "batch": 1}


class QoSQueue:
    """Bounded per-class admission queue with weighted dequeue and
    lowest-class-first shedding.

    ``maxsize`` bounds the TOTAL queued count across classes (the same
    backpressure bound the old single queue enforced).  Thread-safe; one
    condition covers every mutation, and blocking :meth:`get` honors a
    timeout exactly like ``queue.Queue``.
    """

    def __init__(
        self,
        maxsize: int,
        classes: tuple[str, ...] = QOS_CLASSES,
        weights: dict[str, int] | None = None,
    ):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        if not classes:
            raise ValueError("need at least one QoS class")
        weights = dict(DEFAULT_WEIGHTS if weights is None else weights)
        for name in classes:
            if weights.get(name, 0) < 1:
                # Weight 0 would starve the class forever — shedding is
                # the sanctioned way to sacrifice it under pressure.
                weights[name] = 1
        self.maxsize = maxsize
        self.classes = tuple(classes)
        self.weights = {name: int(weights[name]) for name in self.classes}
        self._priority = {name: i for i, name in enumerate(self.classes)}
        self._queues: dict[str, deque] = {name: deque() for name in self.classes}
        # Weighted-round-robin state: how many of the current class's
        # service share have been used this cycle.
        self._wrr_class = 0
        self._wrr_served = 0
        self._cond = threading.Condition()

    # -- sizes -----------------------------------------------------------------

    def qsize(self) -> int:
        with self._cond:
            return sum(len(q) for q in self._queues.values())

    def sizes(self) -> dict[str, int]:
        """Per-class queued counts (the /metrics qos block)."""
        with self._cond:
            return {name: len(q) for name, q in self._queues.items()}

    # -- admission -------------------------------------------------------------

    def put_nowait(self, req) -> None:
        """Admit ``req`` (which must carry ``.qos``) or raise
        ``queue.Full``.  Never sheds — eviction is an explicit policy
        decision the batcher makes (:meth:`shed_for`)."""
        qos = getattr(req, "qos", None) or self.classes[0]
        if qos not in self._priority:
            raise ValueError(
                f"unknown QoS class {qos!r}; have {list(self.classes)}"
            )
        with self._cond:
            if sum(len(q) for q in self._queues.values()) >= self.maxsize:
                raise queue.Full
            self._queues[qos].append(req)
            self._cond.notify()

    def shed_for(self, qos: str):
        """Evict (and return) one queued request of a class strictly
        lower-priority than ``qos``, or None when nothing is sheddable.

        Policy: lowest class first; within the class, the NEWEST request
        (least sunk queue time — the oldest is closest to dispatching,
        so evicting it wastes the most already-paid waiting).  The
        caller completes the victim with the 503 and counts the shed
        (``serving_shed_total{qos=}``).
        """
        incoming = self._priority.get(qos, 0)
        with self._cond:
            for name in reversed(self.classes):
                if self._priority[name] <= incoming:
                    return None
                q = self._queues[name]
                if q:
                    return q.pop()
        return None

    # -- dequeue (dispatch worker) ---------------------------------------------

    def _pick_locked(self):
        """Weighted round-robin choice over non-empty classes, under the
        condition lock.  Returns a request or None when empty."""
        n = len(self.classes)
        if all(not q for q in self._queues.values()):
            return None
        for _ in range(2 * n):  # at most one full cycle + wrap
            name = self.classes[self._wrr_class]
            q = self._queues[name]
            if q and self._wrr_served < self.weights[name]:
                self._wrr_served += 1
                return q.popleft()
            # Class empty or share spent: move on, reset its tally.
            self._wrr_class = (self._wrr_class + 1) % n
            self._wrr_served = 0
        return None  # unreachable while any queue is non-empty

    def get(self, timeout: float | None = None):
        with self._cond:
            req = self._pick_locked()
            if req is not None:
                return req
            deadline = (
                None if timeout is None else time.monotonic() + timeout
            )
            while True:
                if deadline is None:
                    self._cond.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._cond.wait(remaining):
                        # Timed out (or woke at the boundary): one last
                        # look before giving up, matching queue.Queue.
                        req = self._pick_locked()
                        if req is None:
                            raise queue.Empty
                        return req
                req = self._pick_locked()
                if req is not None:
                    return req

    def get_nowait(self):
        with self._cond:
            req = self._pick_locked()
            if req is None:
                raise queue.Empty
            return req

    # -- eager expiry ----------------------------------------------------------

    def sweep_expired(self, now: float | None = None) -> list:
        """Remove and return every queued request whose deadline has
        passed; silently drop requests already completed elsewhere
        (nothing to expire, the slot is simply freed).  The caller
        expires the returned requests through its ``on_expire`` path, so
        the queue slot frees immediately."""
        now = now if now is not None else time.perf_counter()
        expired: list = []
        with self._cond:
            for name, q in self._queues.items():
                keep: deque = deque()
                for req in q:
                    done = getattr(req, "done", None)
                    if done is not None and done():
                        continue  # satisfied elsewhere; free the slot
                    if req.expired(now):
                        expired.append(req)
                    else:
                        keep.append(req)
                self._queues[name] = keep
        return expired
