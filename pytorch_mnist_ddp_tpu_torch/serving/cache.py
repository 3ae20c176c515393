"""Content-addressed response cache with single-flight dedup (the JAX
package's ``serving/cache.py``).

Inference is deterministic: the same (weights, served dtype, input rows)
gives the same logits.  So repeated identical work — retry storms,
hedged clients, dashboards re-probing a canary row — is waste, removed at
the serving admission point (``serving/server.py``): keyed on
``(model digest, dtype, payload hash)``, the hash over the MODEL-READY
float32 rows, so a JSON request and a binary-wire request carrying the
same pixels hit the same entry.

**Single-flight**: a miss CLAIMS the key; concurrent identical requests
JOIN the claimant's in-flight computation instead of dispatching their
own — one dispatch, N waiters.  A failed flight wakes every joiner with
the same error and is DROPPED, never cached.  Joiners wait only their
own deadline budget (:class:`FlightTimeout` is the joiner's 504).

**Invalidation**: the key embeds the engine's weights digest and a
generation bumped by :meth:`ResponseCache.invalidate`, so a weights swap
makes every old key unreachable.  The tier is off by default
(``--response-cache N``); with it off, no code path changes.

Values are opaque (the server caches logits arrays).  Standard library
only.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict

# claim() outcomes (also the serving_cache_total{outcome=} label values).
HIT = "hit"
MISS = "miss"
COALESCED = "coalesced"
CACHE_OUTCOMES = (HIT, MISS, COALESCED)


class FlightTimeout(TimeoutError):
    """A joiner's own deadline expired before the claimed flight
    resolved — the joiner's 504, not a verdict on the flight."""


class Flight:
    """One in-flight computation a claimant owns and joiners await."""

    __slots__ = ("_event", "_value", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._error: BaseException | None = None

    def _resolve(self, value, error) -> None:
        # First writer wins; the cache's claim/complete discipline means
        # there is only ever one writer, but a double-complete from a
        # buggy caller must not clobber what joiners already read.
        if self._event.is_set():
            return
        self._value = value
        self._error = error
        self._event.set()

    def result(self, timeout_s: float | None = None):
        """Block until the claimant resolves the flight; re-raises the
        claimant's error verbatim so the joiner's status mapping treats
        it exactly like its own failure (one outcome per waiter)."""
        if not self._event.wait(timeout_s):
            raise FlightTimeout(
                "deadline expired waiting on a coalesced in-flight request"
            )
        if self._error is not None:
            raise self._error
        return self._value


def payload_digest(*parts) -> str:
    """Stable content address for request payload bytes (blake2b-128:
    fast, stdlib, and 128 bits is far past birthday range for any
    realistic cache population).  ``parts`` are any buffer-protocol
    objects (bytes, a contiguous array's memoryview) — hashed in place,
    never copied."""
    h = hashlib.blake2b(digest_size=16)
    for part in parts:
        h.update(part)
    return h.hexdigest()


class ResponseCache:
    """Bounded-LRU deterministic-response cache with single-flight.

    ``capacity`` bounds COMPLETED entries (an in-flight claim is not
    evictable — joiners hold it; the handler-thread bound already caps
    how many can exist).  ``metrics`` (ServingMetrics) receives the
    ``serving_cache_total{outcome=}`` counts; ``sink`` gets a
    ``cache_hit`` event per served-from-cache response.  ``scope``
    labels events (the JAX package's fleet front uses "front").
    """

    def __init__(
        self,
        capacity: int,
        model_digest: str = "",
        metrics=None,
        sink=None,
        scope: str = "server",
    ):
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.model_digest = model_digest
        self.metrics = metrics
        self.sink = sink
        self.scope = scope
        self._generation = 0
        self._lock = threading.Lock()
        self._done: OrderedDict[tuple, object] = OrderedDict()
        self._pending: dict[tuple, Flight] = {}
        if metrics is not None:
            # Scrapeable-from-first-exposition (the CI grep contract):
            # all three outcome series exist before the first request.
            metrics.ensure_cache()

    # -- keys ------------------------------------------------------------------

    def key(self, *payload_parts, dtype: str = "f32") -> tuple:
        """The content address: (generation, model digest, dtype,
        payload hash).  Generation + digest make every entry from a
        previous engine/weights unreachable after a swap.  Multiple
        buffer-protocol ``payload_parts`` hash in sequence without
        being concatenated — no payload-sized copy at either tier."""
        digest = payload_digest(*payload_parts)
        # Generation and model digest mutate together under the lock in
        # invalidate(); reading them lock-free could mint a chimera key
        # (old generation, new digest) mid-swap that wrongly misses —
        # or, worse, collides with — a post-swap fill.
        with self._lock:
            return (self._generation, self.model_digest, dtype, digest)

    # -- the single-flight protocol -------------------------------------------

    def claim(self, key: tuple):
        """Look up ``key``; returns one of

        - ``(HIT, value)`` — a completed entry (LRU-refreshed);
        - ``(COALESCED, flight)`` — another request holds the claim;
          call ``flight.result(my_remaining_budget)``;
        - ``(MISS, flight)`` — the caller now OWNS the flight and must
          call :meth:`complete` or :meth:`fail` on every exit path (a
          leaked claim would coalesce future identical requests onto a
          flight that never resolves).
        """
        with self._lock:
            if key in self._done:
                self._done.move_to_end(key)
                value = self._done[key]
                outcome = HIT
            elif key in self._pending:
                value = self._pending[key]
                outcome = COALESCED
            else:
                value = self._pending[key] = Flight()
                outcome = MISS
        if self.metrics is not None:
            self.metrics.record_cache(outcome)
        if outcome == HIT and self.sink:
            self.sink.emit("cache_hit", scope=self.scope)
        return outcome, value

    def complete(self, key: tuple, flight: Flight, value, store: bool = True) -> None:
        """Resolve a claimed flight with ``value`` and wake every
        joiner; ``store=False`` delivers without filling (the front
        caches only 200s — a 503 is an outcome for current waiters, not
        a fact about the payload)."""
        with self._lock:
            if self._pending.get(key) is flight:
                del self._pending[key]
            if store and key[0] == self._generation:
                # A fill racing invalidate() must lose: its value was
                # computed against the pre-swap model.
                self._done[key] = value
                while len(self._done) > self.capacity:
                    self._done.popitem(last=False)
        flight._resolve(value, None)

    def fail(self, key: tuple, flight: Flight, error: BaseException) -> None:
        """Resolve a claimed flight with ``error``: every joiner raises
        it as its own, and NOTHING is cached — the
        never-a-stale-fill rule."""
        with self._lock:
            if self._pending.get(key) is flight:
                del self._pending[key]
        flight._resolve(None, error)

    # -- lifecycle -------------------------------------------------------------

    def invalidate(self, model_digest: str | None = None) -> None:
        """Engine/weights swap: drop every completed entry and bump the
        generation so in-flight fills from the old world cannot land.
        ``model_digest`` updates the key component when the new weights'
        digest is known (a swap to identical weights still invalidates —
        correctness over hit rate)."""
        with self._lock:
            self._generation += 1
            generation = self._generation
            if model_digest is not None:
                self.model_digest = model_digest
            self._done.clear()
        if self.sink:
            self.sink.emit(
                "cache_invalidate", scope=self.scope,
                generation=generation,
            )

    def stats(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "entries": len(self._done),
                "pending": len(self._pending),
                "generation": self._generation,
            }
