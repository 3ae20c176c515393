"""Circuit breaker: closed -> open -> half-open -> closed (the JAX
package's ``serving/circuit.py``).

A target whose requests FAIL must fall out of placement within a handful
of attempts.  In the port's single-engine server the one target is the
canary (``serving/rollout.py``): its breaker opening rolls the canary
back.

- **closed** — normal placement.  ``failure_threshold`` consecutive
  failures trip it open (any success resets the streak).
- **open** — never placed.  Only an explicit :meth:`half_open`
  re-admits.
- **half-open** — at most ``trial_limit`` concurrently outstanding
  *trial* requests are placed; ``trial_successes`` successes close the
  circuit, any failure re-opens it.

Transitions land on the ``serving_circuit_state{replica=}`` gauge and as
``circuit_transition`` events.  Thread-safe.  Standard library only.
"""

from __future__ import annotations

from ..analysis.lockwatch import make_lock

# Circuit states, and the numeric encoding the serving_circuit_state
# gauge exports: 0 = closed (healthy), 1 =
# half-open (trial traffic only), 2 = open (no placement).
CIRCUIT_CLOSED = "closed"
CIRCUIT_HALF_OPEN = "half-open"
CIRCUIT_OPEN = "open"
_CIRCUIT_GAUGE = {CIRCUIT_CLOSED: 0.0, CIRCUIT_HALF_OPEN: 1.0, CIRCUIT_OPEN: 2.0}


class CircuitBreaker:
    """One target's breaker; see the module docstring for the states.

    ``replica`` is the label on the gauge/event surfaces, the JAX
    package's ``serving_circuit_state{replica=}`` family.
    """

    def __init__(
        self,
        replica: str,
        failure_threshold: int = 3,
        trial_limit: int = 1,
        trial_successes: int = 1,
        registry=None,
        sink=None,
    ):
        if failure_threshold < 1:
            raise ValueError(
                f"failure_threshold must be >= 1, got {failure_threshold}"
            )
        self.replica = replica
        self.failure_threshold = failure_threshold
        self.trial_limit = max(1, trial_limit)
        self.trial_successes = max(1, trial_successes)
        self.state = CIRCUIT_CLOSED
        self.last_reason: str | None = None
        self._consecutive_failures = 0
        self._trial_inflight = 0
        self._trial_passed = 0
        self._lock = make_lock("circuit.breaker")
        self._sink = sink
        self._gauge = (
            registry.gauge(
                "serving_circuit_state",
                help="per-replica circuit breaker: 0 closed, 1 half-open "
                "(trial traffic only), 2 open (no placement)",
                replica=replica,
            )
            if registry is not None
            else None
        )
        if self._gauge is not None:
            self._gauge.set(0.0)

    def _transition(self, to: str, reason: str | None) -> None:
        """State change + gauge + event, under the lock."""
        src = self.state
        if src == to:
            return
        self.state = to
        self.last_reason = reason
        self._trial_inflight = 0
        self._trial_passed = 0
        if to == CIRCUIT_CLOSED:
            self._consecutive_failures = 0
        if self._gauge is not None:
            self._gauge.set(_CIRCUIT_GAUGE[to])
        if self._sink:
            self._sink.emit(
                "circuit_transition", replica=self.replica,
                src=src, dst=to, **({"reason": reason} if reason else {}),
            )

    # -- placement side -------------------------------------------------------

    def allows(self) -> bool:
        """Pure check (no token consumed): could this target be placed
        on right now?"""
        with self._lock:
            return self.state == CIRCUIT_CLOSED or (
                self.state == CIRCUIT_HALF_OPEN
                and self._trial_inflight < self.trial_limit
            )

    def try_acquire(self) -> bool:
        """Claim the right to place one request.  Free when closed;
        consumes a trial token when half-open; refused when open."""
        with self._lock:
            if self.state == CIRCUIT_CLOSED:
                return True
            if (self.state == CIRCUIT_HALF_OPEN
                    and self._trial_inflight < self.trial_limit):
                self._trial_inflight += 1
                return True
            return False

    def release(self) -> None:
        """Return an unused trial token (the submit itself was rejected
        before any work dispatched — not an outcome either way)."""
        with self._lock:
            if self._trial_inflight > 0:
                self._trial_inflight -= 1

    # -- outcome side ---------------------------------------------------------

    def record_success(self) -> None:
        with self._lock:
            self._consecutive_failures = 0
            if self.state == CIRCUIT_HALF_OPEN:
                if self._trial_inflight > 0:
                    self._trial_inflight -= 1
                self._trial_passed += 1
                if self._trial_passed >= self.trial_successes:
                    self._transition(CIRCUIT_CLOSED, "trial_passed")

    def record_failure(self) -> None:
        with self._lock:
            if self.state == CIRCUIT_HALF_OPEN:
                self._transition(CIRCUIT_OPEN, "trial_failed")
                return
            self._consecutive_failures += 1
            if (self.state == CIRCUIT_CLOSED
                    and self._consecutive_failures >= self.failure_threshold):
                self._transition(CIRCUIT_OPEN, "failure_threshold")

    # -- supervisor side ------------------------------------------------------

    def force_open(self, reason: str = "quarantined") -> None:
        with self._lock:
            self._transition(CIRCUIT_OPEN, reason)

    def half_open(self) -> None:
        """Admit trial traffic after a restart (supervisor only — an
        open circuit never self-heals by clock, because the thing that
        tripped it has not been fixed by time passing)."""
        with self._lock:
            self._transition(CIRCUIT_HALF_OPEN, "restart_trial")
