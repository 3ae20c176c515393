"""Rollout control: zero-downtime weight swap, canary split, rollback
(the JAX package's ``serving/rollout.py``).

The registry (serving/registry.py) is the durable catalog; this module is
the live-traffic half — the state machine that moves a server from
version A to version B without dropping, duplicating, or TEARING a
request (a response computed partly on old weights, partly on new).

Three verbs, admin-triggered (server.py ``/admin/*``):

**swap(version)** — republish the primary served weights: the engine
replaces each variant's weight reference (engine.publish_weights; a
dispatch reads the reference once, so a batch in flight completes on the
old weights and the next dispatch reads the new ones), the response
cache's generation is bumped with the new digest, and the registry's
default alias moves in one atomic manifest write.

**start_canary(version, pct)** — serve VERSION to a deterministic
``pct``% slice of unpinned traffic beside the primary.  The engine
installs ``{dtype}@{version}`` twins (engine.install_version; the batcher
coalesces by variant key, so no batch mixes versions).  Assignment is
:func:`canary_assignment` — a seeded blake2b over the request payload, the
JAX package's, so both packages split the same requests the same way.
Explicit ``version`` pins bypass the split.

**rollback(reason)** — remove the canary variants and return all traffic
to the primary.  Fired by the operator, or AUTOMATICALLY by the canary's
:class:`~.circuit.CircuitBreaker` when its failures trip it, or by the
parity-drift probe (engine.version_divergence) past
``divergence_budget``.

Observability: ``serving_model_requests_total{model=,version=}`` and
``serving_model_latency_seconds{...}`` per served route, plus
``model_swap`` / ``canary_step`` / ``canary_divergence`` / ``rollback``
events.
"""

from __future__ import annotations

import hashlib

from ..analysis.lockwatch import make_lock
from .circuit import CIRCUIT_OPEN, CircuitBreaker
from .engine import VERSION_SEP
from .registry import RegistryError

# Default canary-assignment seed (the JAX package's).  Fixed, not random,
# so every server — of either package — and any offline audit agree on
# the assignment of every payload without coordination.
CANARY_SEED = 20260806


class RolloutError(RegistryError):
    """A rollout transition that cannot proceed (no canary active,
    version not loaded, cross-model canary).  Subclasses RegistryError
    -> ValueError, so the server's 400 mapping already handles it."""


def canary_assignment(
    payload: bytes, pct: float, seed: int = CANARY_SEED
) -> bool:
    """Deterministically assign a request payload to the canary slice.

    Seeded blake2b over the raw payload bytes -> uniform fraction of
    2**64; True when it lands below ``pct``/100.  Properties the rollout
    depends on: the same payload routes the SAME way on every server
    (no shared state), raising ``pct`` only GROWS the slice (a request
    in the 5% slice is in the 25% one, so a canary ramp never
    flip-flops users), and the split is exactly reproducible offline."""
    h = hashlib.blake2b(digest_size=8)
    h.update(int(seed).to_bytes(8, "little", signed=True))
    h.update(payload)
    fraction = int.from_bytes(h.digest(), "little") / 2.0**64
    return fraction < float(pct) / 100.0


class Route:
    """One resolved routing decision for one request."""

    __slots__ = ("model", "version", "canary", "pinned")

    def __init__(self, model, version, canary=False, pinned=False):
        self.model = model
        self.version = version
        self.canary = canary    # served by a version-pinned variant
        self.pinned = pinned    # client named the version explicitly

    def dtype_key(self, dtype: str) -> str:
        """The engine variant key this route dispatches on: the base
        dtype for the primary, ``{dtype}@{version}`` for the canary —
        which is also what keeps canary rows out of primary batches
        (the batcher coalesces by key) and canary responses out of
        primary cache entries (the key joins the cache key)."""
        return (
            f"{dtype}{VERSION_SEP}{self.version}" if self.canary else dtype
        )


class RolloutController:
    """The per-process rollout state machine over (registry, engine).

    Thread-safety: route()/observe() run on every request thread while
    swap/canary/rollback arrive on admin threads; all shared state
    lives under one lock, and the engine/cache calls inside transitions
    are themselves atomic at the reference-swap level, so request
    threads never observe a half-applied transition.
    """

    def __init__(
        self,
        registry,
        engine,
        *,
        cache=None,
        metrics=None,
        sink=None,
        seed: int = CANARY_SEED,
        failure_threshold: int = 3,
        divergence_budget: float | None = None,
    ):
        self.registry = registry
        self.engine = engine
        self.cache = cache
        self.metrics = metrics
        self.sink = sink
        self.seed = int(seed)
        self.failure_threshold = int(failure_threshold)
        # Max |dlogit| the canary may drift from the primary on the
        # fixed parity slice before auto-rollback.  None (default) =
        # probe-only: a genuinely retrained version LEGITIMATELY moves
        # logits, so an always-on budget would roll back every real
        # update.  Set a budget when the rollout is a should-be-
        # equivalent artifact (requantization, recompression, a format
        # migration) — there, drift past the budget means the artifact
        # is not the model that was validated.
        self.divergence_budget = (
            None if divergence_budget is None else float(divergence_budget)
        )
        self._lock = make_lock("rollout.state")
        entry = registry.resolve()
        self._model = entry.model
        self._version = entry.version
        self._canary_version: str | None = None
        self._canary_pct = 0.0
        self._breaker: CircuitBreaker | None = None
        if metrics is not None:
            metrics.ensure_model(entry.model, entry.version)

    # -- request path ---------------------------------------------------------

    def route(
        self,
        model: str | None = None,
        version: str | None = None,
        payload: bytes | None = None,
    ) -> Route:
        """Resolve one request's (model, version) fields to a served
        route.  Absent fields resolve through the registry's default
        aliases — byte-identical to pre-registry behavior.  An explicit
        ``version`` pins (bypassing the canary split); an absent one
        joins the deterministic split when a canary is live."""
        entry = self.registry.resolve(model, version)
        with self._lock:
            if entry.model != self._model:
                raise RolloutError(
                    f"model {entry.model!r} is registered but not "
                    f"loaded; this process serves {self._model!r}"
                )
            if version is not None:
                if entry.version == self._version:
                    return Route(entry.model, entry.version, pinned=True)
                if entry.version == self._canary_version:
                    return Route(
                        entry.model, entry.version, canary=True, pinned=True
                    )
                raise RolloutError(
                    f"version {entry.version!r} of {entry.model!r} is "
                    "registered but not serving; swap to it or start a "
                    "canary first"
                )
            if (
                self._canary_version is not None
                and self._canary_pct > 0.0
                and payload is not None
                and canary_assignment(payload, self._canary_pct, self.seed)
            ):
                return Route(
                    entry.model, self._canary_version, canary=True
                )
            return Route(entry.model, self._version)

    def observe(self, route: Route, ok: bool, latency_s: float) -> None:
        """One request's outcome on its route: lands the per-route
        metric families, feeds the canary breaker, and fires
        auto-rollback the moment the breaker opens."""
        if self.metrics is not None:
            self.metrics.record_model_request(
                route.model, route.version, latency_s
            )
        if not route.canary:
            return
        with self._lock:
            breaker = (
                self._breaker
                if route.version == self._canary_version
                else None
            )
        if breaker is None:
            return
        if ok:
            breaker.record_success()
        else:
            breaker.record_failure()
            if breaker.state == CIRCUIT_OPEN:
                try:
                    self.rollback(reason="canary_error_budget")
                except RolloutError:
                    pass  # a racing observer already rolled back

    # -- transitions ----------------------------------------------------------

    def swap(self, version: str, model: str | None = None) -> dict:
        """Zero-downtime weight swap: load VERSION through the registry
        (digest-verified), republish the engine's primary weights in
        place, bump the response-cache generation, move the durable
        default alias, and promote/retire any same-version canary —
        under live traffic, zero dropped or torn requests."""
        with self._lock:
            active_model = self._model
        entry = self.registry.resolve(model or active_model, version)
        if entry.model != active_model:
            raise RolloutError(
                f"cannot swap to model {entry.model!r}; this process "
                f"serves {active_model!r}"
            )
        variables = self.registry.load(entry)
        digest = self.engine.publish_weights(variables, version=version)
        if self.cache is not None:
            self.cache.invalidate(digest)
        self.registry.set_default(entry.model, version)
        with self._lock:
            src = self._version
            self._version = version
            promoted = self._canary_version == version
            if promoted:
                self._canary_version = None
                self._canary_pct = 0.0
                self._breaker = None
        if promoted:
            # The pinned twins now duplicate the primary; retire them.
            self.engine.remove_version(version)
        if self.metrics is not None:
            self.metrics.ensure_model(entry.model, version)
        if self.sink:
            self.sink.emit(
                "model_swap", model=entry.model, src=src, dst=version,
                digest=digest, promoted=promoted,
            )
        return self.describe()

    def start_canary(
        self, version: str, pct: float, model: str | None = None
    ) -> dict:
        """Install VERSION as a canary serving ``pct``% of unpinned
        traffic.  With a ``divergence_budget`` configured, the
        parity-drift probe runs immediately after the install — a
        corrupt-but-loadable artifact rolls back before it has served a
        single split request."""
        pct = float(pct)
        if not 0.0 < pct <= 100.0:
            raise RolloutError(
                f"canary pct must be in (0, 100], got {pct}"
            )
        with self._lock:
            active_model = self._model
            active_version = self._version
            live_canary = self._canary_version
        if live_canary is not None and live_canary != version:
            raise RolloutError(
                f"canary {live_canary!r} is already live; "
                "promote or roll it back first"
            )
        entry = self.registry.resolve(model or active_model, version)
        if entry.model != active_model:
            raise RolloutError(
                f"cannot canary model {entry.model!r}; this process "
                f"serves {active_model!r}"
            )
        if entry.version == active_version:
            raise RolloutError(
                f"version {version!r} is already the primary"
            )
        fresh = version != live_canary
        if fresh:
            variables = self.registry.load(entry)
            self.engine.install_version(version, variables)
        with self._lock:
            self._canary_version = version
            self._canary_pct = pct
            if fresh:
                self._breaker = CircuitBreaker(
                    f"canary:{entry.model}@{version}",
                    failure_threshold=self.failure_threshold,
                    registry=(
                        self.metrics.registry
                        if self.metrics is not None
                        else None
                    ),
                    sink=self.sink,
                )
        if self.metrics is not None:
            self.metrics.ensure_model(entry.model, version)
        if self.sink:
            self.sink.emit(
                "canary_step", model=entry.model, version=version, pct=pct,
            )
        if fresh:
            self.check_divergence()
        return self.describe()

    def check_divergence(self) -> dict | None:
        """Parity-drift probe: primary f32 vs the canary's pinned f32
        on the fixed parity slice.  With a
        ``divergence_budget`` set, drift past it (or an argmax flip)
        auto-rolls back; without one the probe is informational.
        Returns the probe record, or None when no canary is live."""
        with self._lock:
            version = self._canary_version
        if version is None:
            return None
        probe = self.engine.version_divergence(version)
        drifted = self.divergence_budget is not None and (
            probe["max_abs_logit_diff"] > self.divergence_budget
            or not probe["argmax_identical"]
        )
        if self.sink:
            self.sink.emit(
                "canary_divergence", drifted=drifted,
                budget=self.divergence_budget, **probe,
            )
        if drifted:
            try:
                self.rollback(reason="parity_drift")
            except RolloutError:
                pass  # a racing observer already rolled back
        return dict(probe, drifted=drifted)

    def rollback(self, reason: str = "operator") -> dict:
        """Retire the live canary and return ALL traffic to the
        primary.  Unpinned requests re-route on the very next
        route() call; in-flight canary batches complete normally (the
        batcher holds its own variant reference)."""
        with self._lock:
            version = self._canary_version
            if version is None:
                raise RolloutError("no canary is live")
            model = self._model
            self._canary_version = None
            self._canary_pct = 0.0
            self._breaker = None
        self.engine.remove_version(version)
        if self.cache is not None:
            # Canary entries are keyed under the pinned variant key and
            # so can never serve primary traffic — the bump just sheds
            # them (and evidences the transition on cache_invalidate).
            self.cache.invalidate(self.engine.weights_digest)
        if self.sink:
            self.sink.emit(
                "rollback", model=model, version=version, reason=reason,
            )
        return self.describe()

    def set_canary_pct(self, pct: float) -> dict:
        """Ramp the live canary's traffic share (0 pauses the split
        without uninstalling the variants)."""
        pct = float(pct)
        if not 0.0 <= pct <= 100.0:
            raise RolloutError(
                f"canary pct must be in [0, 100], got {pct}"
            )
        with self._lock:
            if self._canary_version is None:
                raise RolloutError("no canary is live")
            self._canary_pct = pct
            model, version = self._model, self._canary_version
        if self.sink:
            self.sink.emit(
                "canary_step", model=model, version=version, pct=pct,
            )
        return self.describe()

    # -- status ---------------------------------------------------------------

    def describe(self) -> dict:
        """The admin/healthz rollout block."""
        with self._lock:
            return {
                "model": self._model,
                "version": self._version,
                "weights_digest": self.engine.weights_digest,
                "canary": (
                    {
                        "version": self._canary_version,
                        "pct": self._canary_pct,
                        "circuit": (
                            self._breaker.state if self._breaker else None
                        ),
                    }
                    if self._canary_version is not None
                    else None
                ),
            }
