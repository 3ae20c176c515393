"""lockwatch: runtime lock-order tracing — the dynamic half of JL019
(the JAX package's ``analysis/lockwatch.py``; same sites, counters and
environment flag).

The static concurrency pass (analysis/concurrency.py) proves lock-order
acyclicity per class from the AST; it cannot see orders that only arise
ACROSS classes at runtime (batcher holds its inflight lock while a
completion hook takes a replica breaker's lock, the hedger takes the
router's membership lock while a drain takes a replica's...).  This
module witnesses those orders on real executions: every lock built
through :func:`make_lock` records, per thread, which *sites* were held
when it was acquired.  The union of those edges is the observed
lock-order graph; a cycle in it means two threads can interleave into a
deadlock even if no run has deadlocked yet.

Design constraints:

- **Zero overhead when off.**  ``make_lock(site)`` returns a plain
  ``threading.Lock``/``RLock``/``Condition`` unless ``JAXLINT_LOCKWATCH=1``
  — the serving hot path pays nothing for the instrumentation existing.
- **Sites, not instances.**  Every ``PendingRequest`` shares the site
  ``"batcher.pending"``; the graph is over code locations, which is what
  a lock-ORDER discipline is about.  Two same-site instances nested
  produce a self-edge, which the cycle check ignores (instance-level
  ABBA within one site is out of scope).
- **Metrics ride the obs registry** (`lock_acquisitions_total{site=}`,
  ``lock_hold_seconds{site=}``), attached lazily: locks exist before any
  registry does, so counts buffer internally and flush when
  :func:`attach` is called (ServingMetrics does this on construction).
  That is how the chaos smoke's ``--prom-dump`` grep sees them.
- **Teardown assertion.**  ``assert_acyclic()`` raises
  :class:`LockOrderError` naming a cycle; ``tools/serve_loadgen.py``
  calls it at the end of a run, so every chaos round under
  ``JAXLINT_LOCKWATCH=1`` doubles as a lock-order witness run.

stdlib-only; importable without torch (the fleet front uses these locks).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

ENV_FLAG = "JAXLINT_LOCKWATCH"

# Pre-attach hold-time buffer bound: enough to cover a test's worth of
# acquisitions without letting an unattached long run grow without bound.
_HOLD_BUFFER = 4096


def enabled() -> bool:
    """Is runtime lock tracing on?  (``JAXLINT_LOCKWATCH=1``; checked at
    ``make_lock`` time so tests can flip the env var per-case.)"""
    return os.environ.get(ENV_FLAG, "").strip().lower() not in (
        "", "0", "false", "no", "off",
    )


class LockOrderError(AssertionError):
    """The observed acquisition-order graph has a cycle: some pair of
    threads can interleave these acquisitions into a deadlock."""


def find_cycles(graph: dict[str, set[str]]) -> list[list[str]]:
    """Cycles in a small directed graph, one per back edge, as node
    paths ending where they start (``[a, b, a]``).  Deterministic
    (sorted visit order); empty list iff the graph is a DAG.  Shared by
    the static JL019 pass and the runtime order-graph assertion."""
    color: dict[str, int] = {}  # 1 = on current path, 2 = done
    path: list[str] = []
    out: list[list[str]] = []

    def dfs(node: str) -> None:
        color[node] = 1
        path.append(node)
        for nxt in sorted(graph.get(node, ())):
            if color.get(nxt) == 1:
                out.append(path[path.index(nxt):] + [nxt])
            elif color.get(nxt) is None:
                dfs(nxt)
        path.pop()
        color[node] = 2

    for start in sorted(graph):
        if color.get(start) is None:
            dfs(start)
    return out


class LockWatch:
    """Global acquisition recorder: per-thread held-site stacks, the
    site-level order graph, and the metric surfaces.

    Its own mutual exclusion is a PLAIN lock, never traced (tracing the
    tracer would recurse), and nothing is called while holding it except
    dict updates — it can never participate in an application deadlock.
    """

    def __init__(self):
        self._mu = threading.Lock()
        self._tls = threading.local()
        # (held_site, acquired_site) -> times observed
        self._edges: dict[tuple[str, str], int] = {}
        self._counts: dict[str, int] = {}
        self._holds: deque[tuple[str, float]] = deque(maxlen=_HOLD_BUFFER)
        self._registry = None
        self._counters: dict[str, object] = {}
        self._hists: dict[str, object] = {}

    # -- per-thread stack ------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def note_acquire(self, site: str) -> None:
        stack = self._stack()
        counter = None
        with self._mu:
            self._counts[site] = self._counts.get(site, 0) + 1
            for held, _t0 in stack:
                if held != site:
                    edge = (held, site)
                    self._edges[edge] = self._edges.get(edge, 0) + 1
            if self._registry is not None:
                counter = self._ensure_counter(site)
        stack.append((site, time.perf_counter()))
        if counter is not None:
            counter.inc()

    def note_release(self, site: str) -> None:
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == site:
                _, t0 = stack.pop(i)
                dt = time.perf_counter() - t0
                hist = None
                with self._mu:
                    if self._registry is not None:
                        hist = self._ensure_hist(site)
                    else:
                        self._holds.append((site, dt))
                if hist is not None:
                    hist.observe(dt)
                return
        # Release of a lock this thread never noted (e.g. acquired before
        # tracing was reset): ignore rather than corrupt the stack.

    # -- metrics ---------------------------------------------------------------

    def _ensure_counter(self, site: str):
        counter = self._counters.get(site)
        if counter is None:
            counter = self._counters[site] = self._registry.counter(
                "lock_acquisitions_total",
                help="traced lock acquisitions by site (JAXLINT_LOCKWATCH=1)",
                site=site,
            )
        return counter

    def _ensure_hist(self, site: str):
        hist = self._hists.get(site)
        if hist is None:
            hist = self._hists[site] = self._registry.histogram(
                "lock_hold_seconds",
                help="traced lock hold time by site (JAXLINT_LOCKWATCH=1)",
                site=site,
            )
        return hist

    def attach(self, registry) -> None:
        """Adopt ``registry`` as the metric surface and flush everything
        recorded so far into it (cumulative counts, buffered hold
        times).  Re-attaching to a new registry re-exports the
        cumulative state — each serving process's registry sees the full
        picture from its own start."""
        with self._mu:
            self._registry = registry
            self._counters = {}
            self._hists = {}
            counts = dict(self._counts)
            holds = list(self._holds)
            self._holds.clear()
            counters = {site: self._ensure_counter(site) for site in counts}
            hists = {site: self._ensure_hist(site) for site, _ in holds}
        for site, n in counts.items():
            counters[site].inc(n)
        for site, dt in holds:
            hists[site].observe(dt)

    # -- the order graph -------------------------------------------------------

    def edges(self) -> dict[tuple[str, str], int]:
        with self._mu:
            return dict(self._edges)

    def counts(self) -> dict[str, int]:
        with self._mu:
            return dict(self._counts)

    def cycles(self) -> list[list[str]]:
        """Cycles in the observed site-order graph (self-edges excluded:
        two same-site instances nested is not an ORDER violation)."""
        graph: dict[str, set[str]] = {}
        for (a, b) in self.edges():
            if a != b:
                graph.setdefault(a, set()).add(b)
        return find_cycles(graph)

    def assert_acyclic(self) -> None:
        cycles = self.cycles()
        if cycles:
            edges = self.edges()
            parts = []
            for cycle in cycles:
                hops = " -> ".join(cycle)
                counts = ", ".join(
                    f"{a}->{b} x{edges.get((a, b), 0)}"
                    for a, b in zip(cycle, cycle[1:])
                )
                parts.append(f"{hops} ({counts})")
            raise LockOrderError(
                "observed lock acquisition order has a cycle — two threads "
                "can interleave these into a deadlock: " + "; ".join(parts)
            )

    def reset(self) -> None:
        """Forget everything (tests).  Only the calling thread's held
        stack can be cleared; other threads' stacks die with them."""
        with self._mu:
            self._edges.clear()
            self._counts.clear()
            self._holds.clear()
            self._registry = None
            self._counters = {}
            self._hists = {}
        self._tls.stack = []


class TracedLock:
    """Drop-in for ``threading.Lock``/``RLock`` that reports to a
    :class:`LockWatch`.  Supports the full acquire/release + context
    manager surface the serving code uses."""

    def __init__(self, site: str, inner, watch: LockWatch):
        self.site = site
        self._inner = inner
        self._watch = watch

    def acquire(self, blocking: bool = True, timeout: float = -1):
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            self._watch.note_acquire(self.site)
        return ok

    def release(self) -> None:
        self._inner.release()
        self._watch.note_release(self.site)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False


class TracedCondition:
    """Traced ``threading.Condition``: acquisition order is tracked like
    a lock; ``wait`` releases and re-acquires in the held-stack model
    exactly as it does in the real lock (so holding another lock across
    a wait still shows its true order edges)."""

    def __init__(self, site: str, watch: LockWatch):
        self.site = site
        self._inner = threading.Condition()
        self._watch = watch

    def acquire(self, *args):
        ok = self._inner.acquire(*args)
        if ok:
            self._watch.note_acquire(self.site)
        return ok

    def release(self) -> None:
        self._inner.release()
        self._watch.note_release(self.site)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.release()
        return False

    def wait(self, timeout: float | None = None):
        self._watch.note_release(self.site)
        try:
            return self._inner.wait(timeout)
        finally:
            self._watch.note_acquire(self.site)

    def wait_for(self, predicate, timeout: float | None = None):
        self._watch.note_release(self.site)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            self._watch.note_acquire(self.site)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()


_WATCH = LockWatch()


def watch() -> LockWatch:
    """The process-global recorder (one graph per process by design —
    cross-subsystem edges are the whole point)."""
    return _WATCH


def make_lock(site: str, kind: str = "lock"):
    """Build a lock for ``site`` ("batcher.inflight", "router.membership",
    ...): the plain threading primitive when tracing is off, the traced
    wrapper when ``JAXLINT_LOCKWATCH=1``.  ``kind`` is ``"lock"``,
    ``"rlock"``, or ``"condition"``."""
    if kind not in ("lock", "rlock", "condition"):
        raise ValueError(f"unknown lock kind {kind!r}")
    if not enabled():
        if kind == "rlock":
            return threading.RLock()
        if kind == "condition":
            return threading.Condition()
        return threading.Lock()
    if kind == "condition":
        return TracedCondition(site, _WATCH)
    inner = threading.RLock() if kind == "rlock" else threading.Lock()
    return TracedLock(site, inner, _WATCH)


def attach(registry) -> None:
    """Point the metric surfaces at ``registry`` (no-op when tracing is
    off — no families appear unless the run is actually traced)."""
    if enabled():
        _WATCH.attach(registry)


def assert_acyclic() -> None:
    """Raise :class:`LockOrderError` if any observed order cycle exists
    (no-op when tracing is off)."""
    if enabled():
        _WATCH.assert_acyclic()
