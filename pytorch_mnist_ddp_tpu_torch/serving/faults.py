"""Deterministic fault injection for the serving and training stacks (the
JAX package's ``serving/faults.py``, the same grammar).

Named **fault points** sit on the hot paths and stay dormant (one
module-global ``None`` check) until a test or the trainers' ``--chaos``
flag installs a :class:`FaultInjector`.  The trainer sites are ``step``
(once an optimizer-step attempt, ``resilience/runtime.py``),
``data_next`` (once a host batch's assembly, ``data/loader.py``) and
``ckpt_save`` (inside the mid-epoch checkpointer's rotate-to-publish
window, ``resilience/checkpoint.py``).  The serving sites parse and
fire as in the JAX package: the batcher (``serving/batcher.py``) calls
``launch`` once a dispatch and ``complete`` once a read-back, the
replica pool (``serving/pool.py``) ``warmup`` once a replica's warmup,
and the kernel-library store (``compile/aot.py``) ``aot_load`` once it
reads a stored entry, before the gate: a fired clause makes that load a
``fallback`` (a fresh build that rewrites the entry).

Triggers are counted in events (``after=``/``count=``), so a schedule
fires at the same events on every run; the only randomness (``p=``)
draws from ``random.Random(seed)``, so the same spec and seed fire on
the same events in both packages.  ``at=`` (seconds since
:meth:`FaultInjector.start`) is for operator schedules.

Spec grammar (one or more clauses joined by ``;``)::

    clause  := op ':' site [ ':' replica ] [ ':' params ]
    op      := 'fail' | 'hang' | 'kill' | 'nan'
    site    := 'launch' | 'complete' | 'warmup' | 'aot_load'
             | 'step' | 'data_next' | 'ckpt_save'
    replica := a replica name ('r0', ...); '*' or omitted = any replica
               (refused for 'aot_load' and the trainer sites, which fire
               unlabeled)
    params  := key '=' value (',' key '=' value)*

    count=N | count=inf   fire on the next N matching events (default 1)
    after=K               skip the first K matching events (default 0)
    at=T                  arm only once T seconds have passed since start()
    for=S                 hang duration in seconds ('hang' op; default 0.5)
    p=X                   fire each armed event with probability X (seeded)
    rank=R                trainer sites only: fire only in the process
                          whose RANK (the launcher's environment) is R

Examples::

    fail:launch:r1:count=6        # r1's next 6 dispatches raise
    hang:complete:r0:for=2        # r0's next completion read stalls 2s
    fail:aot_load:count=1         # the first AOT load fails
    fail:warmup:r2                # r2's warmup raises once
    fail:launch:r3:at=5,count=inf # r3 fails from five seconds in
    kill:step:after=7             # preempt the trainer before step 8
    kill:ckpt_save:after=1        # die inside the 2nd checkpoint rotation
    nan:step:after=5              # poison step 6's batch (LossGuard test)
    fail:data_next:count=2        # two transient input-pipeline faults
    kill:step:rank=1:after=4      # kill rank 1 of the gang before its
                                  # 5th step

``fail`` raises :class:`FaultError` at the fault point; ``hang`` blocks
the calling thread for ``for=`` seconds (:func:`uninstall` wakes it);
``kill`` is ``os._exit(137)``, the SIGKILL convention: no finally block,
no atexit, what a preemption looks like to the checkpoint files; ``nan``
raises a :class:`FaultError` whose ``op`` is ``"nan"``, which the
trainer's runtime turns into a NaN-poisoned input batch.  Standard
library only.
"""

from __future__ import annotations

import math
import random
import threading
import time
from contextlib import contextmanager

# Trainer sites (resilience/, data/loader.py): one step-attempt event
# per optimizer step, one data_next event per host-batch assembly, one
# ckpt_save event inside each checkpoint rotation.  They always fire
# unlabeled — there is one trainer — so replica-scoped clauses are
# rejected at parse time (same vacuous-green guard as aot_load).
TRAINER_SITES = ("step", "data_next", "ckpt_save")

SITES = ("launch", "complete", "warmup", "aot_load") + TRAINER_SITES
OPS = ("fail", "hang", "kill", "nan")


class FaultError(RuntimeError):
    """An injected failure.  Deliberately a plain RuntimeError subclass:
    the serving stack must recover from it through the SAME paths it
    recovers from real engine failures with — any special-casing of
    this type in non-test code would make the chaos harness a liar.

    ``op``/``site`` carry the firing clause's coordinates.  The ONE
    sanctioned read of them outside tests is the trainer's ``nan``
    translation (resilience/runtime.py): a ``nan`` fault is not a
    failure to recover from but an instruction to poison the step's
    numerics, so the runtime must be able to tell it from ``fail``."""

    def __init__(self, message: str, op: str = "fail", site: str = ""):
        super().__init__(message)
        self.op = op
        self.site = site


class FaultSpec:
    """One parsed clause: where it fires, when, how often, what it does."""

    __slots__ = (
        "op", "site", "replica", "rank", "count", "after", "at_s", "hang_s",
        "p", "fired", "source",
    )

    def __init__(self, op, site, replica, count, after, at_s, hang_s, p,
                 source, rank=None):
        self.op = op
        self.site = site
        self.replica = replica
        self.rank = rank
        self.count = count
        self.after = after
        self.at_s = at_s
        self.hang_s = hang_s
        self.p = p
        self.fired = 0
        self.source = source

    @classmethod
    def parse(cls, clause: str) -> "FaultSpec":
        parts = [p.strip() for p in clause.strip().split(":")]
        if len(parts) < 2:
            raise ValueError(
                f"fault clause {clause!r} needs at least op:site "
                f"(grammar: op:site[:replica][:k=v,...])"
            )
        op, site = parts[0], parts[1]
        if op not in OPS:
            raise ValueError(f"unknown fault op {op!r}; have {OPS}")
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}; have {SITES}")
        replica: str | None = None
        params: dict[str, str] = {}
        for part in parts[2:]:
            if "=" in part:
                for pair in part.split(","):
                    key, _, value = pair.partition("=")
                    key, value = key.strip(), value.strip()
                    if key not in ("count", "after", "at", "for", "p", "rank"):
                        raise ValueError(
                            f"unknown fault param {key!r} in {clause!r}; "
                            "have count/after/at/for/p/rank"
                        )
                    params[key] = value
            elif part and part != "*":
                replica = part
        count = (
            math.inf if params.get("count") == "inf"
            else float(params.get("count", 1))
        )
        if count < 1:
            raise ValueError(f"count must be >= 1 in {clause!r}")
        if op == "nan" and site != "step":
            # Only the trainer's step attempt knows how to poison a
            # batch; a nan clause anywhere else would be armed but
            # uninterpretable — a vacuous green chaos run.
            raise ValueError(
                f"op 'nan' is only meaningful at site 'step' in {clause!r}"
            )
        if site == "aot_load" and replica is not None:
            # The AOT store is SHARED across replicas (one ExecutableStore
            # per pool), so its fault point fires unlabeled; accepting a
            # replica-scoped clause here would arm one that can never
            # trigger — a vacuous green chaos run.
            raise ValueError(
                f"aot_load cannot be replica-scoped in {clause!r}: the "
                "executable store is shared across the pool"
            )
        if site in TRAINER_SITES and replica is not None:
            # Same vacuous-green guard: the trainer sites fire with
            # replica=None, so a labeled clause could never match.
            raise ValueError(
                f"{site} cannot be replica-scoped in {clause!r}: trainer "
                "sites fire unlabeled (there is one trainer per rank; "
                "scope to a gang member with rank=R instead)"
            )
        rank = int(params["rank"]) if "rank" in params else None
        if rank is not None and rank < 0:
            raise ValueError(f"rank must be >= 0 in {clause!r}")
        if rank is not None and site not in TRAINER_SITES:
            # Serving processes are single-rank (replica scoping is their
            # addressing); a rank-scoped serving clause could never
            # match — the vacuous-green guard again.
            raise ValueError(
                f"rank= only scopes trainer sites in {clause!r}: serving "
                "clauses address replicas (r0, r1, ...), not gang ranks"
            )
        return cls(
            op=op,
            site=site,
            replica=replica,
            rank=rank,
            count=count,
            after=int(params.get("after", 0)),
            at_s=float(params["at"]) if "at" in params else None,
            hang_s=float(params.get("for", 0.5)),
            p=float(params.get("p", 1.0)),
            source=clause.strip(),
        )

    def __repr__(self):
        return f"FaultSpec({self.source!r}, fired={self.fired})"


class FaultInjector:
    """A parsed schedule of :class:`FaultSpec` clauses plus the seeded
    RNG and the (optional) virtual-time origin the ``at=`` triggers
    measure from.  Thread-safe: fault points fire from the dispatch
    worker, the completion worker, and N warmup threads concurrently.
    """

    def __init__(self, spec: str = "", seed: int = 0, rank: int | None = None):
        self.specs = [
            FaultSpec.parse(clause)
            for clause in spec.split(";")
            if clause.strip()
        ]
        self.seed = seed
        # This process's gang rank, for rank= scoped trainer clauses: the
        # launcher's env contract (RANK) by default, so a schedule like
        # 'kill:step:rank=1:after=4' handed identically to every gang
        # member fires only inside rank 1.
        import os as _os

        self.rank = (
            int(_os.environ.get("RANK", 0) or 0) if rank is None else int(rank)
        )
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._t0: float | None = None
        # Released by uninstall() so stuck hang sleepers wake instead of
        # outliving the test that injected them.
        self._unhang = threading.Event()

    def start(self) -> "FaultInjector":
        """Set the virtual-time origin for ``at=`` triggers (the moment
        the workload begins, not the moment the injector was built)."""
        self._t0 = time.monotonic()
        return self

    def fire(self, site: str, replica: str | None = None) -> None:
        """Evaluate every armed clause against one fault-point event.

        Raises :class:`FaultError` for a matching ``fail``; sleeps for a
        matching ``hang``; silently returns otherwise.  Counters mutate
        under the lock; the hang sleep runs outside it.
        """
        for spec in self.specs:
            if spec.site != site:
                continue
            if spec.replica is not None and spec.replica != replica:
                continue
            if spec.rank is not None and spec.rank != self.rank:
                continue
            if spec.at_s is not None and (
                self._t0 is None or time.monotonic() - self._t0 < spec.at_s
            ):
                continue
            with self._lock:
                if spec.after > 0:
                    spec.after -= 1
                    continue
                if spec.count <= 0:
                    continue
                if spec.p < 1.0 and self._rng.random() >= spec.p:
                    continue
                spec.count -= 1
                spec.fired += 1
                op, hang_s, source = spec.op, spec.hang_s, spec.source
            if op == "hang":
                self._unhang.wait(hang_s)
            elif op == "kill":
                # Simulated SIGKILL: no exception, no finally blocks, no
                # atexit — the process is simply gone, which is the
                # preemption the checkpoint rotation must survive.  137
                # is the 128+SIGKILL convention the chaos driver asserts.
                import os

                os._exit(137)
            else:
                raise FaultError(
                    f"injected {op} at {site}"
                    + (f" on {replica}" if replica else "")
                    + f" ({source})",
                    op=op,
                    site=site,
                )

    def fired_counts(self) -> dict[str, int]:
        """``{clause source: times fired}`` — the chaos report's receipt
        that the schedule actually bit."""
        with self._lock:
            return {spec.source: spec.fired for spec in self.specs}


# The module-global installed injector.  None = every fault point is a
# single attribute load + branch — the near-zero-overhead contract.
_INJECTOR: FaultInjector | None = None


def install(injector: FaultInjector) -> FaultInjector:
    global _INJECTOR
    _INJECTOR = injector
    return injector


def uninstall() -> None:
    """Remove the installed injector and wake any thread stuck in one of
    its ``hang`` sleeps (tests must not wait out a 3-second hang whose
    assertion already passed)."""
    global _INJECTOR
    injector, _INJECTOR = _INJECTOR, None
    if injector is not None:
        injector._unhang.set()


def fault_point(site: str, replica: str | None = None) -> None:
    """The hook the serving hot path calls.  Dormant unless installed."""
    injector = _INJECTOR
    if injector is not None:
        injector.fire(site, replica)


def active() -> bool:
    """True when an injector is installed.  The trainer reads this to
    decide whether to route steps through the resilient runtime (the
    fault sites live there) even when no resilience flag is set — so an
    in-process ``with injected("fail:step:after=3"):`` bites without
    extra plumbing.  The flagless no-injector path stays untouched."""
    return _INJECTOR is not None


def active_sites() -> frozenset:
    """The sites named by the installed schedule (empty when none).
    The trainer uses this to refuse configurations where an armed
    trainer-site clause could never fire (e.g. ``--fused``, whose one
    device call has no step/data_next/ckpt_save events) — a chaos run
    that injects nothing must fail loudly, not report green."""
    injector = _INJECTOR
    if injector is None:
        return frozenset()
    return frozenset(spec.site for spec in injector.specs)


@contextmanager
def injected(spec: str, seed: int = 0):
    """``with injected("fail:launch:r0:count=3"):`` — install, start,
    and always uninstall (the test-suite ergonomic surface)."""
    injector = install(FaultInjector(spec, seed=seed)).start()
    try:
        yield injector
    finally:
        uninstall()
