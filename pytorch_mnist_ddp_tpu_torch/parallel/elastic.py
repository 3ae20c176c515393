"""The elastic gang runtime: the launcher's supervision of its ranks (the
JAX package's ``parallel/elastic.py``).

- :class:`GangSupervisor`: one OS process per rank; SIGTERM/SIGINT to
  the launcher are forwarded to every rank's process group (so the
  trainer's emergency save fires through the launcher); liveness and
  per-rank heartbeat files are watched, and on a dead or hung rank the
  survivors get SIGTERM with a bounded grace (then SIGKILL) and the
  whole world is restarted under a seeded exponential backoff and a
  restart budget, ending in one diagnostic and :data:`EXIT_GANG` when
  the budget is spent.
- :class:`RankHeartbeat`: the trainer's side, a throttled touch of
  ``ELASTIC_HEARTBEAT_FILE`` at each step boundary.

The launcher does no resume arithmetic: a restarted rank runs the
original command with ``ELASTIC_RESTART_COUNT`` exported, and the trainer
resumes its own ``--save-state`` archive with ``--epochs`` as the total
(``trainer.py``).  The one change to the command is ``--chaos``: a chaos
schedule describes the first incarnation, so restarts run without it
(:func:`strip_chaos_args`); otherwise the same kill would fire in every
incarnation and spend the budget.

Telemetry: the counters ``launch_restarts_total`` and
``rank_deaths_total{rank=}``, the gauge
``rank_heartbeat_age_seconds{rank=}``, and the events ``rank_death``,
``gang_restart``, ``gang_exhausted`` and ``gang_signal_exit``.

Standard library only: supervision must keep working when the thing it
supervises is what broke.  The liveness primitives live in
``liveness.py``.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time

from ..liveness import (
    BackoffLadder,
    Heartbeat,
    heartbeat_age_s,
    signal_process_group as _signal_proc,
)
from ..liveness import heartbeat_path as _liveness_heartbeat_path

# sysexits.h EX_UNAVAILABLE: the gang's restart budget is exhausted —
# the world cannot be (re)formed.  Sibling of EXIT_STALLED (75) and
# EXIT_ANOMALY (70) in the resilience package.
EXIT_GANG = 69

# Env contract between the launcher and its rank children.
ENV_HEARTBEAT_FILE = "ELASTIC_HEARTBEAT_FILE"
ENV_TELEMETRY_DIR = "ELASTIC_TELEMETRY_DIR"
ENV_RESTART_COUNT = "ELASTIC_RESTART_COUNT"
ENV_RDZV_TIMEOUT_S = "RDZV_TIMEOUT_S"
ENV_RDZV_ATTEMPTS = "RDZV_ATTEMPTS"

_FORWARDED_SIGNALS = (signal.SIGTERM, signal.SIGINT)


def exit_code(returncode: int) -> int:
    """A process's code as a shell reports it: ``128 + signum`` for a
    signal (``Popen.returncode`` is ``-signum``)."""
    return 128 - returncode if returncode < 0 else returncode


def heartbeat_path(directory: str, rank: int) -> str:
    return _liveness_heartbeat_path(directory, f"rank{int(rank)}")


class RankHeartbeat(Heartbeat):
    """Trainer-side heartbeat writer (liveness.Heartbeat with
    the rank env contract): ``beat()`` is called at every step boundary
    (resilience/runtime.py ``after_step``), throttled to one touch per
    ``interval_s``."""

    @classmethod
    def from_env(cls) -> "RankHeartbeat | None":
        """The trainer's constructor: ``ELASTIC_HEARTBEAT_FILE`` set by
        the launcher (or an operator) opts the step loop in; unset —
        the flagless path — builds nothing."""
        path = os.environ.get(ENV_HEARTBEAT_FILE)
        return cls(path) if path else None


def strip_chaos_args(argv: list[str]) -> list[str]:
    """Remove ``--chaos SPEC`` / ``--chaos-seed N`` pairs (and their
    ``=``-joined forms) from a child command line.  A chaos schedule
    describes incarnation 0 — the injected failure IS the experiment —
    so a gang restart must run clean or the same deterministic kill
    would re-fire every incarnation."""
    out: list[str] = []
    skip = False
    for arg in argv:
        if skip:
            skip = False
            continue
        if arg in ("--chaos", "--chaos-seed"):
            skip = True
            continue
        if arg.startswith("--chaos=") or arg.startswith("--chaos-seed="):
            continue
        out.append(arg)
    return out


class _RankProc:
    """One rank's live process + the supervisor's bookkeeping for it."""

    __slots__ = ("rank", "proc", "hb_path")

    def __init__(self, rank: int, proc: subprocess.Popen, hb_path: str | None):
        self.rank = rank
        self.proc = proc
        self.hb_path = hb_path


class GangSupervisor:
    """Supervise a gang of rank processes; restart the world on rank
    death under a budget::

        running ──rank dead/hung──▶ stopping (grace SIGTERM→SIGKILL)
           ▲                              │
           │  backoff elapsed             │ attempts > restart_budget
           └───────── restarting ◀────────┤
                                          ▼
                              exhausted (EXIT_GANG, one diagnostic)

    Parameters
    ----------
    spawn:
        ``spawn(rank, restart_count) -> subprocess.Popen`` — the child
        factory.  The launcher's spawn exports the rank env contract
        and starts each child in its own session (so the supervisor
        can signal the whole process GROUP); tests pass tiny
        ``python -c`` children.
    nprocs:
        Gang size (ranks 0..nprocs-1).
    restart_budget:
        Gang restarts before escalation.  0 = never restart: the first
        incident escalates immediately (still one diagnostic).
    backoff_base_s / backoff_max_s / backoff_jitter / seed:
        The exponential restart ladder, seeded so two chaos runs
        schedule identically.
    grace_s:
        SIGTERM-to-SIGKILL window when stopping survivors (and when
        forwarding an operator signal) — the same bounded-grace
        contract as ``--preempt-grace-s``, one level up.
    heartbeat_dir / heartbeat_timeout_s:
        When both set, a rank whose heartbeat file exists but is older
        than the timeout is treated as hung (same incident path as
        death).  A rank that has not written its FIRST beat is startup,
        never hung — budget rendezvous + first-step compile elsewhere.
    healthy_after_s:
        A gang incarnation that survives this long resets the attempts
        ladder.
    propagate_exit:
        Transparent mode (the launcher without --nprocs or a budget): on a
        child's own non-zero exit with no budget, return ITS code with
        no diagnostic — the ``128+signum`` convention must pass
        through the launcher unchanged.
    """

    def __init__(
        self,
        spawn,
        nprocs: int,
        *,
        restart_budget: int = 3,
        backoff_base_s: float = 0.5,
        backoff_max_s: float = 30.0,
        backoff_jitter: float = 0.25,
        seed: int = 0,
        grace_s: float = 10.0,
        heartbeat_dir: str | None = None,
        heartbeat_timeout_s: float = 0.0,
        healthy_after_s: float = 30.0,
        poll_s: float = 0.1,
        propagate_exit: bool = False,
        registry=None,
        sink=None,
    ):
        if nprocs < 1:
            raise ValueError(f"nprocs must be >= 1, got {nprocs}")
        self.spawn = spawn
        self.nprocs = int(nprocs)
        self.restart_budget = max(0, int(restart_budget))
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.backoff_jitter = float(backoff_jitter)
        self.grace_s = float(grace_s)
        self.heartbeat_dir = heartbeat_dir
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.healthy_after_s = float(healthy_after_s)
        self.poll_s = float(poll_s)
        self.propagate_exit = bool(propagate_exit)
        self._registry = registry
        self._sink = sink
        # Seeded: the backoff ladder must not make two chaos runs
        # diverge (liveness.py discipline).
        self._ladder = BackoffLadder(
            base_s=self.backoff_base_s, max_s=self.backoff_max_s,
            jitter=self.backoff_jitter, seed=seed,
        )
        self.attempts = 0        # restarts since the last healthy spell
        self.restarts = 0        # lifetime gang restarts
        self.recovery_s: list[float] = []
        self._procs: list[_RankProc] = []
        self._signal: int | None = None
        self._prev_handlers: dict[int, object] = {}
        self._incarnation_t = 0.0

    # -- the restart ladder --------------------------------------------------

    def backoff_s(self, attempts: int) -> float:
        """Rung ``attempts`` of the seeded exponential ladder — public
        so the determinism test can replay the schedule."""
        return self._ladder.delay_s(attempts)

    # -- signal forwarding ---------------------------------------------------

    def _handle_signal(self, signum, frame) -> None:
        if self._signal is not None:
            # Second signal: the operator means NOW (as in preempt.py) —
            # but take the gang down first: os._exit skips run()'s
            # finally, and a rank wedged in a dead collective (its own
            # session) would outlive the launcher holding devices and
            # ports, breaking the never-leave-orphans guarantee.
            self._signal_gang(signal.SIGKILL)
            os._exit(128 + signum)
        self._signal = signum
        self._signal_gang(signum)

    def install_signals(self) -> None:
        """Forward SIGTERM/SIGINT to every rank's process group — the
        satellite bugfix: a SIGTERM to the launcher must reach the
        children so the trainer's emergency save fires."""
        for sig in _FORWARDED_SIGNALS:
            self._prev_handlers[sig] = signal.signal(sig, self._handle_signal)

    def uninstall_signals(self) -> None:
        for sig, prev in self._prev_handlers.items():
            signal.signal(sig, prev)
        self._prev_handlers.clear()

    def _signal_gang(self, signum: int) -> None:
        for rp in self._procs:
            if rp.proc.poll() is None:
                _signal_proc(rp.proc, signum)

    # -- gang lifecycle ------------------------------------------------------

    def _start_gang(self) -> None:
        self._procs = []
        for rank in range(self.nprocs):
            hb = (
                heartbeat_path(self.heartbeat_dir, rank)
                if self.heartbeat_dir
                else None
            )
            if hb is not None:
                # A stale beat from the previous incarnation must not
                # read as this incarnation's hang.
                try:
                    os.remove(hb)
                except OSError:
                    pass
            self._procs.append(_RankProc(rank, self.spawn(rank, self.restarts), hb))
        self._incarnation_t = time.monotonic()

    def _stop_gang(self) -> None:
        """Grace-kill every still-alive rank: SIGTERM (emergency-save
        window), then SIGKILL whatever is left after ``grace_s``."""
        alive = [rp for rp in self._procs if rp.proc.poll() is None]
        for rp in alive:
            _signal_proc(rp.proc, signal.SIGTERM)
        deadline = time.monotonic() + self.grace_s
        for rp in alive:
            remaining = deadline - time.monotonic()
            try:
                rp.proc.wait(timeout=max(0.05, remaining))
            except subprocess.TimeoutExpired:
                _signal_proc(rp.proc, signal.SIGKILL)
                rp.proc.wait()

    # -- health reads --------------------------------------------------------

    def _sick_rank(self) -> tuple[int, str, object] | None:
        """(rank, reason, detail) for the first dead/hung rank, else
        None.  A 0-exit is only an incident when the rest of the gang
        cannot finish without it — handled by the all-exited check in
        :meth:`run`, not here."""
        now_wall = time.time()
        for rp in self._procs:
            code = rp.proc.poll()
            if code is not None and code != 0:
                return rp.rank, "exit", code
            if (
                code is None
                and rp.hb_path is not None
                and self.heartbeat_timeout_s > 0
            ):
                age = heartbeat_age_s(rp.hb_path, now_wall)
                if self._registry is not None and age is not None:
                    self._registry.gauge(
                        "rank_heartbeat_age_seconds",
                        help="seconds since each rank's last step-boundary "
                        "heartbeat (absent ranks are still starting up)",
                        rank=rp.rank,
                    ).set(age)
                if age is not None and age > self.heartbeat_timeout_s:
                    return rp.rank, "heartbeat", age
        return None

    # -- the supervision loop ------------------------------------------------

    def run(self) -> int:
        """Blocking supervision: returns the launcher's exit code."""
        self._start_gang()
        try:
            while True:
                time.sleep(self.poll_s)
                if self._signal is not None:
                    # Operator-initiated: the children already got the
                    # signal (the handler forwarded it); give them the
                    # grace window to save, then propagate 128+signum.
                    self._stop_gang()
                    if self._sink:
                        self._sink.emit(
                            "gang_signal_exit", signum=self._signal,
                        )
                    return 128 + self._signal
                if (
                    self.attempts
                    and time.monotonic() - self._incarnation_t
                    > self.healthy_after_s
                ):
                    # Healed spell: the next incident starts a fresh
                    # ladder.
                    self.attempts = 0
                sick = self._sick_rank()
                if sick is None:
                    codes = [rp.proc.poll() for rp in self._procs]
                    if all(c is not None for c in codes):
                        return 0  # whole gang finished clean
                    continue
                rank, reason, detail = sick
                code = self._handle_incident(rank, reason, detail)
                if code is not None:
                    return code
        finally:
            # Never leave orphans: whatever path exits, the gang dies
            # with the launcher.
            self._stop_gang()

    def _handle_incident(self, rank, reason, detail) -> int | None:
        """Stop the gang and either restart it (None) or escalate
        (exit code)."""
        down_t0 = time.monotonic()
        if self._registry is not None:
            self._registry.counter(
                "rank_deaths_total",
                help="rank processes that died or hung, by rank",
                rank=rank,
            ).inc()
        if self._sink:
            self._sink.emit(
                "rank_death",
                rank=rank,
                reason=reason,
                **(
                    {"exit_code": int(detail)}
                    if reason == "exit"
                    else {"heartbeat_age_s": round(float(detail), 3)}
                ),
            )
        self._stop_gang()
        if self.propagate_exit and reason == "exit":
            # Transparent mode: the rank's own exit code passes through,
            # as a shell reports it (128+signum for a signal).
            return exit_code(int(detail))
        if self.attempts >= self.restart_budget:
            if self._sink:
                self._sink.emit(
                    "gang_exhausted",
                    attempts=self.attempts,
                    budget=self.restart_budget,
                    rank=rank,
                    reason=reason,
                )
            detail_txt = (
                f"exit {int(detail)}" if reason == "exit"
                else f"heartbeat silent {float(detail):.1f}s"
            )
            print(
                f"launch: gang failed: rank {rank} "
                f"{'died' if reason == 'exit' else 'hung'} ({detail_txt}) "
                f"and the restart budget ({self.restart_budget}) is "
                "exhausted; the latest coordinated --save-state archive "
                "is intact — fix the cause and relaunch to resume from it",
                file=sys.stderr,
                flush=True,
            )
            return EXIT_GANG
        backoff = self.backoff_s(self.attempts)
        self.attempts += 1
        time.sleep(backoff)
        self.restarts += 1
        if self._registry is not None:
            self._registry.counter(
                "launch_restarts_total",
                help="gang restarts performed by the supervising launcher",
            ).inc()
        self._start_gang()
        downtime = time.monotonic() - down_t0
        self.recovery_s.append(downtime)
        if self._sink:
            self._sink.emit(
                "gang_restart",
                attempt=self.attempts,
                restart_count=self.restarts,
                backoff_s=round(backoff, 3),
                downtime_s=round(downtime, 3),
                rank=rank,
                reason=reason,
            )
        return None
