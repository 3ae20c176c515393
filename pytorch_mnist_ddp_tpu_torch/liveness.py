"""Process-liveness primitives for the supervising launcher (the JAX
package's ``liveness.py``).

- **Heartbeat files**: a supervised process touches a file on its own
  work cadence (every step boundary); the supervisor reads the file's
  age.  A process that still answers ``poll()`` but stopped working (a
  wedged collective, a hung device read) is caught by age, not only by
  death.  A file that does not exist yet is start-up (rendezvous, the
  first step), never a hang: the age clock runs from the first beat.
- **BackoffLadder**: the seeded exponential restart ladder,
  ``min(max, base * 2**attempts)`` times a seeded jitter, so two chaos
  runs schedule their restarts alike.
- **signal_process_group** and **grace_stop**: signal a child's whole
  process group (supervised children run in sessions of their own), and
  SIGTERM then SIGKILL after a bounded grace.

Standard library only: supervision must keep working when the thing it
supervises is what broke.
"""

from __future__ import annotations

import os
import random
import signal as _signal
import subprocess
import time


def heartbeat_path(directory: str, label: object) -> str:
    """The canonical heartbeat file for one supervised process."""
    return os.path.join(directory, f"{label}.hb")


def heartbeat_age_s(path: str, now_wall: float | None = None) -> float | None:
    """Seconds since the last beat, or None when the process has not
    written its first beat yet (start-up — rendezvous, the first step —
    is covered by process liveness, not by heartbeat age)."""
    try:
        mtime = os.stat(path).st_mtime
    except OSError:
        return None
    now_wall = time.time() if now_wall is None else now_wall
    return max(0.0, now_wall - mtime)


class Heartbeat:
    """Supervised-process-side writer: a throttled file touch.

    ``beat()`` is called on the process's own work cadence (every step
    boundary, every dispatch-loop iteration) but only touches the file
    once per ``interval_s`` — one ``os.utime`` per half second, never a
    per-call syscall storm.  The first beat creates the file, which is
    the supervisor's signal that startup is over and the age clock may
    run.
    """

    def __init__(self, path: str, interval_s: float = 0.5):
        self.path = path
        self.interval_s = float(interval_s)
        self._last = 0.0
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)

    def beat(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last < self.interval_s:
            return
        self._last = now
        with open(self.path, "a"):
            os.utime(self.path, None)

    @classmethod
    def from_env(cls, var: str) -> "Heartbeat | None":
        """The supervised side's constructor: the env var set by the
        launcher (or an operator) opts the work loop in; unset — the
        flagless path — builds nothing."""
        path = os.environ.get(var)
        return cls(path) if path else None


class BackoffLadder:
    """Seeded exponential backoff: the restart ladder every supervisor
    climbs.  ``delay_s(attempts)`` is rung ``attempts`` (0-based) —
    ``min(max, base * 2**attempts)`` times a seeded jitter factor in
    ``[1, 1 + jitter]``.  One RNG draw per call, so a replayed schedule
    is identical draw-for-draw (the chaos determinism contract)."""

    def __init__(
        self,
        base_s: float = 0.5,
        max_s: float = 30.0,
        jitter: float = 0.25,
        seed: int = 0,
    ):
        self.base_s = float(base_s)
        self.max_s = float(max_s)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)

    def delay_s(self, attempts: int) -> float:
        backoff = min(self.max_s, self.base_s * (2 ** attempts))
        return backoff * (1.0 + self.jitter * self._rng.random())


def signal_process_group(proc: subprocess.Popen, signum: int) -> None:
    """Signal a child's whole process GROUP (supervised children run in
    their own sessions) — falling back to the single pid when the group
    is gone, or when the child SHARES the supervisor's group (a
    non-detached spawn: signalling that group would kill the supervisor
    itself)."""
    try:
        pgid = os.getpgid(proc.pid)
        if pgid == os.getpgrp():
            raise PermissionError("child shares the supervisor's group")
        os.killpg(pgid, signum)
    except (ProcessLookupError, PermissionError, OSError):
        try:
            proc.send_signal(signum)
        except (ProcessLookupError, OSError):
            pass


def grace_stop(
    procs: list[subprocess.Popen], grace_s: float,
    term: int = _signal.SIGTERM, kill: int = _signal.SIGKILL,
) -> None:
    """SIGTERM every still-alive process (its emergency-save window),
    then SIGKILL whatever is left after ``grace_s`` — the bounded-grace
    contract of the gang launcher."""
    alive = [p for p in procs if p.poll() is None]
    for p in alive:
        signal_process_group(p, term)
    deadline = time.monotonic() + grace_s
    for p in alive:
        remaining = deadline - time.monotonic()
        try:
            p.wait(timeout=max(0.05, remaining))
        except subprocess.TimeoutExpired:
            signal_process_group(p, kill)
            p.wait()
