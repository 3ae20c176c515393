"""PreemptionHandler: SIGTERM/SIGINT, then an emergency checkpoint, then a
clean exit (the JAX package's ``resilience/preempt.py``).

Preemptible capacity sends SIGTERM and a grace window.  The handler
turns the signal into a flag that the step loop polls at each step
boundary (a signal handler must not touch the device or take locks; the
step boundary is where a consistent state exists), where the runtime
writes an emergency mid-epoch archive and exits ``128 + signum`` (143
for SIGTERM, 130 for SIGINT), the code an unhandled signal gives.

Bounded grace: the first signal starts a daemon timer that force-exits
with the same code after ``grace_s`` if the clean path has not finished;
a second signal exits at once.  Python runs a signal's handler on the
main thread between bytecodes, so a signal that lands while the main
thread waits inside one call (an NCCL collective, a CUDA synchronize)
reaches the handler only when that call returns.  The timer must not
wait for that: ``install`` also gives the interpreter a wakeup pipe
(``signal.set_wakeup_fd``), written at the signal's arrival, and a
daemon thread that reads it starts the timer (and exits on a second
signal) whatever the main thread is doing.  The emergency save then
happens at the next step boundary if the main thread reaches one within
the grace, and the process exits ``128 + signum`` either way.

``install``/``uninstall`` restore the previous handlers.  Only the main
thread can install (CPython's rule); elsewhere the handler is never
requested.
"""

from __future__ import annotations

import os
import signal
import threading

# sysexits.h EX_TEMPFAIL: the step watchdog aborted a wedged run
# (runtime.py, --stall-abort).
EXIT_STALLED = 75

_SIGNALS = (signal.SIGTERM, signal.SIGINT)


class PreemptionHandler:
    def __init__(self, grace_s: float = 30.0) -> None:
        self.grace_s = float(grace_s)
        self.requested = False
        self.signum: int | None = None
        self._prev: dict[int, object] = {}
        self._timer: threading.Timer | None = None
        self._arrived = 0  # signals seen by the wakeup thread
        self._lock = threading.Lock()
        self._installed = False
        self._pipe: tuple[int, int] | None = None
        self._prev_wakeup = -1
        self._reader: threading.Thread | None = None

    @property
    def exit_code(self) -> int:
        return 128 + (self.signum or signal.SIGTERM)

    def _arm(self, signum: int) -> None:
        """Start the grace timer once; called by the handler and by the
        wakeup thread, whichever sees the signal first."""
        with self._lock:
            if self._timer is not None or self.grace_s <= 0:
                return
            self._timer = threading.Timer(self.grace_s, os._exit, args=(128 + signum,))
            self._timer.daemon = True
            self._timer.start()

    def _handle(self, signum, frame) -> None:
        if self.requested:
            os._exit(128 + signum)  # a second signal: now
        self.requested = True
        self.signum = signum
        self._arm(signum)

    def _read_wakeups(self, fd: int) -> None:
        while True:
            try:
                data = os.read(fd, 64)
            except OSError:
                return
            if not data:
                return  # the pipe was closed: uninstalled
            for signum in data:
                if signum not in _SIGNALS:
                    continue
                self._arrived += 1
                if self._arrived > 1:
                    os._exit(128 + signum)
                self._arm(signum)

    def install(self) -> "PreemptionHandler":
        if threading.current_thread() is not threading.main_thread():
            return self  # signal.signal is the main thread's only
        for sig in _SIGNALS:
            self._prev[sig] = signal.signal(sig, self._handle)
        r, w = os.pipe()
        os.set_blocking(w, False)
        self._pipe = (r, w)
        self._prev_wakeup = signal.set_wakeup_fd(w, warn_on_full_buffer=False)
        self._reader = threading.Thread(target=self._read_wakeups, args=(r,),
                                        name="preempt-wakeup", daemon=True)
        self._reader.start()
        self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            for sig, prev in self._prev.items():
                signal.signal(sig, prev)
            self._prev.clear()
            signal.set_wakeup_fd(self._prev_wakeup)
            r, w = self._pipe
            os.close(w)  # the reader sees end of file and returns
            self._reader.join()
            os.close(r)
            self._pipe = self._reader = None
            self._installed = False
        # An in-process caller outlives the "preemption": the timer must
        # not kill it grace_s later.  Taken under the lock _arm() holds, so
        # a timer armed by the wakeup thread is never left running; the
        # handlers are restored by now, so no handler re-enters the lock.
        with self._lock:
            timer, self._timer = self._timer, None
        if timer is not None:
            timer.cancel()
