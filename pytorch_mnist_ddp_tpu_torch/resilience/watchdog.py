"""StepWatchdog: hung-step detection for the training loop (the JAX
package's ``resilience/watchdog.py``).

A wedged collective, a lost device or an injected ``hang:step`` stalls
the step loop silently.  A polling daemon thread measures the age of the
current step window and calls ``on_stall(age_s)`` when it passes
``timeout_s``.

The contract with the step loop:

- ``beat()`` after every completed step (the runtime calls it after the
  step's host read) re-arms the window;
- ``suspend()``/``resume()`` bracket the regions where no step is in
  flight (evaluation, epoch boundaries, checkpoint writes), so a long
  evaluation never reads as a stalled step;
- ``on_stall`` fires once a stalled window, not once a poll; the abort
  decision is the callback's (``runtime.py``).

The watchdog needs a real completion signal: enabling it makes the
runtime wait for each step's loss (the one host read a step that
``--step-stats`` and ``--telemetry-dir`` also make).  Without it an
asynchronous launch queue never hangs on the host, and a watchdog would
watch nothing.  Plain ``threading`` primitives, standard library only.
"""

from __future__ import annotations

import threading
import time

from ..analysis.lockwatch import make_lock


class StepWatchdog:
    def __init__(self, timeout_s: float, on_stall, poll_s: float | None = None) -> None:
        if timeout_s <= 0:
            raise ValueError("timeout_s must be > 0")
        self.timeout_s = float(timeout_s)
        self.on_stall = on_stall
        self.poll_s = float(poll_s) if poll_s else max(timeout_s / 4.0, 0.01)
        self._lock = make_lock("watchdog.heartbeat")
        self._window_start: float | None = None  # None: suspended
        self._beats = 0
        self._reported_window = -1  # the beat index already reported
        self.stalls = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # -- step-loop surface --------------------------------------------------

    def beat(self) -> None:
        """A step completed; re-arm the stall window."""
        with self._lock:
            self._beats += 1
            self._window_start = time.monotonic()

    def resume(self) -> None:
        """Enter a stepping region (epoch start): arm the window."""
        with self._lock:
            self._window_start = time.monotonic()

    def suspend(self) -> None:
        """Leave the stepping region (evaluation, epoch end)."""
        with self._lock:
            self._window_start = None

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "StepWatchdog":
        self._thread = threading.Thread(target=self._watch, name="train-watchdog", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- detector -----------------------------------------------------------

    def _watch(self) -> None:
        while not self._stop.wait(self.poll_s):
            with self._lock:
                start = self._window_start
                beats = self._beats
                already = self._reported_window == beats
            if start is None or already:
                continue
            age = time.monotonic() - start
            if age <= self.timeout_s:
                continue
            with self._lock:
                # A beat may have landed while the age was computed: that
                # window is healthy.
                if self._beats != beats or self._window_start is None:
                    continue
                self._reported_window = beats
                self.stalls += 1
            try:
                self.on_stall(age)
            except Exception:
                # A broken telemetry sink must not end stall detection.
                pass
