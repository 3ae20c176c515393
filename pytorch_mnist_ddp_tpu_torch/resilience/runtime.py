"""ResilientRuntime: what the trainer's step loop drives when a resilience
flag is set, a fault injector is installed, or the supervising launcher
asked for heartbeats (the JAX package's ``resilience/runtime.py``).

The trainer gains two call sites: :meth:`ResilientRuntime.run_step` (the
guarded, fault-injectable step attempt) and :meth:`after_step` (cadence
checkpoints, preemption, the heartbeat).  A run without any of those
builds none of this, and its step loop is unchanged.

The port's step updates the model and the training state in place
(``parallel/ddp.py``: the delta kernel writes the parameters and both
accumulators where they lie).  So ``run_step`` goes::

    [snapshot: clones of the pre-step state]   guard only
    fault point 'step'                          kill/fail/hang/nan
    loss = step_fn(model, state, x, y, w, lr)   writes the state in place
    [host read of the loss]                     guard/watchdog only
    classify -> healthy: return
             -> anomaly: copy the snapshot back, retry (budget, backoff)

The snapshot clones every parameter, every buffer (BatchNorm's running
averages and ``num_batches_tracked``), every optimizer tensor in its
layout (per leaf, the delta kernel's flat buffers, or this rank's ZeRO
chunk) and keeps ``state.step``, which seeds the step's dropout
generator: a retry draws the same masks, and restoring is a copy into
the live tensors, bit for bit.  Clones, never views: the step overwrites
the buffers the snapshot must keep.
"""

from __future__ import annotations

import os

import torch

from ..serving.faults import FaultError, fault_point
from .guard import AnomalyBudgetExhausted, LossGuard
from .preempt import EXIT_STALLED, PreemptionHandler
from .watchdog import StepWatchdog


def _default_abort(code: int) -> None:  # pragma: no cover - process exit
    os._exit(code)


def _opt_tensors(opt) -> list[torch.Tensor]:
    """The optimizer state's tensors in a fixed order, whatever its
    layout: a tuple of tensors (flat, ZeRO) or of per-leaf dicts."""
    out: list[torch.Tensor] = []
    for part in opt:
        out.extend(part.values() if isinstance(part, dict) else [part])
    return out


def _live_tensors(model: torch.nn.Module, state) -> list[torch.Tensor]:
    return ([p.data for p in model.parameters()] + list(model.buffers())
            + _opt_tensors(state.opt))


def snapshot(model: torch.nn.Module, state) -> tuple[list[torch.Tensor], int]:
    """Clones of everything a step writes, and the step counter."""
    with torch.no_grad():
        return [t.clone() for t in _live_tensors(model, state)], int(state.step)


def restore(model: torch.nn.Module, state, snap: tuple[list[torch.Tensor], int]) -> None:
    """Copy a :func:`snapshot` back into the live tensors."""
    tensors, step = snap
    with torch.no_grad():
        live = _live_tensors(model, state)
        if len(live) != len(tensors):
            raise RuntimeError("the training state changed shape since its snapshot")
        for t, s in zip(live, tensors):
            t.copy_(s)
    state.step = step


class ResilientRuntime:
    """One training run's resilience: guard, watchdog, checkpointer,
    preemption, heartbeat.

    - ``guard``: a :class:`~.guard.LossGuard` or None; it reads each
      step's loss on the host.
    - ``checkpointer``: a :class:`~.checkpoint.MidEpochCheckpointer` or
      None.
    - ``preemption``: a :class:`~.preempt.PreemptionHandler` or None,
      polled at each step boundary.
    - ``step_timeout_s`` > 0 starts a :class:`~.watchdog.StepWatchdog`
      (which also reads each step's loss); on a stall it emits
      ``train_stall`` and ``train_stalls_total``, and with
      ``stall_abort`` exits :data:`EXIT_STALLED` through ``abort_fn``.
    - ``prepare(model, state)``: the host copy of the state for an
      archive (the ``--save-state`` gather, ZeRO's per-leaf gather
      included); it runs on every rank, and only the chief
      (``is_chief``) writes.
    - ``steps_total``/``samples_total``: the counters' bases from a
      resumed archive.
    - ``heartbeat``: a :class:`~..parallel.elastic.RankHeartbeat` touched
      at every step boundary.

    Cadence decisions are the same on every rank (each counts its own
    steps), so the coordinated archive needs no message; a preemption
    lands on each rank at its own step boundary, so its emergency save
    is the chief's, best effort, and the last cadence archive is the
    floor a gang resumes from.
    """

    def __init__(
        self,
        *,
        guard: LossGuard | None = None,
        checkpointer=None,
        preemption: PreemptionHandler | None = None,
        step_timeout_s: float = 0.0,
        stall_abort: bool = False,
        prepare=None,
        global_batch: int = 0,
        steps_total: int = 0,
        samples_total: int = 0,
        registry=None,
        sink=None,
        abort_fn=_default_abort,
        is_chief: bool = True,
        heartbeat=None,
    ) -> None:
        self.guard = guard
        self.checkpointer = checkpointer
        self.preemption = preemption
        self.is_chief = bool(is_chief)
        self.heartbeat = heartbeat
        self.prepare = prepare
        self.global_batch = int(global_batch)
        self.steps_total = int(steps_total)
        self.samples_total = int(samples_total)
        self.steps_local = 0
        self._registry = registry
        self._sink = sink
        self._stall_abort = bool(stall_abort)
        self._abort_fn = abort_fn
        self.watchdog = (StepWatchdog(step_timeout_s, self._on_stall)
                         if step_timeout_s and step_timeout_s > 0 else None)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "ResilientRuntime":
        if self.preemption is not None:
            self.preemption.install()
        if self.watchdog is not None:
            self.watchdog.suspend()  # armed an epoch at a time by begin_train
            self.watchdog.start()
        # No heartbeat here: the first beat lands at the first step's
        # boundary, so the rendezvous and the first step never count
        # against the supervisor's age clock.
        return self

    def stop(self) -> None:
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.preemption is not None:
            self.preemption.uninstall()

    def begin_train(self) -> None:
        """Entering a stepping region (an epoch's step loop)."""
        if self.watchdog is not None:
            self.watchdog.resume()

    def end_train(self) -> None:
        """Leaving it (evaluation or the epoch boundary follows)."""
        if self.watchdog is not None:
            self.watchdog.suspend()

    # -- the guarded step ---------------------------------------------------

    def run_step(self, step_fn, model, state, x, y, w, lr: float, *, epoch: int,
                 batch_idx: int) -> tuple[torch.Tensor, float | None]:
        """One resilient optimizer step; returns ``(loss, host loss or
        None)``.  The host loss is there when this step already read it
        (guard or watchdog), so the caller's telemetry and log line reuse
        it instead of reading again."""
        attempt = 0  # 0: the first try; > 0: the retry's number
        while True:
            snap = snapshot(model, state) if self.guard is not None else None
            xs = x
            try:
                fault_point("step")
            except FaultError as e:
                if getattr(e, "op", "fail") != "nan":
                    raise  # fail: a simulated crash
                # nan: poison this attempt's batch; the guard (if any)
                # must catch the fallout.
                xs = x * torch.full((), float("nan"), dtype=x.dtype, device=x.device)
            lr_in = lr
            if attempt > 0:
                scale = self.guard.lr_scale(attempt)
                if scale != 1.0:
                    lr_in = lr * scale
            loss = step_fn(model, state, xs, y, w, lr_in)
            if self.guard is None:
                host = None
                if self.watchdog is not None:
                    host = loss.item()  # the watchdog's completion signal
                    self.watchdog.beat()
                return loss, host
            host = loss.item()  # the guard's opt-in read
            if self.watchdog is not None:
                self.watchdog.beat()
            kind = self.guard.classify(host)
            if kind is None:
                self.guard.record_healthy(host)
                return loss, host
            # The update is poison: count, report, restore, retry (or give
            # up when the budget is spent).
            attempt += 1
            self.guard.anomalies += 1
            exhausted = attempt > self.guard.retry_budget
            if self._registry is not None:
                self._registry.counter(
                    "train_anomalies_total",
                    help="anomalous training steps detected by the LossGuard, by kind",
                    kind=kind,
                ).inc()
            if self._sink is not None:
                self._sink.emit("train_anomaly", kind=kind, epoch=epoch, step=batch_idx,
                                attempt=attempt, loss=float(host),
                                action="abort" if exhausted else "retry")
            restore(model, state, snap)
            if exhausted:
                raise AnomalyBudgetExhausted(
                    f"step {batch_idx} of epoch {epoch} stayed anomalous "
                    f"({kind}) through {self.guard.retry_budget} "
                    "rollback-and-retry attempt(s) with LR backoff "
                    f"{self.guard.lr_backoff}; the pre-step parameters "
                    "were restored exactly — resume from the last "
                    "checkpoint after fixing the cause (bad data shard, "
                    "too-hot schedule, failing hardware)"
                )

    # -- the step boundary --------------------------------------------------

    def after_step(self, model, state, *, epoch: int, batch_idx: int) -> None:
        """Bookkeeping, checkpoint and preemption at one completed step's
        boundary.  May raise SystemExit (preemption)."""
        self.steps_local += 1
        self.steps_total += 1
        self.samples_total += self.global_batch
        cursor = batch_idx + 1
        if self.heartbeat is not None:
            self.heartbeat.beat()
        if self.preemption is not None and self.preemption.requested:
            if self.checkpointer is not None:
                # No try/except: a failed emergency save must surface.
                self._save(model, state, epoch, cursor, reason="preempt")
            if self._sink is not None:
                self._sink.emit("preempt_exit", signum=self.preemption.signum,
                                exit_code=self.preemption.exit_code, epoch=epoch,
                                batch_cursor=cursor)
            raise SystemExit(self.preemption.exit_code)
        if self.checkpointer is not None and self.checkpointer.due(self.steps_local):
            try:
                self._save(model, state, epoch, cursor, reason="periodic")
            except Exception as e:
                # A failed periodic save is survivable: the rotation keeps
                # the previous archives, and the next cadence tries again.
                if self._registry is not None:
                    self._registry.counter(
                        "train_checkpoint_failures_total",
                        help="periodic checkpoint saves that failed (training continued)",
                    ).inc()
                if self._sink is not None:
                    self._sink.emit("checkpoint_failed", epoch=epoch, batch_cursor=cursor,
                                    error=f"{type(e).__name__}: {e}")

    def _save(self, model, state, epoch: int, cursor: int, reason: str) -> None:
        # No step is in flight during a write: the watchdog must not read
        # a slow write as a stalled step.
        if self.watchdog is not None:
            self.watchdog.suspend()
        try:
            host_state = self.prepare(model, state)  # every rank: may gather
            if self.is_chief:
                self.checkpointer.save(host_state, epoch_in_progress=epoch,
                                       batch_cursor=cursor, steps_total=self.steps_total,
                                       samples_total=self.samples_total, reason=reason)
        finally:
            if self.watchdog is not None:
                self.watchdog.resume()

    # -- stall handling -----------------------------------------------------

    def _on_stall(self, age_s: float) -> None:
        if self._registry is not None:
            self._registry.counter("train_stalls_total",
                                   help="steps that exceeded --step-timeout-s").inc()
        if self._sink is not None:
            self._sink.emit("train_stall", age_s=round(age_s, 3),
                            steps_total=self.steps_total)
        if self._stall_abort:
            if self._sink is not None:
                self._sink.close()  # flush: the abort is immediate
            self._abort_fn(EXIT_STALLED)
