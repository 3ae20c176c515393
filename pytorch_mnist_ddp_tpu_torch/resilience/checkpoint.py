"""MidEpochCheckpointer: periodic and emergency full-state archives with a
rotating ``last``/``last-1`` publish (the JAX package's
``resilience/checkpoint.py``).

The archive is ``--save-state``'s (``utils/checkpoint.save_train_state``,
the JAX package's npz format), written at any step boundary with the
mid-epoch position in its ``meta.*`` extras:

- ``epoch_in_progress`` / ``batch_cursor``: the epoch the run was in and
  the batches of it consumed (the steps taken, not the batches the
  prefetch thread assembled), so a resumed run replays exactly the rest;
- ``seed`` / ``global_batch``: the data order the cursor addresses; a
  resume checks them;
- ``world_size``: the data-parallel degree the position was cut at;
- ``steps_total`` / ``samples_total``: the telemetry counters, so a
  resumed run's exposition continues the killed run's numbers.

The parameters, both accumulators, the BatchNorm averages and the step
counter (which seeds every step's dropout) travel in the base archive.

The publish, where a kill is aimed::

    write the archive to <path>.new      (atomic itself: mkstemp + fsync)
    rotate <path> -> <path>.prev         (where a previous publish exists)
    [fault point 'ckpt_save']
    publish <path>.new -> <path>

A kill during the write leaves ``<path>`` and ``<path>.prev`` as they
were; a kill between rotate and publish leaves no ``<path>`` but a whole
``<path>.prev``, which ``--resume-state`` falls back to
(``utils/checkpoint.load_latest_train_state``).

A failed periodic save is reported and survived (``runtime.py``); a
failed preemption save propagates.
"""

from __future__ import annotations

import os
import time

from ..serving.faults import fault_point
from ..utils.checkpoint import PREV_SUFFIX, TrainArchive, save_train_state


class MidEpochCheckpointer:
    """Rotated mid-epoch archives for one training run.

    ``path`` is the ``--save-state`` target (rotations at ``path +
    ".prev"``, the write in flight at ``path + ".new"``); ``every_steps``
    the cadence in optimizer steps (0: emergency saves only); ``seed``,
    ``global_batch`` and ``world_size`` (0 leaves it out) go into every
    archive's extras; ``registry``/``sink`` take
    ``train_checkpoints_total{reason=}``, ``checkpoint_write_seconds`` and
    a ``checkpoint`` event a save."""

    def __init__(
        self,
        path: str,
        every_steps: int = 0,
        seed: int = 0,
        global_batch: int = 0,
        world_size: int = 0,
        registry=None,
        sink=None,
    ) -> None:
        self.path = path
        self.prev_path = path + PREV_SUFFIX
        self.tmp_path = path + ".new"
        self.every_steps = int(every_steps)
        self.seed = int(seed)
        self.global_batch = int(global_batch)
        self.world_size = int(world_size)
        self._registry = registry
        self._sink = sink
        self.saves = 0
        self._write_hist = (
            registry.histogram("checkpoint_write_seconds",
                               help="wall time of one mid-epoch archive write+publish")
            if registry is not None else None
        )

    def due(self, steps_done: int) -> bool:
        """True when ``steps_done`` (steps completed by this run) hits the
        cadence."""
        return self.every_steps > 0 and steps_done % self.every_steps == 0

    def save(
        self,
        host_state: TrainArchive,
        *,
        epoch_in_progress: int,
        batch_cursor: int,
        steps_total: int,
        samples_total: int,
        reason: str = "periodic",
    ) -> float:
        """Write, rotate and publish one mid-epoch archive of
        ``host_state`` (the runtime's ``prepare`` made it: host tensors,
        the accumulators per leaf or flat); returns the wall seconds."""
        t0 = time.perf_counter()
        extras = {
            "epoch_in_progress": epoch_in_progress,
            "batch_cursor": batch_cursor,
            "seed": self.seed,
            "global_batch": self.global_batch,
            "steps_total": steps_total,
            "samples_total": samples_total,
        }
        if self.world_size > 0:
            extras["world_size"] = self.world_size
        save_train_state(host_state.params, host_state.opt, host_state.step, self.tmp_path,
                         epoch=epoch_in_progress - 1, extras=extras,
                         batch_stats=host_state.batch_stats)
        if os.path.exists(self.path):
            os.replace(self.path, self.prev_path)
        # A death here leaves no <path>, only the whole rotation at
        # <path>.prev.
        fault_point("ckpt_save")
        os.replace(self.tmp_path, self.path)
        duration = time.perf_counter() - t0
        self.saves += 1
        if self._registry is not None:
            self._registry.counter("train_checkpoints_total",
                                   help="mid-epoch checkpoint archives published",
                                   reason=reason).inc()
        if self._write_hist is not None:
            self._write_hist.observe(duration)
        if self._sink is not None:
            self._sink.emit("checkpoint", reason=reason, epoch=epoch_in_progress,
                            batch_cursor=batch_cursor, steps_total=steps_total,
                            duration_s=round(duration, 6), path=self.path)
        return duration
