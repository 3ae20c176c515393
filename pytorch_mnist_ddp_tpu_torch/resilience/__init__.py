"""The training runtime's resilience (the JAX package's ``resilience/``).

- :mod:`.checkpoint`: :class:`MidEpochCheckpointer`, periodic
  (``--checkpoint-every-steps``) and emergency archives at the exact
  mid-epoch position, published through a ``last``/``last-1`` rotation,
  so a kill at any point (a save included) leaves a loadable archive and
  ``--resume-state`` continues the uninterrupted run bit for bit;
- :mod:`.guard`: :class:`LossGuard`, which classifies each step's loss
  (NaN/Inf, a spike over the EWMA); the runtime restores the pre-step
  snapshot and retries, first at the same lr (a transient heals with no
  divergence), then with lr backoff, and raises
  :class:`AnomalyBudgetExhausted` (exit :data:`EXIT_ANOMALY`) when the
  budget is spent;
- :mod:`.watchdog`: :class:`StepWatchdog`, which emits ``train_stall``
  when a step passes ``--step-timeout-s`` (and exits
  :data:`EXIT_STALLED` with ``--stall-abort``);
- :mod:`.preempt`: :class:`PreemptionHandler`, SIGTERM/SIGINT to an
  emergency archive at the next step boundary and exit ``128 + signum``,
  under a grace timer;
- :mod:`.runtime`: :class:`ResilientRuntime`, the bundle the trainer
  drives, and the ``step`` fault point (``serving/faults.py``).

All opt-in: without a resilience flag, an installed injector or the
launcher's heartbeat file, the trainer builds none of it.
"""

from __future__ import annotations

from .checkpoint import MidEpochCheckpointer
from .guard import EXIT_ANOMALY, AnomalyBudgetExhausted, LossGuard
from .preempt import EXIT_STALLED, PreemptionHandler
from .runtime import ResilientRuntime
from .watchdog import StepWatchdog

__all__ = [
    "AnomalyBudgetExhausted",
    "EXIT_ANOMALY",
    "EXIT_STALLED",
    "LossGuard",
    "MidEpochCheckpointer",
    "PreemptionHandler",
    "ResilientRuntime",
    "StepWatchdog",
]
