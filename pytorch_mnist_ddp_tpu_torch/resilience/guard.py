"""LossGuard: per-step anomaly detection and the rollback policy (the JAX
package's ``resilience/guard.py``).

One poisoned optimizer step (NaN/Inf from a bad batch, a hardware fault,
a divergence spike) destroys every parameter, and the port's step writes
the parameters and accumulators in place.  The guard classifies each
step's loss on the host (one read a step, the opt-in ``--loss-guard``
trade; a run without the flag never pays it), and the runtime
(``runtime.py``) restores the pre-step snapshot and retries:

- retry 1 runs at the original learning rate, so a transient anomaly
  (the injected NaN, a flipped bit, a corrupt shard) heals with zero
  numeric divergence: the retried step is the step an unfaulted run
  takes, bit for bit;
- retries 2..budget scale the lr by ``backoff ** (attempt - 1)``: a
  repeated anomaly on the same batch at the same parameters asks for a
  smaller step;
- a spent budget raises :class:`AnomalyBudgetExhausted`, which the CLIs
  turn into one diagnostic and exit :data:`EXIT_ANOMALY`.

A spike is a loss above ``spike_factor`` times the running mean (EWMA)
of accepted losses; only accepted steps feed that mean.

numpy and the standard library only; the snapshot and restore on the
device live in ``runtime.py``.
"""

from __future__ import annotations

import numpy as np

# sysexits.h EX_SOFTWARE: the run ABORTED on an unrecoverable training
# anomaly (budget exhausted), as opposed to crashing by accident.
EXIT_ANOMALY = 70


class AnomalyBudgetExhausted(RuntimeError):
    """Raised when a step stays anomalous through every allowed retry.

    The CLIs catch exactly this type and print its message as the run's
    single diagnostic (non-zero exit EXIT_ANOMALY); everything else
    still surfaces as a traceback — an unknown crash must not be dressed
    up as a handled anomaly."""


class LossGuard:
    """Anomaly classifier + retry/backoff policy for one training run.

    Parameters
    ----------
    spike_factor:
        A loss above ``spike_factor * ewma(accepted losses)`` counts as
        a spike anomaly.  ``0`` disables spike detection (NaN/Inf only).
    retry_budget:
        Retries allowed per step before aborting.  The budget is
        PER-STEP: a healthy step resets nothing because nothing carries
        over — each step's attempts count from zero.
    lr_backoff:
        Multiplicative LR factor applied from the second retry on
        (``lr_scale(1) == 1.0`` — see the module docstring for why the
        first retry must not perturb the numerics).
    ewma_alpha:
        Smoothing of the accepted-loss baseline.
    """

    def __init__(
        self,
        spike_factor: float = 10.0,
        retry_budget: int = 3,
        lr_backoff: float = 0.5,
        ewma_alpha: float = 0.1,
    ) -> None:
        if retry_budget < 1:
            raise ValueError("retry_budget must be >= 1")
        if not 0.0 < lr_backoff <= 1.0:
            raise ValueError("lr_backoff must be in (0, 1]")
        self.spike_factor = float(spike_factor)
        self.retry_budget = int(retry_budget)
        self.lr_backoff = float(lr_backoff)
        self.ewma_alpha = float(ewma_alpha)
        self._ewma: float | None = None
        self.anomalies = 0  # total classified anomalies (all kinds)

    # -- classification -----------------------------------------------------

    def classify(self, losses) -> str | None:
        """``None`` for a healthy step, else the anomaly kind.

        ``losses`` is the step's per-replica host loss array (any shape;
        a scalar works too).  NaN/Inf on any replica is an anomaly:
        the averaged gradients poisoned every replica's parameters even
        where only one shard's loss shows it."""
        arr = np.asarray(losses, dtype=np.float64)
        if not bool(np.isfinite(arr).all()):
            return "nan"
        if self.spike_factor > 0 and self._ewma is not None:
            if float(arr.mean()) > self.spike_factor * max(self._ewma, 1e-12):
                return "spike"
        return None

    def record_healthy(self, losses) -> None:
        """Feed an ACCEPTED step's loss into the spike baseline."""
        loss = float(np.asarray(losses, dtype=np.float64).mean())
        if self._ewma is None:
            self._ewma = loss
        else:
            self._ewma += self.ewma_alpha * (loss - self._ewma)

    # -- retry policy -------------------------------------------------------

    def lr_scale(self, attempt: int) -> float:
        """LR multiplier for retry number ``attempt`` (1-based).

        1.0 for the first retry (transparent heal of a transient), then
        ``lr_backoff ** (attempt - 1)`` — the deterministic-spike
        escape hatch."""
        if attempt <= 1:
            return 1.0
        return self.lr_backoff ** (attempt - 1)

    @property
    def ewma(self) -> float | None:
        return self._ewma
