"""``StepLR`` as a pure function of the epoch."""

from __future__ import annotations

from typing import Callable


def step_lr(base_lr: float, gamma: float = 0.7, step_size: int = 1) -> Callable[[int], float]:
    """``epoch (1-based) -> lr``: ``base_lr`` decayed by ``gamma`` after
    every ``step_size`` epochs, as torch's ``StepLR`` stepped at epoch end."""

    def lr_for_epoch(epoch: int) -> float:
        return base_lr * gamma ** ((epoch - 1) // step_size)

    return lr_for_epoch
