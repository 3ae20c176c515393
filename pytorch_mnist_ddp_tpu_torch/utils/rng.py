"""Seeds for the explicit generators of a training run.

One ``--seed`` yields one seed per named stream (weight init, dropout),
and the dropout stream yields one seed per optimizer step, as the JAX
package folds the step counter into its dropout key.  Each step seeds the
dropout generator afresh, so the masks of a step depend on (seed, step)
alone, not on how many draws came before.  In a world of several ranks
each rank folds its rank into the step's seed as well, as the JAX package
folds the replica's ``axis_index`` into its key.  The numbers are numpy
``SeedSequence`` outputs: they are not JAX's keys, so masks and initial
weights differ between the two packages.
"""

from __future__ import annotations

import numpy as np

# Stream order never changes, or seeds stop reproducing.
_STREAMS = ("init", "dropout")


def _derive(entropy: int, key: int) -> int:
    """A 63-bit seed from ``(entropy, key)``."""
    word = np.random.SeedSequence(entropy, spawn_key=(key,)).generate_state(1, np.uint64)[0]
    return int(word) >> 1


def split_streams(seed: int) -> dict[str, int]:
    """``{"init": s0, "dropout": s1}`` from the run's ``--seed``."""
    return {name: _derive(seed, i) for i, name in enumerate(_STREAMS)}


def fold_step(stream_seed: int, step: int) -> int:
    """The seed of optimizer step ``step`` of a stream."""
    return _derive(stream_seed, step)


def fold_replica_step(stream_seed: int, step: int, rank: int = 0, world_size: int = 1) -> int:
    """The seed of optimizer step ``step`` on ``rank`` of ``world_size``
    ranks.  A world of one draws :func:`fold_step`'s seed, the stream of a
    single-device run."""
    seed = fold_step(stream_seed, step)
    return seed if world_size == 1 else _derive(seed, rank)
