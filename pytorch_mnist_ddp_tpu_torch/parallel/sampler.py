"""Per-rank sample indices with ``DistributedSampler`` semantics.

A numpy ``RandomState(seed + epoch)`` permutation, as in the JAX package,
so the port draws the same batches in the same order for every (seed,
epoch, rank).  With ``world_size == 1`` this is ``RandomSampler``; with
``shuffle=False``, ``SequentialSampler``; otherwise the permutation is
padded cyclically to a multiple of the world and strided by rank.
"""

from __future__ import annotations

import numpy as np


def epoch_indices(
    n: int,
    world_size: int = 1,
    rank: int = 0,
    epoch: int = 0,
    seed: int = 0,
    shuffle: bool = True,
    return_valid: bool = False,
) -> np.ndarray | tuple[np.ndarray, np.ndarray]:
    """Sample indices of ``rank`` for one epoch; with ``return_valid`` also
    a bool mask that is False on the padding duplicates."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} out of range for world_size {world_size}")
    if shuffle:
        indices = np.random.RandomState(seed + epoch).permutation(n)
    else:
        indices = np.arange(n)
    if world_size == 1:
        return (indices, np.ones(n, bool)) if return_valid else indices
    num_samples = -(-n // world_size)
    total = num_samples * world_size
    if total > n:
        # Cyclic padding (np.resize), as torch's DistributedSampler: a
        # single concatenation under-fills when the padding exceeds n.
        indices = np.resize(indices, total)
    positions = np.arange(rank, total, world_size)
    if return_valid:
        return indices[positions], positions < n
    return indices[positions]


def per_rank_count(n: int, world_size: int) -> int:
    """Samples each rank draws per epoch (after padding)."""
    return -(-n // world_size)
