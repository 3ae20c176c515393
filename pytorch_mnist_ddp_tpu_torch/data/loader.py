"""Epoch-based batch loader over in-memory uint8 arrays, for one rank.

The batches, their order and their 0/1 pad weights are the JAX package's
``DataLoader`` ones for every (seed, epoch), and rank r of N draws what the
JAX package's process r of N draws: the same sampler
(``parallel/sampler.py``: cyclic padding to a multiple of N, then a stride
of N), the same slicing, and the final partial batch padded to the static
batch shape with zero rows of weight 0 (so shapes never change; the loss
divides by the real count).  ``batch_size`` is per rank.  The sampler's
padding duplicates keep weight 1 by default, as torch's
``DistributedSampler`` trains on them; ``mask_padding`` gives them weight
0, so that an evaluation counts each sample once.  Each batch is
normalized on the host with numpy, copied into pinned memory and sent to
the device with a ``non_blocking`` copy.  No prefetch thread yet.

``shard``/``num_shards`` cut each batch the other way, as the JAX
package's in-process mesh shards a global batch over its data axis: the
epoch goes in global batches of ``batch_size * num_shards`` (the last one
padded at its end), and this loader yields rows ``shard * batch_size``
onward of each, so a shard may hold padding alone.  The ViT's parallel
modes use it, one shard per data coordinate.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..parallel.sampler import epoch_indices, per_rank_count
from .transforms import normalize

Batch = tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (x, y, weight)


class DataLoader:
    """``epoch(e[, start_batch])`` yields ``(x f32 [b, 28, 28, 1], y int64
    [b], w f32 [b])`` on ``device``."""

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        batch_size: int,
        device: torch.device,
        shuffle: bool = True,
        seed: int = 0,
        rank: int = 0,
        world_size: int = 1,
        mask_padding: bool = False,
        shard: int = 0,
        num_shards: int = 1,
    ) -> None:
        if not 0 <= shard < num_shards:
            raise ValueError(f"shard {shard} out of range for {num_shards} shards")
        self.images = images
        self.labels = labels.astype(np.int64)
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.seed = seed
        self.rank = rank
        self.world_size = world_size
        self.mask_padding = mask_padding
        self.shard = shard
        self.num_shards = num_shards

    def __len__(self) -> int:
        """Batches per epoch on this rank, the final partial one included."""
        per_step = self.batch_size * self.num_shards
        return -(-per_rank_count(len(self.labels), self.world_size) // per_step)

    @property
    def global_batch(self) -> int:
        """Samples a step over every rank and shard (the log lines' counter
        step)."""
        return self.batch_size * self.world_size * self.num_shards

    @property
    def dataset_len(self) -> int:
        """The whole set's size, over every rank."""
        return len(self.labels)

    def _assemble(
        self, idx: np.ndarray, valid: np.ndarray, b: int
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host batch ``b`` of this rank's epoch indices ``idx``; ``valid``
        is False on the sampler's padding duplicates."""
        bs = self.batch_size
        start = (b * self.num_shards + self.shard) * bs
        take = idx[start : start + bs]
        x = normalize(self.images[take])
        y = self.labels[take]
        if self.mask_padding:
            w = valid[start : start + bs].astype(np.float32)
        else:
            w = np.ones(len(take), np.float32)
        if len(take) < bs:  # pad the final partial batch, weight 0
            pad = bs - len(take)
            x = np.concatenate([x, np.zeros((pad, *x.shape[1:]), x.dtype)])
            y = np.concatenate([y, np.zeros(pad, y.dtype)])
            w = np.concatenate([w, np.zeros(pad, np.float32)])
        return x, y, w

    def _host_batches(
        self, epoch: int, start_batch: int = 0
    ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        idx, valid = epoch_indices(
            len(self.labels), self.world_size, self.rank, epoch, self.seed,
            self.shuffle, return_valid=True,
        )
        for b in range(start_batch, len(self)):
            yield self._assemble(idx, valid, b)

    def _place(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(a)
        if self.device.type == "cpu":
            return t
        # pin_memory() copies into the caching host allocator, which keeps
        # the block until the asynchronous copy that reads it has finished.
        return t.pin_memory().to(self.device, non_blocking=True)

    def epoch(self, epoch: int, start_batch: int = 0) -> Iterator[Batch]:
        """The batches of ``epoch`` from batch ``start_batch`` on: a
        resumed run skips the first ones without assembling them and
        consumes exactly the rest of the epoch's permutation."""
        for host_batch in self._host_batches(epoch, start_batch):
            yield tuple(self._place(a) for a in host_batch)  # type: ignore[misc]
