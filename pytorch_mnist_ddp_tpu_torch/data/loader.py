"""Epoch-based batch loader over in-memory uint8 arrays, for one device.

The batches, their order and their 0/1 pad weights are the JAX package's
``DataLoader`` ones for every (seed, epoch) in a world of one: the same
sampler (``parallel/sampler.py``), the same slicing, and the final partial
batch padded to the static batch shape with zero rows of weight 0 (so
shapes never change; the loss divides by the real count).  Each batch is
normalized on the host with numpy, copied into pinned memory and sent to
the device with a ``non_blocking`` copy.  No prefetch thread yet.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..parallel.sampler import epoch_indices
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
    ) -> None:
        self.images = images
        self.labels = labels.astype(np.int64)
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.shuffle = shuffle
        self.seed = seed

    def __len__(self) -> int:
        """Batches per epoch, the final partial one included."""
        return -(-len(self.labels) // self.batch_size)

    @property
    def dataset_len(self) -> int:
        return len(self.labels)

    def _assemble(
        self, idx: np.ndarray, b: int
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host batch ``b`` of the epoch permutation ``idx``."""
        bs = self.batch_size
        take = idx[b * bs : (b + 1) * bs]
        x = normalize(self.images[take])
        y = self.labels[take]
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
        idx = epoch_indices(
            len(self.labels), epoch=epoch, seed=self.seed, shuffle=self.shuffle
        )
        for b in range(start_batch, len(self)):
            yield self._assemble(idx, b)

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
