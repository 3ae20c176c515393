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
gathered and normalized on the host by the native core
(``data/native.py``: C++ through ctypes, which releases the interpreter
for the call, bit for bit numpy's ``normalize``; numpy itself only where
no compiler is found), copied into pinned memory and sent to the device
with a ``non_blocking`` copy on the consumer's stream.
``prefetch_depth`` batches (2 by default, as in the JAX package) are
assembled ahead of the consumer by a thread (``data/prefetch.py``);
``prefetch_depth <= 0`` assembles them inline.  The batches are the same
at every depth.  The JAX package's thread also places its batches on the
device; here the pinning and the copy stay on the consumer's thread: on
the card a thread that also pinned and copied (on a stream of its own)
made an epoch of steps slower than ``prefetch_depth`` 0, and one that only
assembles did not (``tools/prefetch_variants.py``, ``PERF.md``): the step
loop is host-bound, and the two threads share the interpreter.

A host batch's assembly is the ``data_next`` fault point
(``serving/faults.py``), retried up to ``data_retries`` times with
backoff on the transient classes (``OSError``, ``RuntimeError``): the
assembly is deterministic, so a retried batch is the same batch.  Each
retry counts ``data_retries_total{pipeline=}`` and emits a ``data_retry``
event; past the budget the error reaches the consumer at that batch (at
depth > 0 it is raised on the prefetch thread and carried through the
queue).  ``sink`` also takes the prefetcher's ``prefetch_epoch`` event.

``shard``/``num_shards`` cut each batch the other way, as the JAX
package's in-process mesh shards a global batch over its data axis: the
epoch goes in global batches of ``batch_size * num_shards`` (the last one
padded at its end), and this loader yields rows ``shard * batch_size``
onward of each, so a shard may hold padding alone.  The ViT's parallel
modes use it, one shard per data coordinate.

:meth:`DataLoader.index_table` lays an epoch's batches out as index and
weight tables instead, for the fused path's gather on the device
(``parallel/fused.py``): the same rows in the same order, with the final
partial batch filled by wrapping this rank's indices, at weight 0.
"""

from __future__ import annotations

import time
from typing import Iterator

import numpy as np
import torch

from ..parallel.sampler import epoch_indices, per_rank_count
from ..serving.faults import fault_point
from . import native
from .prefetch import DevicePrefetcher
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
        prefetch_depth: int = 2,
        registry=None,
        pipeline: str = "data",
        sink=None,
        data_retries: int = 3,
        data_backoff_s: float = 0.05,
    ) -> None:
        if not 0 <= shard < num_shards:
            raise ValueError(f"shard {shard} out of range for {num_shards} shards")
        self.images = images
        self._labels_raw = labels  # the native label gather reads uint8
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
        self.prefetch_depth = int(prefetch_depth)
        self.registry = registry
        self.pipeline = pipeline
        self.sink = sink
        self.data_retries = int(data_retries)
        self.data_backoff_s = float(data_backoff_s)

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
        # native writes [b, 28, 28]; the channel axis is added as numpy's
        # normalize adds it (stride 0), so both paths give one layout
        x = native.gather_normalize(self.images, take)
        x = normalize(self.images[take]) if x is None else x[..., None]
        y = native.gather_labels(self._labels_raw, take)
        if y is None:
            y = self.labels[take]
        if self.mask_padding:
            w = valid[start : start + bs].astype(np.float32)
        else:
            w = np.ones(len(take), np.float32)
        if len(take) < bs:  # pad the final partial batch, weight 0
            pad = bs - len(take)
            # Padded in 3-D and the channel axis added after, so that this
            # batch has normalize's layout too (that axis at stride 0): the
            # convolutions may sum in another order for another layout.
            x = np.concatenate([x[..., 0], np.zeros((pad, *x.shape[1:3]), x.dtype)])[..., None]
            y = np.concatenate([y, np.zeros(pad, y.dtype)])
            w = np.concatenate([w, np.zeros(pad, np.float32)])
        return x, y, w

    def _epoch_indices(self, epoch: int) -> tuple[np.ndarray, np.ndarray]:
        return epoch_indices(
            len(self.labels), self.world_size, self.rank, epoch, self.seed,
            self.shuffle, return_valid=True,
        )

    def _host_batches(
        self, epoch: int, start_batch: int = 0
    ) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
        idx, valid = self._epoch_indices(epoch)
        for b in range(start_batch, len(self)):
            yield self._assemble_retrying(idx, valid, epoch, b)

    def _assemble_retrying(self, idx, valid, epoch: int, b: int):
        """:meth:`_assemble` behind the ``data_next`` fault point, retried
        on the transient classes (module docstring)."""
        for attempt in range(self.data_retries + 1):
            try:
                fault_point("data_next")
                return self._assemble(idx, valid, b)
            except (OSError, RuntimeError) as e:
                if attempt >= self.data_retries:
                    raise RuntimeError(
                        f"data pipeline [{self.pipeline}] failed assembling batch {b} "
                        f"of epoch {epoch} after {attempt + 1} attempt(s): {e}"
                    ) from e
                if self.registry is not None:
                    self.registry.counter("data_retries_total",
                                          help="transient input-pipeline faults retried",
                                          pipeline=self.pipeline).inc()
                if self.sink is not None:
                    self.sink.emit("data_retry", pipeline=self.pipeline, epoch=epoch, batch=b,
                                   attempt=attempt + 1, error=f"{type(e).__name__}: {e}")
                time.sleep(self.data_backoff_s * (2 ** attempt))

    def index_table(self, epoch: int) -> tuple[np.ndarray, np.ndarray]:
        """``(idx int64 [batches, batch_size], w float32 [batches,
        batch_size])``: the rows of each of ``epoch``'s batches, as
        :meth:`epoch` yields them, and their weights; the final partial
        batch is filled by wrapping this rank's indices, at weight 0."""
        idx, valid = self._epoch_indices(epoch)
        bs = self.batch_size
        b = np.arange(len(self))[:, None]
        pos = (b * self.num_shards + self.shard) * bs + np.arange(bs)
        inside = pos < len(idx)
        w = valid[pos % len(idx)] if self.mask_padding else np.ones(pos.shape, bool)
        return idx[pos % len(idx)].astype(np.int64), (w & inside).astype(np.float32)

    def _place(self, host_batch) -> Batch:
        ts = tuple(torch.from_numpy(a) for a in host_batch)
        if self.device.type == "cpu":
            return ts  # type: ignore[return-value]
        # pin_memory() copies into the caching host allocator, which keeps
        # the block until the asynchronous copy that reads it has finished.
        return tuple(t.pin_memory().to(self.device, non_blocking=True)
                     for t in ts)  # type: ignore[return-value]

    def epoch(self, epoch: int, start_batch: int = 0) -> Iterator[Batch]:
        """The batches of ``epoch`` from batch ``start_batch`` on: a
        resumed run skips the first ones without assembling them and
        consumes exactly the rest of the epoch's permutation.  Abandoning
        the iterator stops the prefetch thread."""
        feed = DevicePrefetcher(self._host_batches(epoch, start_batch), self.prefetch_depth,
                                self.registry, self.pipeline, sink=self.sink, epoch=epoch)
        try:
            for host_batch in feed:
                yield self._place(host_batch)
        finally:
            feed.close()
