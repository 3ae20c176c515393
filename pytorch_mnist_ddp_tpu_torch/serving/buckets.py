"""Power-of-two batch buckets and the staging buffers they are padded into.

Every dispatch is padded UP to the nearest rung of a small power-of-two
ladder and the results sliced back down: the engine warms each rung once
(cuDNN algorithm choice, kernel builds), and no request shape reaches the
device that warmup did not.  Packed mode collapses the ladder to one
rows-capacity and concatenates requests with a segment-id vector instead.

The ladder helpers are host numpy; :class:`StagingPool` keeps its buffers
in pinned host memory when the engine serves on the card, so the
host-to-device copy of a batch can run asynchronously.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..analysis.lockwatch import make_lock

# Default ladder ceiling: 1, 2, 4, ..., 128.
DEFAULT_MAX_BUCKET = 128


def pow2_buckets(max_bucket: int = DEFAULT_MAX_BUCKET, min_bucket: int = 1) -> tuple[int, ...]:
    """The power-of-two ladder from ``min_bucket`` (rounded up to a power
    of two: an EP replica's buckets must split over its ``k`` row shards)
    up to ``max_bucket``."""
    if min_bucket < 1 or max_bucket < min_bucket:
        raise ValueError(
            f"need 1 <= min_bucket <= max_bucket, got {min_bucket}..{max_bucket}"
        )
    b = 1
    while b < min_bucket:
        b *= 2
    out = []
    while b <= max_bucket:
        out.append(b)
        b *= 2
    if not out:
        raise ValueError(f"no power of two in [{min_bucket}, {max_bucket}]")
    return tuple(out)


def validate_buckets(buckets: Sequence[int], n_shards: int = 1) -> tuple[int, ...]:
    """Sorted, deduplicated ladder; every bucket a positive power of two
    (a free-form ladder would reintroduce unbounded warmed shapes) that
    splits over the replica's ``n_shards`` row shards."""
    out = sorted(set(int(b) for b in buckets))
    if not out:
        raise ValueError("empty bucket list")
    for b in out:
        if b < 1 or (b & (b - 1)):
            raise ValueError(f"bucket {b} is not a positive power of two")
        if b % n_shards:
            raise ValueError(f"bucket {b} not divisible by the {n_shards}-way data axis")
    return tuple(out)


def packed_capacities(max_bucket: int, n_shards: int = 1) -> tuple[int, ...]:
    """The rows-capacity ladder for packed batch formation: one rung,
    ``max_bucket`` rounded up to a power of two (and to the row shards), so
    a packed engine takes exactly the request sizes its bucketed twin
    does.  Idempotent."""
    if max_bucket < 1:
        raise ValueError(f"need max_bucket >= 1, got {max_bucket}")
    top = 1
    while top < max(max_bucket, n_shards):
        top *= 2
    if top % n_shards:
        raise ValueError(f"capacity {top} not divisible by the {n_shards}-way data axis")
    return (top,)


def segment_ids(lengths: Sequence[int], capacity: int) -> np.ndarray:
    """``int32[capacity]``: each row's request (segment) index in staging
    order, ``-1`` on padding rows."""
    total = 0
    ids = np.full(capacity, -1, np.int32)
    for seg, n in enumerate(lengths):
        if n < 1:
            raise ValueError(f"segment {seg} has non-positive length {n}")
        if total + n > capacity:
            raise ValueError(f"segments total {total + n} overflow capacity {capacity}")
        ids[total : total + n] = seg
        total += n
    return ids


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """The smallest bucket >= n."""
    if n < 1:
        raise ValueError(f"batch size must be >= 1, got {n}")
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"batch of {n} exceeds the top bucket {buckets[-1]}")


def pad_to_bucket(x: np.ndarray, bucket: int) -> np.ndarray:
    """Zero-pad rows so ``len(x) == bucket``.  Rows are independent
    through the eval forward, so padding cannot perturb real rows."""
    n = len(x)
    if n > bucket:
        raise ValueError(f"batch of {n} does not fit bucket {bucket}")
    if n == bucket:
        return x
    pad = np.zeros((bucket - n, *x.shape[1:]), x.dtype)
    return np.concatenate([x, pad])


class StagingPool:
    """Preallocated per-bucket pad targets, recycled through a free list.

    ``slots`` buffers per bucket are allocated once (pinned host memory
    when ``pin`` is set) and steady-state staging is a copy into one of
    them.  A buffer is released only after its batch's result was read
    back: the asynchronous host-to-device copy reads it until then.
    :meth:`acquire` blocks when every slot is taken.
    """

    def __init__(
        self,
        buckets: Sequence[int],
        item_shape: Sequence[int],
        slots: int = 1,
        pin: bool = False,
    ):
        if slots < 1:
            raise ValueError(f"need >= 1 staging slot per bucket, got {slots}")
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.slots = slots
        self._cond = make_lock("buckets.staging", kind="condition")
        self._free: dict[int, list[torch.Tensor]] = {
            b: [
                torch.zeros((b, *item_shape), dtype=torch.float32, pin_memory=pin)
                for _ in range(slots)
            ]
            for b in self.buckets
        }

    def acquire(self, bucket: int) -> torch.Tensor:
        with self._cond:
            free = self._free[bucket]  # KeyError = unknown bucket, loudly
            while not free:
                self._cond.wait()
            return free.pop()

    def release(self, buf: torch.Tensor, bucket: int) -> None:
        with self._cond:
            self._free[bucket].append(buf)
            self._cond.notify()

    def stage(self, parts: Sequence[np.ndarray]) -> tuple[torch.Tensor, int]:
        """Copy ``parts`` row-blocks into one bucket-shaped buffer, live
        rows first and a zeroed tail; the caller owns it until
        :meth:`release`."""
        total = sum(len(p) for p in parts)
        bucket = bucket_for(total, self.buckets)
        buf = self.acquire(bucket)
        view = buf.numpy()
        offset = 0
        for p in parts:
            view[offset : offset + len(p)] = p
            offset += len(p)
        if offset < bucket:
            view[offset:] = 0.0
        return buf, bucket
