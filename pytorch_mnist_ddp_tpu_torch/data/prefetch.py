"""A bounded queue of input batches, fed by a background thread (the JAX
package's ``data/prefetch.py`` ``DevicePrefetcher``).

While the consumer's step k runs, batch k+1 is made ready by the thread,
so the consumer's wait for the next batch shrinks to a queue pop.  The
class is generic: it iterates any batch iterable on the thread (the
work of making a batch is the iterable's: ``data/loader.py`` has the
thread assemble its host batches and pins and copies them on the
consumer's side) and keeps up to ``depth`` of them in a bounded queue.
``depth <= 0`` is the synchronous baseline: the iterable runs inline on
the consumer's thread.  The batches are the same either way; only the
overlap changes.

Given a :class:`~..obs.registry.Registry`, two histograms labelled
``pipeline=`` record each consume:

- ``data_wait_seconds``: how long the consumer blocked for the next
  batch (near zero: the device never waits on the host);
- ``prefetch_buffer_occupancy``: the batches buffered at that
  moment (``depth`` when the producer keeps ahead, 0 when starved).

The JAX package also emits a ``prefetch_epoch`` event a finished epoch
into its telemetry sink; the port has no event sink yet.

A producer's exception reaches the consumer at the batch where it was
raised.  A consumer that stops early (a ``--dry-run`` break, an
exception in the step loop) closes the iterator, and :meth:`close` stops
and joins the producer thread.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Iterator

_END = object()


class _Raised:
    """The producer's exception, carried through the queue."""

    def __init__(self, error: BaseException):
        self.error = error


class DevicePrefetcher:
    """Up to ``depth`` batches of ``source`` made ahead of the consumer.

    ``source`` is consumed on the producer thread (inline when ``depth <=
    0``); ``registry`` and ``pipeline`` as in the module docstring."""

    def __init__(self, source: Iterable, depth: int = 2, registry=None,
                 pipeline: str = "data"):
        self._source = iter(source)
        self.depth = int(depth)
        self._wait_hist = self._occ_hist = None
        if registry is not None:
            self._wait_hist = registry.histogram(
                "data_wait_seconds",
                help="consumer wait for the next batch "
                "(near zero: the device never waits on the host)",
                pipeline=pipeline,
            )
            self._occ_hist = registry.histogram(
                "prefetch_buffer_occupancy",
                help="batches buffered at each consume "
                "(depth: the producer is ahead; 0: the consumer is starved)",
                pipeline=pipeline,
            )
        self._stop = threading.Event()
        self._queue: queue.Queue | None = None
        self._thread: threading.Thread | None = None
        if self.depth > 0:
            self._queue = queue.Queue(maxsize=self.depth)
            self._thread = threading.Thread(target=self._produce,
                                            name=f"prefetch-{pipeline}", daemon=True)
            self._thread.start()

    # -- producer (depth > 0) -------------------------------------------------

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        try:
            for batch in self._source:
                if not self._put(batch):
                    return  # the consumer stopped early
            self._put(_END)
        except BaseException as e:  # raised again on the consumer's side
            self._put(_Raised(e))

    # -- consumer -------------------------------------------------------------

    def __iter__(self) -> Iterator:
        try:
            while True:
                t0 = time.perf_counter()
                if self._queue is None:
                    try:
                        item = next(self._source)
                    except StopIteration:
                        return
                    occupancy = 0
                else:
                    item = self._queue.get()
                    if item is _END:
                        return
                    if isinstance(item, _Raised):
                        raise item.error
                    occupancy = self._queue.qsize()
                if self._wait_hist is not None:
                    self._wait_hist.observe(time.perf_counter() - t0)
                    self._occ_hist.observe(occupancy)
                yield item
        finally:
            self.close()

    def close(self) -> None:
        """Stop and join the producer; idempotent."""
        self._stop.set()
        if self._queue is not None:
            while True:
                try:
                    self._queue.get_nowait()
                except queue.Empty:
                    break
        if self._thread is not None:
            self._thread.join()
            self._thread = None
