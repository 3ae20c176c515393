"""The port's input prefetch (``data/prefetch.py``, ``--prefetch-depth``):
the JAX package's ``tests/test_steadystate.py`` checks that need no JAX,
on the port's ``DevicePrefetcher`` and loader.

- Depth 2 hides the assembly under the consumer's step, structurally
  (sleeps stand in for both), beating the serial chain by over 25%.
- The wait and occupancy histograms record every consume; the serial
  baseline's wait is the whole assembly.
- A producer's exception reaches the consumer; a consumer that stops
  early reaps the producer thread (also through the loader and
  ``fit(--dry-run)``).
- The loader's batches, and a CNN training run's lines and bits, are the
  same at every depth.

Imports no JAX.
"""

from __future__ import annotations

import contextlib
import io
import struct
import threading
import time

import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu_torch.data.loader import DataLoader
from pytorch_mnist_ddp_tpu_torch.data.mnist import synthetic_mnist
from pytorch_mnist_ddp_tpu_torch.data.prefetch import DevicePrefetcher
from pytorch_mnist_ddp_tpu_torch.mnist import build_parser
from pytorch_mnist_ddp_tpu_torch.obs.registry import Registry
from pytorch_mnist_ddp_tpu_torch.trainer import fit

LIMIT = 256  # fit(): 8 steps of 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _slow(n: int, assemble_s: float):
    for i in range(n):
        time.sleep(assemble_s)  # assembly and the copy's issue
        yield i


def _drive(depth: int, n: int, assemble_s: float, step_s: float) -> float:
    feed = DevicePrefetcher(_slow(n, assemble_s), depth=depth)
    t0 = time.perf_counter()
    got = []
    for item in feed:
        time.sleep(step_s)  # the step the feed must hide under
        got.append(item)
    assert got == list(range(n))  # in order, nothing dropped
    return time.perf_counter() - t0


def _threads_settle(before: int) -> int:
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    return threading.active_count()


def test_prefetch_throughput_beats_serial_structurally():
    assemble, step, n = 0.02, 0.02, 8
    serial = _drive(0, n, assemble, step)
    overlapped = _drive(2, n, assemble, step)
    assert serial >= n * (assemble + step)  # depth 0: nothing overlaps
    assert overlapped < 0.75 * serial


def test_prefetch_records_wait_and_occupancy():
    registry = Registry()
    feed = DevicePrefetcher(iter(range(6)), depth=2, registry=registry, pipeline="train")
    for _ in feed:
        time.sleep(0.005)  # a consumer slower than the producer: the buffer fills
    wait = registry.histogram("data_wait_seconds", pipeline="train")
    occ = registry.histogram("prefetch_buffer_occupancy", pipeline="train")
    assert wait.count == 6 and occ.count == 6
    assert occ.sum > 0  # the producer ran ahead at least once
    assert max(occ.values()) <= 2


def test_prefetch_serial_baseline_records_full_wait():
    registry = Registry()
    feed = DevicePrefetcher(_slow(3, 0.01), depth=0, registry=registry, pipeline="train")
    assert list(feed) == [0, 1, 2]
    # Depth 0: the whole assembly is the consumer's wait.
    wait = registry.histogram("data_wait_seconds", pipeline="train")
    assert wait.count == 3 and wait.sum >= 3 * 0.01
    assert set(registry.histogram("prefetch_buffer_occupancy", pipeline="train").values()) == {0}


@pytest.mark.parametrize("depth", [0, 2])
def test_prefetch_propagates_producer_errors(depth):
    def bad():
        yield 1
        raise RuntimeError("gather failed")

    it = iter(DevicePrefetcher(bad(), depth=depth))
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="gather failed"):
        list(it)


def test_prefetch_abandoned_consumer_reaps_producer():
    before = threading.active_count()
    feed = DevicePrefetcher(iter(range(100)), depth=2)
    for _ in feed:
        break  # abandon at once
    feed.close()
    assert _threads_settle(before) <= before


def test_abandoned_loader_epoch_stops_its_thread():
    images, labels = synthetic_mnist("train", 320)
    loader = DataLoader(images, labels, 32, "cpu", seed=1)
    before = threading.active_count()
    batches = loader.epoch(1)
    next(batches)
    assert threading.active_count() > before  # the producer runs ahead
    batches.close()
    assert _threads_settle(before) <= before


@pytest.mark.parametrize("mask", [False, True], ids=["train", "eval"])
def test_loader_batches_equal_at_every_depth(mask):
    images, labels = synthetic_mnist("train", 203)
    registry = Registry()
    runs = {}
    for depth in (0, 1, 2, 4):
        loader = DataLoader(images, labels, 24, "cpu", shuffle=not mask, seed=3, rank=1,
                            world_size=3, mask_padding=mask, prefetch_depth=depth,
                            registry=registry, pipeline=f"d{depth}")
        runs[depth] = list(loader.epoch(2, start_batch=1))
        assert registry.histogram("data_wait_seconds", pipeline=f"d{depth}").count == len(
            runs[depth]) == len(loader) - 1
    for depth, batches in runs.items():
        for got, want in zip(batches, runs[0], strict=True):
            assert all(torch.equal(a, b) for a, b in zip(got, want)), depth


# -- a training run ----------------------------------------------------------

@pytest.fixture(scope="module")
def idx_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("idx")
    for split, prefix in (("train", "train"), ("test", "t10k")):
        images, labels = synthetic_mnist(split, LIMIT)
        (root / f"{prefix}-images-idx3-ubyte").write_bytes(
            struct.pack(">iiii", 2051, *images.shape) + images.tobytes())
        (root / f"{prefix}-labels-idx1-ubyte").write_bytes(
            struct.pack(">ii", 2049, len(labels)) + labels.tobytes())
    return root


def _fit(monkeypatch, idx_root, *flags):
    monkeypatch.setenv("MNIST_DATA_DIR", str(idx_root))
    args = build_parser().parse_args(["--batch-size", "32", "--test-batch-size", "64",
                                      "--epochs", "2", "--log-interval", "1", *flags])
    out = io.StringIO()
    registry = Registry()
    with contextlib.redirect_stdout(out):
        model, state = fit(args, "cpu", registry=registry)
    return model, state, out.getvalue(), registry


def test_training_curve_bit_identical_prefetch_on_vs_off(monkeypatch, idx_root):
    """The prefetch changes when host work happens, never what is
    computed: the lines and the final bits are the same at depth 2 and 0,
    and both loaders record a wait a consume."""
    on = _fit(monkeypatch, idx_root, "--pallas-opt")
    off = _fit(monkeypatch, idx_root, "--pallas-opt", "--prefetch-depth", "0")
    assert on[2] == off[2] and on[2].count("Test set:") == 2
    assert on[1].step == off[1].step == 16
    for (k, a), (_, b) in zip(on[0].state_dict().items(), off[0].state_dict().items()):
        assert torch.equal(a, b), k
    assert all(torch.equal(a, b) for a, b in zip(on[1].opt, off[1].opt))
    for _, _, _, registry in (on, off):
        assert registry.histogram("data_wait_seconds", pipeline="train").count == 16
        assert registry.histogram("data_wait_seconds", pipeline="eval").count == 8


def test_dry_run_break_reaps_the_prefetch_thread(monkeypatch, idx_root):
    before = threading.active_count()
    _, state, out, _ = _fit(monkeypatch, idx_root, "--dry-run", "--epochs", "1")
    assert state.step == 1 and "Test set:" in out
    assert _threads_settle(before) <= before
    assert np.isfinite(float(out.split("Loss: ")[1].split()[0]))
