"""The port's disk cache of the synthetic set (``data/mnist.py``
``_synthetic_cached``, ``utils/cache_dir.py``) against the JAX package's
``synthetic_mnist``, with ``XDG_CACHE_HOME`` under ``tmp_path``.

- A cold build writes the file, a warm load reads it back; both are
  byte-equal to JAX's set for the same seed.
- A corrupt file is regenerated; an unwritable cache directory still
  serves, from memory.
- The port keeps its own subdirectory: a file the JAX package wrote is
  never read.

The 10k test split keeps each build well under a second.
"""

from __future__ import annotations

import os

import numpy as np
import pytest

from pytorch_mnist_ddp_tpu.data.mnist import _SYNTH_VERSION as JAX_SYNTH_VERSION
from pytorch_mnist_ddp_tpu.data.mnist import synthetic_mnist as jax_synthetic_mnist
from pytorch_mnist_ddp_tpu.utils.cache_dir import cache_root as jax_cache_root
from pytorch_mnist_ddp_tpu_torch.data import mnist
from pytorch_mnist_ddp_tpu_torch.utils.cache_dir import cache_root


@pytest.fixture
def xdg(tmp_path, monkeypatch):
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    return tmp_path / "cache"


def _path(seed: int) -> str:
    return os.path.join(cache_root("torch", "synthetic"),
                        f"test-s{seed}-v{mnist._SYNTH_VERSION}.npz")


def _assert_jax_s(images, labels, seed):
    want_images, want_labels = jax_synthetic_mnist("test", seed=seed)
    assert images.dtype == want_images.dtype and labels.dtype == want_labels.dtype
    assert np.array_equal(images, want_images) and np.array_equal(labels, want_labels)


@pytest.mark.parametrize("seed", [1234, 7])
def test_cold_build_then_warm_load_are_jax_s_set(xdg, seed, monkeypatch):
    assert mnist._SYNTH_VERSION == JAX_SYNTH_VERSION == 2
    path = _path(seed)
    assert path.startswith(str(xdg)) and not os.path.exists(path)
    _assert_jax_s(*mnist._synthetic_cached("test", seed=seed), seed)
    assert os.path.exists(path)
    assert [n for n in os.listdir(os.path.dirname(path)) if ".tmp" in n] == []

    def no_build(*args, **kwargs):
        raise AssertionError("a warm load must not build the set")

    monkeypatch.setattr(mnist, "synthetic_mnist", no_build)
    _assert_jax_s(*mnist._synthetic_cached("test", seed=seed), seed)


def test_a_corrupt_file_is_regenerated(xdg):
    path = _path(1234)
    os.makedirs(os.path.dirname(path))
    with open(path, "wb") as f:
        f.write(b"not an npz")
    _assert_jax_s(*mnist._synthetic_cached("test"), 1234)
    with np.load(path) as z:  # rewritten whole
        assert z["images"].shape == (10000, 28, 28)


def test_a_wrong_shaped_file_is_regenerated(xdg):
    path = _path(1234)
    os.makedirs(os.path.dirname(path))
    np.savez(path, images=np.zeros((3, 28, 28), np.uint8), labels=np.zeros(3, np.uint8))
    _assert_jax_s(*mnist._synthetic_cached("test"), 1234)


def test_an_unwritable_cache_dir_serves_from_memory(tmp_path, monkeypatch):
    blocker = tmp_path / "a_file"
    blocker.write_text("")  # the cache root lies under a file: makedirs fails
    monkeypatch.setenv("XDG_CACHE_HOME", str(blocker))
    _assert_jax_s(*mnist._synthetic_cached("test"), 1234)
    assert blocker.read_text() == ""


def test_a_file_the_jax_package_wrote_is_never_read(xdg):
    jax_path = os.path.join(jax_cache_root("synthetic"), f"test-s1234-v{JAX_SYNTH_VERSION}.npz")
    os.makedirs(os.path.dirname(jax_path))
    np.savez(jax_path, images=np.full((10000, 28, 28), 9, np.uint8),
             labels=np.full(10000, 9, np.uint8))
    assert os.path.dirname(_path(1234)) != os.path.dirname(jax_path)
    assert cache_root() == jax_cache_root()  # one tree, two subdirectories
    _assert_jax_s(*mnist._synthetic_cached("test"), 1234)


def test_load_mnist_arrays_goes_through_the_cache(xdg, tmp_path, monkeypatch):
    monkeypatch.delenv("MNIST_DATA_DIR", raising=False)
    images, labels, source = mnist.load_mnist_arrays(str(tmp_path / "no_idx"), "test")
    assert source == "synthetic" and os.path.exists(_path(1234))
    _assert_jax_s(images, labels, 1234)
