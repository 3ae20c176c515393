"""The port's data layer against the JAX package's, on the CPU: IDX digest
provenance (``data/mnist.py``) and the native loader core
(``data/native.py``, ``pytorch_mnist_ddp_tpu_torch/csrc/fastloader.cpp``),
on the same numpy-seeded inputs.

- Provenance: fixture IDX files miss the canonical SHA-256 goldens, so
  both packages label them ``"idx-unverified"`` and print the same
  warning; with the goldens set to the fixtures' digests both read
  ``"idx"``; ``allow_synthetic=False`` raises in both.  The JAX package is
  always called with ``download=False``.
- The native core: twins of ``tests/test_native.py``, held tighter.  The
  port's gathers equal its numpy ``normalize`` and fancy indexing bit for
  bit (``np.array_equal``, dtype and strides), below and above the
  threaded 256 rows, where the JAX package's own test allows 1e-6 for its
  FMA-contracted core; its labels are int64.  Both packages' parsers
  reject the same bad headers, and both gathers check bounds as numpy
  does.  A port ``DataLoader`` epoch is the same with and without the
  library, at prefetch depths 0 and 2.  A JAX-built library named by
  the override is refused, a failed build raises with the compiler's
  message, and only a host without ``g++`` or a cached build gets numpy
  (announced once).

The library builds into ``XDG_CACHE_HOME`` under a temporary directory.
"""

from __future__ import annotations

import gzip
import hashlib
import os
import pathlib
import shutil
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu.data import mnist as jax_mnist
from pytorch_mnist_ddp_tpu.data import native as jax_native
from pytorch_mnist_ddp_tpu.data.transforms import MNIST_MEAN, MNIST_STD
from pytorch_mnist_ddp_tpu.data.transforms import normalize as jax_normalize
from pytorch_mnist_ddp_tpu_torch.data import mnist
from pytorch_mnist_ddp_tpu_torch.data import native
from pytorch_mnist_ddp_tpu_torch.data.loader import DataLoader
from pytorch_mnist_ddp_tpu_torch.data.transforms import normalize
from pytorch_mnist_ddp_tpu_torch.utils.cache_dir import cache_root

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]

BAD_HEADERS = [
    struct.pack(">ii", 2049, 100) + b"\0" * 10,            # truncated labels
    struct.pack(">iiii", 2051, 10, 28, 28) + b"\0" * 784,  # truncated images
    struct.pack(">ii", 2049, -1) + b"\0" * 10,             # negative count
    struct.pack(">iiii", 2051, -1, 28, 28) + b"\0" * 784,  # negative n
    struct.pack(">iiii", 2051, 5, 0, 28) + b"\0" * 784,    # zero rows
    struct.pack(">IIII", 2051, 0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF),  # overflow bait
    struct.pack(">i", 2051) + b"\0" * 6,                   # short image header
    b"\0\0",                                               # shorter than the magic
    struct.pack(">iI", 2049, 0x80000000) + b"\0" * 64,     # sign-bit count
    struct.pack(">i", 99) + b"\0" * 64,                    # unknown magic
]


def _fresh(monkeypatch):
    """The port's library state as before its first use."""
    monkeypatch.setattr(native, "_status", {"state": "unresolved", "path": None})
    monkeypatch.setattr(native, "_lib", None)


@pytest.fixture(scope="module")
def xdg(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        root = tmp_path_factory.mktemp("xdg")
        mp.setenv("XDG_CACHE_HOME", str(root))
        mp.delenv(native._LIB_ENV, raising=False)
        mp.setattr(native, "_status", {"state": "unresolved", "path": None})
        mp.setattr(native, "_lib", None)
        yield root


@pytest.fixture(scope="module")
def lib(xdg):
    got = native.get_lib()
    assert got is not None and native.status()["state"] == "loaded"
    return got


@pytest.fixture(scope="module")
def jax_lib(xdg):
    got = jax_native.get_lib()
    if got is None:
        pytest.skip("the JAX package's native library did not build")
    return got


def _idx_images(arr: np.ndarray) -> bytes:
    n, r, c = arr.shape
    return struct.pack(">iiii", 2051, n, r, c) + arr.tobytes()


def _idx_labels(arr: np.ndarray) -> bytes:
    return struct.pack(">ii", 2049, len(arr)) + arr.tobytes()


# ------------------------------------------------------------ provenance

def _write_split(root, split: str, n: int, seed: int, gz: bool = False) -> dict[str, bytes]:
    rng = np.random.RandomState(seed)
    blobs = {mnist._FILES[(split, "images")]: _idx_images(rng.randint(0, 256, (n, 28, 28),
                                                                        np.uint8)),
             mnist._FILES[(split, "labels")]: _idx_labels(rng.randint(0, 10, n).astype(np.uint8))}
    for name, blob in blobs.items():
        if gz:
            (root / (name + ".gz")).write_bytes(gzip.compress(blob))
        else:
            (root / name).write_bytes(blob)
    return blobs


@pytest.mark.parametrize("gz", [False, True], ids=["raw", "gz"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_idx_provenance_and_warning_match_jax(tmp_path, monkeypatch, capsys, train, gz):
    split = "train" if train else "test"
    blobs = _write_split(tmp_path, split, 12, 1 if train else 2, gz)
    monkeypatch.setenv("MNIST_DATA_DIR", str(tmp_path))
    port = mnist.MNIST(train=train)
    port_err = capsys.readouterr().err
    ref = jax_mnist.MNIST(train=train, download=False)
    jax_err = capsys.readouterr().err
    assert port.source == ref.source == "idx-unverified"
    assert np.array_equal(port.images, ref.images) and np.array_equal(port.labels, ref.labels)
    assert port_err == jax_err and port_err.count("SHA-256") == 2
    # The goldens set to the fixtures' (raw, uncompressed) digests: verified.
    goldens = {n: hashlib.sha256(b).hexdigest() for n, b in blobs.items()}
    monkeypatch.setattr(mnist, "_SHA256", goldens)
    monkeypatch.setattr(jax_mnist, "_SHA256", goldens)
    assert mnist.MNIST(train=train).source == jax_mnist.MNIST(train=train, download=False).source
    assert mnist.MNIST(train=train).source == "idx"
    assert capsys.readouterr().err == ""


def test_one_file_off_its_golden_unverifies_the_set(tmp_path, monkeypatch):
    blobs = _write_split(tmp_path, "train", 8, 3)
    goldens = {n: hashlib.sha256(b).hexdigest() for n, b in blobs.items()}
    goldens[mnist._FILES[("train", "labels")]] = "0" * 64
    monkeypatch.delenv("MNIST_DATA_DIR", raising=False)
    monkeypatch.setattr(mnist, "_SHA256", goldens)
    monkeypatch.setattr(jax_mnist, "_SHA256", goldens)
    port = mnist.load_mnist_arrays(str(tmp_path), "train")
    ref = jax_mnist.load_mnist_arrays(str(tmp_path), "train", download=False, return_source=True)
    assert port[2] == ref[2] == "idx-unverified"


def test_verify_idx_digest_matches_jax(capsys):
    raw = b"not an mnist file"
    for name in mnist._FILES.values():
        assert mnist.verify_idx_digest(name, raw) is jax_mnist.verify_idx_digest(name, raw) is False
    out = capsys.readouterr().err.splitlines()
    assert len(out) == 8 and out[0::2] == out[1::2]
    assert mnist._SHA256 == jax_mnist._SHA256


def test_allow_synthetic_false_raises_in_both(tmp_path, monkeypatch):
    monkeypatch.setenv("MNIST_DATA_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="train-images-idx3-ubyte"):
        mnist.MNIST(train=True, allow_synthetic=False)
    with pytest.raises(FileNotFoundError, match="train-images-idx3-ubyte"):
        jax_mnist.MNIST(train=True, download=False, allow_synthetic=False)
    _write_split(tmp_path, "test", 4, 4)
    (tmp_path / mnist._FILES[("test", "labels")]).unlink()
    with pytest.raises(FileNotFoundError, match="t10k-labels-idx1-ubyte"):
        mnist.MNIST(train=False, allow_synthetic=False)
    with pytest.raises(FileNotFoundError, match="t10k-labels-idx1-ubyte"):
        jax_mnist.MNIST(train=False, download=False, allow_synthetic=False)


# ------------------------------------------------------------ native core

@pytest.mark.parametrize("rows", [32, 1024], ids=["one_thread", "threaded"])
def test_gather_normalize_equals_numpy_bit_for_bit(lib, jax_lib, rows):
    rng = np.random.RandomState(rows)
    images = rng.randint(0, 256, (2000, 28, 28), np.uint8)
    idx = rng.randint(0, 2000, rows).astype(np.int32)
    ours = native.gather_normalize(images, idx)
    assert ours.shape == (rows, 28, 28) and ours.dtype == np.float32
    want = normalize(images[idx])
    assert np.array_equal(ours[..., None], want)
    assert ours[..., None].strides == want.strides
    assert np.array_equal(want, jax_normalize(images[idx]))
    # The JAX package's core is held to its own test's gate (FMA bits).
    theirs = jax_native.gather_normalize(images, idx, MNIST_MEAN, MNIST_STD)
    np.testing.assert_allclose(ours[..., None], theirs, rtol=1e-6, atol=1e-7)


def test_every_byte_value_normalizes_as_numpy(lib):
    """All 256 pixel values through the native affine pass, single and
    threaded: the product and the sum rounded apart, as numpy does."""
    images = np.tile(np.arange(256, dtype=np.uint8), 784 * 300 // 256 + 1)[:784 * 300]
    images = images.reshape(300, 28, 28)
    for idx in (np.arange(8), np.arange(300)):
        assert np.array_equal(native.gather_normalize(images, idx)[..., None],
                              normalize(images[idx]))


def test_gather_labels_int64_as_jax_values(lib, jax_lib):
    labels = np.arange(50, dtype=np.uint8) % 10
    idx = np.array([0, 49, 13, 13, -1], np.int32)
    out = native.gather_labels(labels, idx)
    assert out.dtype == np.int64
    assert np.array_equal(out, labels.astype(np.int64)[idx])
    assert np.array_equal(out, jax_native.gather_labels(labels, idx))


def test_native_idx_parse_matches_both_python_parsers(lib, monkeypatch):
    imgs = np.random.RandomState(2).randint(0, 256, (7, 28, 28), np.uint8)
    labels = np.array([1, 2, 3], np.uint8)
    for raw, want in ((_idx_images(imgs), imgs), (_idx_labels(labels), labels)):
        before = native.CALLS["parse_idx"]
        parsed = mnist.parse_idx(raw)
        assert native.CALLS["parse_idx"] == before + 1
        assert np.array_equal(parsed, want) and parsed.dtype == np.uint8
        assert np.array_equal(parsed, jax_mnist.parse_idx(raw))
        with monkeypatch.context() as m:
            m.setattr(native, "parse_idx_native", lambda raw: None)
            assert np.array_equal(mnist.parse_idx(raw), want)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("raw", BAD_HEADERS, ids=[f"bad{i}" for i in range(len(BAD_HEADERS))])
def test_bad_headers_raise_in_both_packages(lib, monkeypatch, raw, use_native):
    if not use_native:
        monkeypatch.setattr(native, "parse_idx_native", lambda raw: None)
        monkeypatch.setattr(jax_native, "parse_idx_native", lambda raw: None)
    with pytest.raises(ValueError):
        mnist.parse_idx(raw)
    with pytest.raises(ValueError):
        jax_mnist.parse_idx(raw)


def test_gather_bounds_checked_as_numpy_and_jax(lib, jax_lib):
    images = np.arange(4 * 28 * 28, dtype=np.uint8).reshape(4, 28, 28)
    labels = np.array([7, 8, 9, 5], np.uint8)
    bad = [np.array([0, 4], np.int32), np.array([-5], np.int32),
           np.array([2 ** 32], np.int64), np.array([2 ** 32 + 1], np.int64)]
    for idx in bad:
        for gather, args in ((native.gather_normalize, (images, idx)),
                             (native.gather_labels, (labels, idx))):
            with pytest.raises(IndexError) as ours:
                gather(*args)
            with pytest.raises(IndexError) as numpy_says:
                args[0][idx]
            assert str(ours.value) == str(numpy_says.value)
        with pytest.raises(IndexError) as theirs:
            jax_native.gather_labels(labels, idx)
        with pytest.raises(IndexError) as ours:
            native.gather_labels(labels, idx)
        assert str(ours.value) == str(theirs.value)
    wrap = np.array([-1, 0, -4], np.int32)
    assert np.array_equal(native.gather_normalize(images, wrap)[..., None], normalize(images[wrap]))
    assert np.array_equal(native.gather_labels(labels, wrap), labels[wrap].astype(np.int64))


@pytest.mark.parametrize("case", ["non_uint8", "non_contiguous"])
def test_other_inputs_are_left_to_numpy(lib, case):
    images = (np.zeros((4, 28, 28), np.float32) if case == "non_uint8"
              else np.zeros((8, 28, 28), np.uint8)[::2])
    labels = np.zeros(8, np.int64) if case == "non_uint8" else np.zeros(16, np.uint8)[::2]
    idx = np.zeros(2, np.int32)
    assert native.gather_normalize(images, idx) is None
    assert native.gather_labels(labels, idx) is None
    assert jax_native.gather_normalize(images, idx, MNIST_MEAN, MNIST_STD) is None
    assert jax_native.gather_labels(labels, idx) is None


def _epoch(images, labels, depth, **kw):
    loader = DataLoader(images, labels, 16, torch.device("cpu"), seed=5, prefetch_depth=depth,
                        **kw)
    return [tuple(t.numpy() for t in batch) for batch in loader.epoch(3)]


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("kw", [{}, {"world_size": 2, "rank": 1, "mask_padding": True},
                                {"num_shards": 2, "shard": 1}],
                         ids=["one_rank", "rank_1_of_2", "shard_1_of_2"])
def test_loader_epoch_is_the_same_without_the_library(lib, monkeypatch, depth, kw):
    rng = np.random.RandomState(3)
    images = rng.randint(0, 256, (70, 28, 28), np.uint8)
    labels = rng.randint(0, 10, 70).astype(np.uint8)
    before = dict(native.CALLS)
    with_native = _epoch(images, labels, depth, **kw)
    assert native.CALLS["gather_normalize"] - before["gather_normalize"] == len(with_native)
    assert native.CALLS["gather_labels"] - before["gather_labels"] == len(with_native)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    without = _epoch(images, labels, depth, **kw)
    assert len(with_native) == len(without) > 1
    for a, b in zip(with_native, without, strict=True):
        for x, y in zip(a, b, strict=True):
            assert x.dtype == y.dtype and x.strides == y.strides and np.array_equal(x, y)
    assert with_native[-1][0].shape == (16, 28, 28, 1) and with_native[-1][1].dtype == np.int64


def test_a_jax_built_library_is_refused(xdg, tmp_path, monkeypatch):
    """The JAX package's libfastloader has the same C signatures with other
    semantics (mean/std, int32 labels): the override must not load it."""
    so = tmp_path / "libfastloader.so"
    subprocess.run(["g++", *jax_native._CFLAGS, "-o", str(so), jax_native._SRC, "-lpthread"],
                   check=True, capture_output=True)
    _fresh(monkeypatch)
    monkeypatch.setenv(native._LIB_ENV, str(so))
    with pytest.raises(RuntimeError, match="not the port's native data loader"):
        native.get_lib()
    with pytest.raises(RuntimeError, match="not the port's native data loader"):
        native.gather_normalize(np.zeros((2, 28, 28), np.uint8), np.zeros(1, np.int32))
    monkeypatch.setenv(native._LIB_ENV, str(tmp_path / "missing.so"))
    with pytest.raises(FileNotFoundError, match="missing.so"):
        native.get_lib()


def test_the_override_loads_a_port_library(lib, monkeypatch):
    path = native.status()["path"]
    _fresh(monkeypatch)
    monkeypatch.setenv(native._LIB_ENV, path)
    assert native.get_lib() is not None and native.status() == {"state": "loaded", "path": path}


def test_a_failed_build_raises_with_the_compiler_message(xdg, tmp_path, monkeypatch):
    src = tmp_path / "fastloader.cpp"
    src.write_text("this is not C++\n")
    _fresh(monkeypatch)
    monkeypatch.setattr(native, "_SRC", src)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed building fastloader.cpp") as err:
        native.get_lib()
    assert "error" in str(err.value)
    assert native.status()["state"] == "unresolved"


def test_a_cached_library_loads_without_a_compiler(lib, monkeypatch):
    path = native.status()["path"]
    _fresh(monkeypatch)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    assert native.get_lib() is not None and native.status() == {"state": "loaded", "path": path}


def test_no_compiler_means_numpy_announced_once(tmp_path, monkeypatch, capsys):
    _fresh(monkeypatch)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))  # nothing cached there
    monkeypatch.delenv(native._LIB_ENV, raising=False)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    images = np.random.RandomState(4).randint(0, 256, (5, 28, 28), np.uint8)
    assert native.gather_normalize(images, np.arange(3)) is None
    assert native.parse_idx_native(_idx_labels(np.zeros(2, np.uint8))) is None
    assert native.status() == {"state": "numpy", "path": None}
    assert capsys.readouterr().err.splitlines() == [native.NUMPY_NOTICE]
    loader = DataLoader(images, np.zeros(5, np.uint8), 8, torch.device("cpu"), shuffle=False,
                        prefetch_depth=0)
    (x, y, w), = loader.epoch(0)
    assert np.array_equal(x.numpy()[:5], normalize(images)) and y.dtype == torch.int64
    assert capsys.readouterr().err == ""  # announced once, not once a batch


def test_first_use_from_many_threads_builds_once_and_counts_every_call(tmp_path, monkeypatch):
    """More threads than cores race to the first use: one build under the
    native.build lock, and no call lost from the counts."""
    _fresh(monkeypatch)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    builds = []
    real_run = subprocess.run

    def counted_run(cmd, *args, **kwargs):
        builds.append(cmd)
        return real_run(cmd, *args, **kwargs)

    monkeypatch.setattr(native.subprocess, "run", counted_run)
    labels = np.arange(40, dtype=np.uint8) % 10
    idx = np.arange(40)[::-1]
    before = native.CALLS["gather_labels"]
    errors, n_threads, calls = [], 2 * (os.cpu_count() or 4), 50

    def worker():
        try:
            for _ in range(calls):
                assert np.array_equal(native.gather_labels(labels, idx), labels[idx])
        except Exception as e:  # recorded and asserted below
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads) and not errors
    assert len(builds) == 1
    assert native.CALLS["gather_labels"] - before == n_threads * calls


def test_two_processes_building_at_once_both_load(tmp_path):
    """Two processes (as two test workers or two ranks) build into one
    cache at once: each writes its own temporary file and renames it, and
    both load a whole library."""
    code = ("import numpy as np\n"
            "from pytorch_mnist_ddp_tpu_torch.data import native\n"
            "x = native.gather_normalize(np.zeros((3, 28, 28), np.uint8), np.arange(3))\n"
            "assert x is not None and native.status()['state'] == 'loaded'\n")
    env = {**os.environ, "XDG_CACHE_HOME": str(tmp_path), "PYTHONPATH": str(ROOT)}
    env.pop(native._LIB_ENV, None)
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    built = list((tmp_path / "tpu_mnist_ddp" / "torch" / "native").iterdir())
    assert len(built) == 1 and built[0].name.endswith(".so")


def test_first_build_under_the_lock_tracer(tmp_path):
    """Under JAXLINT_LOCKWATCH=1 the build lock is traced at its site, the
    first use acquires it once, and the order stays acyclic."""
    code = ("import numpy as np\n"
            "from pytorch_mnist_ddp_tpu_torch.analysis import lockwatch\n"
            "from pytorch_mnist_ddp_tpu_torch.data import native\n"
            "assert type(native._build_lock).__name__ == 'TracedLock'\n"
            "for _ in range(3):\n"
            "    assert native.gather_labels(np.zeros(4, np.uint8), np.arange(4)) is not None\n"
            "assert lockwatch.watch().counts().get('native.build') == 1, lockwatch.watch().counts()\n"
            "lockwatch.assert_acyclic()\n")
    env = {**os.environ, "XDG_CACHE_HOME": str(tmp_path), "PYTHONPATH": str(ROOT),
           "JAXLINT_LOCKWATCH": "1"}
    env.pop(native._LIB_ENV, None)
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_library_lives_in_the_ports_own_cache(lib, xdg):
    path = native.status()["path"]
    assert path.startswith(cache_root("torch", "native") + "/")
    assert native._cpu_tag() in path and "libtmnist_fastloader-" in path
    assert "-ffp-contract=off" in native._CFLAGS and "-ffast-math" not in native._CFLAGS
