"""MNIST arrays: local IDX files, else the deterministic synthetic set.

1. If the four IDX files (raw or ``.gz``) exist under ``$MNIST_DATA_DIR``
   or ``root``, parse them.
2. Else build the synthetic MNIST-like set: same shapes, dtypes and
   cardinality (60k/10k uint8 28x28, 10 classes), learnable by the CNN,
   byte-identical to the JAX package's ``synthetic_mnist`` for the same
   arguments (numpy only).  A notice is printed once.

Neither download nor a disk cache of the synthetic set is kept: the port
runs on hosts without a network, and the set builds in seconds.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

_FILES = {
    ("train", "images"): "train-images-idx3-ubyte",
    ("train", "labels"): "train-labels-idx1-ubyte",
    ("test", "images"): "t10k-images-idx3-ubyte",
    ("test", "labels"): "t10k-labels-idx1-ubyte",
}

_IMAGE_MAGIC = 2051
_LABEL_MAGIC = 2049

SYNTHETIC_NOTICE = (
    "MNIST IDX files unavailable (no local copy, download failed); using "
    "deterministic synthetic MNIST-like data"
)


def parse_idx(raw: bytes) -> np.ndarray:
    """Parse an IDX buffer (big-endian header): images ``[n, rows, cols]``
    or labels ``[n]``, uint8.  Raises ``ValueError`` on a bad magic, bad
    dimensions or a truncated payload."""
    if len(raw) < 8:
        raise ValueError("truncated IDX header")
    magic, = struct.unpack(">i", raw[:4])
    if magic == _IMAGE_MAGIC:
        if len(raw) < 16:
            raise ValueError("truncated IDX image header")
        n, rows, cols = struct.unpack(">iii", raw[4:16])
        if n < 0 or rows <= 0 or cols <= 0:
            raise ValueError(f"invalid IDX image dims ({n}, {rows}, {cols})")
        data = np.frombuffer(raw, dtype=np.uint8, offset=16)
        if len(data) < n * rows * cols:
            raise ValueError("truncated IDX image payload")
        return data[: n * rows * cols].reshape(n, rows, cols)
    if magic == _LABEL_MAGIC:
        n, = struct.unpack(">i", raw[4:8])
        if n < 0:
            raise ValueError(f"invalid IDX label count ({n})")
        data = np.frombuffer(raw, dtype=np.uint8, offset=8)
        if len(data) < n:
            raise ValueError("truncated IDX label payload")
        return data[:n]
    raise ValueError(f"not an MNIST IDX buffer (magic={magic})")


def _read_maybe_gz(path: str) -> bytes | None:
    for candidate, opener in ((path, open), (path + ".gz", gzip.open)):
        if os.path.exists(candidate):
            with opener(candidate, "rb") as f:
                return f.read()
    return None


# Generator constants of the JAX package's synthetic set (version 2).  They
# define the data, so they change only together with the reference's.
_N_COARSE = 5      # coarse fields shared by class pairs (c and c+5)
_N_MODES = 10      # intra-class modes
_FINE_AMP = 0.7    # per-class fine detail: the pair discriminator
_MODE_AMP = 0.45   # mode-distortion amplitude
_NOISE = 0.18      # per-pixel Gaussian noise
_SHIFT = 4         # max |shift| in px, each axis
_CONTRAST = 0.25   # multiplicative gain jitter half-range
_FLIP = 0.004      # label-flip rate (caps attainable accuracy)


def synthetic_mnist(
    split: str, n: int | None = None, seed: int = 1234
) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic MNIST-shaped ``(images uint8 [n, 28, 28], labels uint8
    [n])``.  Class identity rides a coarse field shared by class pairs plus
    a per-class fine field; shared distortion modes, shifts of up to
    ±4 px, contrast jitter, pixel noise and 0.4% flipped labels make it
    non-saturating.  Train and test share the template stream and draw
    samples from disjoint streams."""
    if n is None:
        n = 60000 if split == "train" else 10000
    num_classes = 10
    rng = np.random.RandomState(seed)  # template stream: shared across splits

    def smooth(t: np.ndarray, passes: int) -> np.ndarray:
        for _ in range(passes):  # box blur by rolls
            t = (
                t
                + np.roll(t, 1, -2) + np.roll(t, -1, -2)
                + np.roll(t, 1, -1) + np.roll(t, -1, -1)
            ) / 5.0
        return t

    # 36x36 canvases, so a shifted 28x28 crop stays inside (origin 4).
    coarse = smooth(np.kron(rng.normal(size=(_N_COARSE, 6, 6)), np.ones((6, 6))), 2)
    fine = smooth(np.kron(rng.normal(size=(num_classes, 18, 18)), np.ones((2, 2))), 1)
    modes = smooth(np.kron(rng.normal(size=(_N_MODES, 9, 9)), np.ones((4, 4))), 2)

    templates = np.empty((num_classes, _N_MODES, 36, 36), dtype=np.float32)
    for c in range(num_classes):
        for m in range(_N_MODES):
            t = coarse[c % _N_COARSE] + _FINE_AMP * fine[c] + _MODE_AMP * modes[m]
            templates[c, m] = (t - t.min()) / (np.ptp(t) + 1e-8)

    sample_rng = np.random.RandomState(seed + (1 if split == "train" else 2))
    labels = sample_rng.randint(0, num_classes, size=n).astype(np.uint8)
    mode_ix = sample_rng.randint(0, _N_MODES, size=n)
    shifts = sample_rng.randint(-_SHIFT, _SHIFT + 1, size=(n, 2))
    gain = 1.0 + sample_rng.uniform(
        -_CONTRAST, _CONTRAST, size=(n, 1, 1)
    ).astype(np.float32)
    noise = sample_rng.normal(0.0, _NOISE, size=(n, 28, 28)).astype(np.float32)

    base = 4
    rows = (base + shifts[:, 0])[:, None] + np.arange(28)[None, :]
    cols = (base + shifts[:, 1])[:, None] + np.arange(28)[None, :]
    gathered = templates[
        labels[:, None, None], mode_ix[:, None, None],
        rows[:, :, None], cols[:, None, :],
    ]
    images = np.clip(gathered * gain + noise, 0.0, 1.0)
    images = (images * 255).astype(np.uint8)

    flips = sample_rng.rand(n) < _FLIP
    offsets = sample_rng.randint(1, num_classes, size=n)
    labels = np.where(flips, (labels + offsets) % num_classes, labels).astype(np.uint8)
    return images, labels


_synthetic_notice_printed = False


def load_mnist_arrays(
    root: str = "./data", split: str = "train"
) -> tuple[np.ndarray, np.ndarray, str]:
    """``(images uint8 [N, 28, 28], labels uint8 [N], source)`` for a
    split, ``source`` being ``"idx"`` or ``"synthetic"``.  ``$MNIST_DATA_DIR``
    overrides ``root``."""
    global _synthetic_notice_printed
    root = os.environ.get("MNIST_DATA_DIR", root)
    arrays = {}
    for kind in ("images", "labels"):
        raw = _read_maybe_gz(os.path.join(root, _FILES[(split, kind)]))
        if raw is None:
            if not _synthetic_notice_printed:
                print(SYNTHETIC_NOTICE)
                _synthetic_notice_printed = True
            images, labels = synthetic_mnist(split)
            return images, labels, "synthetic"
        arrays[kind] = parse_idx(raw)
    if len(arrays["images"]) != len(arrays["labels"]):
        raise ValueError("image/label count mismatch")
    return arrays["images"], arrays["labels"], "idx"


class MNIST:
    """One split as raw uint8 arrays; the loader normalizes per batch."""

    def __init__(self, root: str = "./data", train: bool = True) -> None:
        self.images, self.labels, self.source = load_mnist_arrays(
            root, "train" if train else "test"
        )

    def __len__(self) -> int:
        return len(self.images)
