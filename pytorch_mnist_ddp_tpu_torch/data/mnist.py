"""MNIST arrays: local IDX files, else the deterministic synthetic set.

1. If the four IDX files (raw or ``.gz``) exist under ``$MNIST_DATA_DIR``
   or ``root``, parse them (``data/native.py``'s parser where it is
   built).  Each file's raw bytes are checked against the canonical
   SHA-256 goldens, as the JAX package checks them: a set whose files all
   match is ``"idx"``; one that misses is still loaded, its digest printed
   on stderr, and labelled ``"idx-unverified"``, so that an accuracy says
   which task produced it.
2. Else, with ``allow_synthetic`` (the default), build the synthetic
   MNIST-like set: same shapes, dtypes and cardinality (60k/10k uint8
   28x28, 10 classes), learnable by the CNN, byte-identical to the JAX
   package's ``synthetic_mnist`` for the same arguments (numpy only).  A
   notice is printed once.  Without it a missing file raises.

The synthetic set is built once per (split, seed, generator version) and
kept as an npz under ``$XDG_CACHE_HOME|~/.cache/tpu_mnist_ddp/torch/
synthetic`` (``utils/cache_dir.py``): later processes load it instead of
building it, as the JAX package does with its own files (the port keeps
its own subdirectory and never reads theirs).  No download is tried, where
the JAX package tries the canonical mirrors first: the port runs on hosts
without a network.
"""

from __future__ import annotations

import gzip
import hashlib
import os
import struct
import sys

import numpy as np

_FILES = {
    ("train", "images"): "train-images-idx3-ubyte",
    ("train", "labels"): "train-labels-idx1-ubyte",
    ("test", "images"): "t10k-images-idx3-ubyte",
    ("test", "labels"): "t10k-labels-idx1-ubyte",
}

# Golden SHA-256 digests of the four raw (uncompressed) IDX files of the
# canonical MNIST distribution: the JAX package's, byte for byte.
_SHA256 = {
    "train-images-idx3-ubyte":
        "ba891046e6505d7aadcbbe25680a0738ad16aec93bde7f9b65e87a2fc25776db",
    "train-labels-idx1-ubyte":
        "65a50cbbf4e906d70832878ad85ccda5333a97f0f4c3dd2ef09a8a9eef7101c5",
    "t10k-images-idx3-ubyte":
        "1bf45877962fd391f7abb20534a30fd2203d0865309fec5f87d576dbdbefdcb1",
    "t10k-labels-idx1-ubyte":
        "b7e25cb63ef54da8d0fd3b0d8a38b9aaad06962e663b5d202cb1b7098e54aaf9",
}


def verify_idx_digest(filename: str, raw: bytes) -> bool:
    """True iff ``raw`` matches the golden SHA-256 for ``filename``.  On a
    mismatch both digests go to stderr, so that a wrong golden or a corrupt
    file can be told apart from the run's log alone."""
    golden = _SHA256.get(filename)
    digest = hashlib.sha256(raw).hexdigest()
    if digest == golden:
        return True
    print(
        f"warning: {filename} SHA-256 {digest} does not match golden "
        f"{golden}; loading anyway with provenance 'idx-unverified'",
        file=sys.stderr,
    )
    return False


_IMAGE_MAGIC = 2051
_LABEL_MAGIC = 2049

SYNTHETIC_NOTICE = (
    "MNIST IDX files unavailable (no local copy, download failed); using "
    "deterministic synthetic MNIST-like data"
)


def parse_idx(raw: bytes) -> np.ndarray:
    """Parse an IDX buffer (big-endian header): images ``[n, rows, cols]``
    or labels ``[n]``, uint8.  Raises ``ValueError`` on a bad magic, bad
    dimensions or a truncated payload.  The native parser
    (``data/native.py``) takes it where it is built, and its errors
    propagate; numpy's code below otherwise."""
    from . import native

    parsed = native.parse_idx_native(raw)
    if parsed is not None:
        return parsed
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


# Bump when synthetic_mnist's algorithm or defaults change, so stale disk
# caches regenerate instead of silently serving pre-change data.
_SYNTH_VERSION = 2


def _synthetic_cached(split: str, seed: int = 1234) -> tuple[np.ndarray, np.ndarray]:
    """Disk-cached synthetic dataset: generated once per (split, seed,
    generator version), then loaded from the npz on later runs (startup is
    part of the timed wall clock, as in the reference's mnist_ddp.py).  A
    corrupt file is regenerated; an unwritable cache directory serves from
    memory."""
    from ..utils.cache_dir import cache_root

    n = 60000 if split == "train" else 10000
    path = os.path.join(
        cache_root("torch", "synthetic"), f"{split}-s{seed}-v{_SYNTH_VERSION}.npz"
    )
    if os.path.exists(path):
        try:
            with np.load(path) as z:
                images, labels = z["images"], z["labels"]
            if images.shape == (n, 28, 28) and labels.shape == (n,):
                return images, labels
        except Exception:
            pass  # corrupt cache: regenerate below
    images, labels = synthetic_mnist(split, seed=seed)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".{os.getpid()}.tmp.npz"
        np.savez(tmp, images=images, labels=labels)
        os.replace(tmp, path)
    except OSError:
        pass  # read-only cache dir: serve from memory
    return images, labels


_synthetic_notice_printed = False


def load_mnist_arrays(
    root: str = "./data", split: str = "train", allow_synthetic: bool = True
) -> tuple[np.ndarray, np.ndarray, str]:
    """``(images uint8 [N, 28, 28], labels uint8 [N], source)`` for a
    split, ``source`` being ``"idx"``, ``"idx-unverified"`` (a file misses
    its golden digest) or ``"synthetic"``.  ``$MNIST_DATA_DIR`` overrides
    ``root``.  With a file missing, ``allow_synthetic=False`` raises
    ``FileNotFoundError`` naming it."""
    global _synthetic_notice_printed
    root = os.environ.get("MNIST_DATA_DIR", root)
    arrays = {}
    source = "idx"
    for kind in ("images", "labels"):
        filename = _FILES[(split, kind)]
        raw = _read_maybe_gz(os.path.join(root, filename))
        if raw is None:
            if not allow_synthetic:
                raise FileNotFoundError(
                    f"MNIST file {filename} not found in {root} (no download is tried)"
                )
            if not _synthetic_notice_printed:
                print(SYNTHETIC_NOTICE)
                _synthetic_notice_printed = True
            images, labels = _synthetic_cached(split)
            return images, labels, "synthetic"
        if not verify_idx_digest(filename, raw):
            source = "idx-unverified"
        arrays[kind] = parse_idx(raw)
    if len(arrays["images"]) != len(arrays["labels"]):
        raise ValueError("image/label count mismatch")
    return arrays["images"], arrays["labels"], source


class MNIST:
    """One split as raw uint8 arrays; the loader normalizes per batch."""

    def __init__(self, root: str = "./data", train: bool = True,
                 allow_synthetic: bool = True) -> None:
        self.images, self.labels, self.source = load_mnist_arrays(
            root, "train" if train else "test", allow_synthetic
        )

    def __len__(self) -> int:
        return len(self.images)
