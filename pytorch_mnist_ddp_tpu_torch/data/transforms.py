"""Input transforms (``transforms.Compose([ToTensor, Normalize])``).

``ToTensor()`` (uint8 -> float32 in [0, 1]) and ``Normalize((0.1307,),
(0.3081,))`` folded into one affine pass, with the serving input contract
kept channels-last: ``[n, 28, 28, 1]``.  Host numpy, so request decoding
never touches the device.
"""

from __future__ import annotations

import numpy as np

MNIST_MEAN = 0.1307
MNIST_STD = 0.3081
# The affine pass's f32 constants; the native gather (data/native.py) and
# the fused path's device gather (parallel/fused.py) take these same values.
SCALE = np.float32(1.0 / (255.0 * MNIST_STD))
SHIFT = np.float32(-MNIST_MEAN / MNIST_STD)


def normalize(images_u8: np.ndarray) -> np.ndarray:
    """uint8 ``[N,28,28]`` -> float32 ``[N,28,28,1]``, scaled to [0,1] then
    standardized with the MNIST mean/std in one affine pass (the f32
    product rounded, then the f32 sum)."""
    x = images_u8.astype(np.float32) * SCALE + SHIFT
    return x[..., None]
