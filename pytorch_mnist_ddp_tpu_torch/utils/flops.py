"""Analytic FLOPs of the reference CNN and the ViT, the port's copy of the
JAX package's ``utils/flops.py`` (the same functions, the same integers
for the same configurations).

Counts matmul/conv multiply-accumulates only (2 FLOPs per MAC), the work
that MFU conventionally measures.  Elementwise ops (relu, dropout,
log_softmax, BN affine, LayerNorm, GELU, softmax) and the optimizer
update are excluded.  A training step is 3x the forward (forward, grad
wrt weights, grad wrt activations); this overcounts conv1's dead
grad-wrt-input slightly, so the derived MFU is conservative-high by
~0.4% for the CNN.

CNN shapes (``models/net.py``): 28x28x1 input, conv1 3x3 VALID ->
26x26x32, conv2 3x3 VALID -> 24x24x64, maxpool -> 9216, fc1 -> 128,
fc2 -> 10.

:func:`gpu_peak_flops` takes the place of JAX's
``tpu_peak_flops_per_chip``: the dense peak of a card by its
``torch.cuda.get_device_name`` and the run's dtype, None for a card it
does not know.
"""

from __future__ import annotations

# (out_h, out_w, out_c, kernel_macs_per_output) for each conv; (in, out)
# for each dense layer.
_CONVS = (
    (26, 26, 32, 3 * 3 * 1),
    (24, 24, 64, 3 * 3 * 32),
)
_DENSES = (
    (9216, 128),
    (128, 10),
)

# Published dense peaks (TFLOP/s, no sparsity) by a substring of the
# card's name (lowercased): the H100 SXM's data sheet, at its 700 W limit
# (its name is "NVIDIA H100 80GB HBM3"; the PCIe and NVL parts have other
# peaks and are not listed).  float32 is the rate outside the tensor
# cores: TF32 is off on every training path of the port.
_H100_SXM = {"float32": 67.0, "bfloat16": 989.0}
_PEAK_TFLOPS = (
    ("h100 80gb hbm3", _H100_SXM),
    ("h100 sxm", _H100_SXM),
)


def forward_flops_per_sample() -> int:
    """Matmul/conv FLOPs for one sample's CNN forward pass (~24 MFLOPs)."""
    total = 0
    for h, w, c, macs in _CONVS:
        total += 2 * h * w * c * macs
    for fan_in, fan_out in _DENSES:
        total += 2 * fan_in * fan_out
    return total


def train_step_flops_per_sample() -> int:
    """Forward + backward (3x forward, see module docstring)."""
    return 3 * forward_flops_per_sample()


def run_flops(train_samples: int, test_samples: int, epochs: int) -> int:
    """Total CNN FLOPs of a run: ``epochs`` passes of training over
    ``train_samples`` plus one eval forward pass over ``test_samples``
    an epoch."""
    per_epoch = (
        train_samples * train_step_flops_per_sample()
        + test_samples * forward_flops_per_sample()
    )
    return epochs * per_epoch


def vit_forward_flops_per_sample(cfg) -> int:
    """Matmul FLOPs for one sample's ViT forward pass (``models/vit.py``).
    ``cfg`` is duck-typed to ``ViTConfig`` (grid, patch_dim, dim, depth,
    mlp_dim, num_classes): patch embed, per block qkv, scores, values,
    proj and the MLP, the classifier head.  The MoE variant routes each
    token through one expert, so this is also its count at capacity."""
    t = cfg.grid * cfg.grid
    d = cfg.dim
    per_block = (
        3 * t * d * d      # qkv projections
        + t * t * d        # attention scores  q @ k^T
        + t * t * d        # attention output  p @ v
        + t * d * d        # output projection
        + t * d * cfg.mlp_dim + t * cfg.mlp_dim * d  # MLP in/out
    )
    total = (
        t * cfg.patch_dim * d          # patch embedding
        + cfg.depth * per_block
        + d * cfg.num_classes          # classifier head (pooled token)
    )
    return 2 * total


def vit_train_step_flops_per_sample(cfg) -> int:
    """Forward + backward (3x forward, as for the CNN)."""
    return 3 * vit_forward_flops_per_sample(cfg)


def vit_run_flops(cfg, train_samples: int, test_samples: int, epochs: int) -> int:
    """Total ViT FLOPs of a run: ``epochs`` passes of training over
    ``train_samples`` plus one eval forward pass over ``test_samples`` an
    epoch (the fused run's structure)."""
    per_epoch = (
        train_samples * vit_train_step_flops_per_sample(cfg)
        + test_samples * vit_forward_flops_per_sample(cfg)
    )
    return epochs * per_epoch


def gpu_peak_flops(device_name: str, dtype: str = "float32") -> float | None:
    """Dense peak FLOP/s of the card ``device_name`` in ``dtype``
    (``"float32"`` or ``"bfloat16"``), or None for a card or dtype this
    table does not know."""
    name = device_name.lower()
    for substr, peaks in _PEAK_TFLOPS:
        if substr in name:
            tflops = peaks.get(dtype)
            return None if tflops is None else tflops * 1e12
    return None
