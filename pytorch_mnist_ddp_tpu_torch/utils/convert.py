"""Weights carried across from the JAX reference layout to torch's.

The JAX package stores the CNN channels-last:

- conv kernels HWIO ``[kh, kw, in, out]`` (torch: OIHW ``[out, in, kh, kw]``);
- dense kernels ``[in, out]`` (torch: ``[out, in]``);
- fc1's 9216 input features in NHWC flatten order, feature
  ``h*768 + w*64 + c`` (torch flattens NCHW: ``c*144 + h*12 + w``).

So fc1's columns are permuted between the two, and a checkpoint crosses
only with that permutation applied.  This module holds the port's own
copy of the permutation; the JAX package applies the same one when it
writes a ``.pt``, which is why such a file loads here as it is.

The ViT's tree (``models/vit.py``) crosses by name alone: dense kernels
``[in, out]`` transpose to ``weight [out, in]``, LayerNorm ``scale`` is
``weight``, ``blocks/<i>`` is ``blocks.<i>``.  No feature is reordered:
the qkv projection is head-major in both packages.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

# Post-pool activation geometry: 12x12 spatial, 64 channels.
_POOL_H = _POOL_W = 12
_POOL_C = 64
_FLAT = _POOL_H * _POOL_W * _POOL_C

LAYERS = ("conv1", "conv2", "fc1", "fc2")


def nchw_to_nhwc_feature_perm() -> np.ndarray:
    """``perm[nchw_feature]`` = the NHWC flat index of the same (c, h, w)
    activation: maps a torch flatten position to the JAX one."""
    nhwc = np.arange(_FLAT).reshape(_POOL_H, _POOL_W, _POOL_C)
    return nhwc.transpose(2, 0, 1).reshape(-1)


def torch_state_from_jax(
    params: Mapping[str, Mapping[str, np.ndarray]],
) -> dict[str, torch.Tensor]:
    """JAX param tree ``{layer: {"kernel", "bias"}}`` -> torch state dict
    (``conv1.weight`` ...) in torch's native layout, fc1 columns in NCHW
    order.  Float32 CPU tensors, contiguous."""
    if "bn1" in params:
        raise ValueError(
            "BatchNorm checkpoints are not served by this port yet; serve a "
            "checkpoint without --syncbn"
        )
    perm = nchw_to_nhwc_feature_perm()
    out: dict[str, torch.Tensor] = {}
    for layer in LAYERS:
        if layer not in params:
            raise ValueError(f"param tree has no layer {layer!r}")
        kernel = np.asarray(params[layer]["kernel"], np.float32)
        if kernel.ndim == 4:  # HWIO -> OIHW
            weight = kernel.transpose(3, 2, 0, 1)
        else:  # [in, out] -> [out, in]
            weight = kernel.T
            if layer == "fc1":
                weight = weight[:, perm]
        # torch.tensor copies: the source arrays may be read-only views.
        out[f"{layer}.weight"] = torch.tensor(np.ascontiguousarray(weight))
        out[f"{layer}.bias"] = torch.tensor(
            np.asarray(params[layer]["bias"], np.float32)
        )
    return out


def torch_vit_state_from_jax(tree: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ViT param tree -> the port ``ViT``'s state dict (float32 CPU
    tensors, contiguous)."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value, f"{prefix}{name}.")
                continue
            a = np.asarray(value, np.float32)
            if name == "kernel":
                name, a = "weight", a.T
            elif name == "scale":
                name = "weight"
            # torch.tensor copies: the source arrays may be read-only views.
            out[prefix + name] = torch.tensor(np.ascontiguousarray(a))

    walk(tree, "")
    return out


def jax_vit_tree_from_torch(state: Mapping[str, torch.Tensor]) -> dict[str, Any]:
    """The inverse: a ``ViT`` state dict -> the JAX package's nested tree of
    float32 numpy arrays (``kernel [in, out]``, LayerNorm ``scale``)."""
    tree: dict[str, Any] = {}
    for key, value in state.items():
        *path, leaf = key.split(".")
        a = value.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            leaf, a = ("kernel", a.T) if a.ndim == 2 else ("scale", a)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(a)
    return tree
