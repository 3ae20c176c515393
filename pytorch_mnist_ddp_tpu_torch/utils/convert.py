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

Adadelta is elementwise, so each accumulator crosses exactly as its
parameter does: a per-leaf accumulator tree converts with the parameter
converters.  The JAX package's ``--pallas-opt`` accumulators are one
``[rows, 128]`` f32 buffer, ``ravel_pytree`` of the tree (sorted keys, so
``conv1.bias`` before ``conv1.kernel``, JAX layouts) zero-padded to
``_pad_rows``' rows; the port's are one unpadded buffer in
``named_parameters`` order (weight before bias, torch layouts).
:func:`torch_flat_from_jax` and :func:`jax_flat_from_torch` map between
the two: drop or restore the pad, split by leaf, convert each leaf,
concatenate in the other order.

BatchNorm layers (``--syncbn``: ``bn1``, ``bn2``) cross by name: flax's
``scale`` is torch's ``weight``; vectors need no layout change.  They sit
after their conv in ``named_parameters`` order and first in the sorted
JAX order.

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
BN_LAYERS = {"bn1": 32, "bn2": 64}  # --syncbn's, with their channel counts
# The CNN's parameters in named_parameters order, torch shapes.
TORCH_SHAPES = {
    "conv1.weight": (32, 1, 3, 3), "conv1.bias": (32,),
    "conv2.weight": (64, 32, 3, 3), "conv2.bias": (64,),
    "fc1.weight": (128, _FLAT), "fc1.bias": (128,),
    "fc2.weight": (10, 128), "fc2.bias": (10,),
}


def torch_shapes(use_bn: bool = False) -> dict[str, tuple[int, ...]]:
    """The CNN's parameters in ``named_parameters`` order, torch shapes;
    with ``use_bn`` each BatchNorm's weight and bias follow its conv."""
    if not use_bn:
        return dict(TORCH_SHAPES)
    out: dict[str, tuple[int, ...]] = {}
    for name, shape in TORCH_SHAPES.items():
        out[name] = shape
        if name in ("conv1.bias", "conv2.bias"):
            bn = "bn" + name[4]
            out[f"{bn}.weight"] = out[f"{bn}.bias"] = (BN_LAYERS[bn],)
    return out


def has_bn(names) -> bool:
    """Whether any key names a BatchNorm layer (``bn1.weight``, ``bn2``...)."""
    return any(str(k).split(".")[0].startswith("bn") for k in names)
# The JAX package's flat-accumulator tiling (ops/pallas_adadelta.py).
_LANES = 128
_BLOCK_ROWS = 256


def nchw_to_nhwc_feature_perm() -> np.ndarray:
    """``perm[nchw_feature]`` = the NHWC flat index of the same (c, h, w)
    activation: maps a torch flatten position to the JAX one."""
    nhwc = np.arange(_FLAT).reshape(_POOL_H, _POOL_W, _POOL_C)
    return nhwc.transpose(2, 0, 1).reshape(-1)


def pad_rows(n: int) -> tuple[int, int]:
    """The JAX package's ``_pad_rows``: rows of ``_LANES`` after lane
    packing, and the block height.  Small tensors use one sublane-aligned
    block; large ones tile in ``_BLOCK_ROWS`` chunks."""
    rows = -(-n // _LANES)
    if rows <= _BLOCK_ROWS:
        rows = -(-rows // 8) * 8
        return rows, rows
    return -(-rows // _BLOCK_ROWS) * _BLOCK_ROWS, _BLOCK_ROWS


def _jax_shape(shape: tuple[int, ...]) -> tuple[int, ...]:
    """The JAX leaf shape of a torch parameter's: OIHW -> HWIO, [out, in]
    -> [in, out]."""
    if len(shape) == 4:
        return shape[2], shape[3], shape[1], shape[0]
    return shape[::-1]


def _jax_leaves(use_bn: bool = False) -> list[tuple[str, str, tuple[int, ...]]]:
    """``(layer, leaf, JAX shape)`` in ``ravel_pytree`` order: sorted
    layers, and ``bias`` before ``kernel``/``scale`` within each."""
    shapes = torch_shapes(use_bn)
    layers = sorted({name.split(".")[0] for name in shapes})
    return [(layer, leaf, _jax_shape(shapes[f"{layer}.{'bias' if leaf == 'bias' else 'weight'}"]))
            for layer in layers
            for leaf in ("bias", "scale" if layer in BN_LAYERS else "kernel")]


def torch_state_from_jax(
    params: Mapping[str, Mapping[str, np.ndarray]],
) -> dict[str, torch.Tensor]:
    """JAX param tree ``{layer: {"kernel", "bias"}}`` -> torch state dict
    (``conv1.weight`` ...) in torch's native layout, fc1 columns in NCHW
    order, in ``named_parameters`` order; BatchNorm layers (``{"scale",
    "bias"}``) become ``bnN.weight``/``bnN.bias``.  Float32 CPU tensors,
    contiguous."""
    perm = nchw_to_nhwc_feature_perm()
    out: dict[str, torch.Tensor] = {}
    for name in torch_shapes(has_bn(params)):
        layer, leaf = name.split(".")
        if layer not in params:
            raise ValueError(f"param tree has no layer {layer!r}")
        if leaf == "bias":
            a = np.asarray(params[layer]["bias"], np.float32)
        elif layer in BN_LAYERS:
            a = np.asarray(params[layer]["scale"], np.float32)
        else:
            a = np.asarray(params[layer]["kernel"], np.float32)
            if a.ndim == 4:  # HWIO -> OIHW
                a = a.transpose(3, 2, 0, 1)
            else:  # [in, out] -> [out, in]
                a = a.T
                if layer == "fc1":
                    a = a[:, perm]
        # torch.tensor copies: the source arrays may be read-only views.
        out[name] = torch.tensor(np.ascontiguousarray(a))
    return out


def jax_state_from_torch(
    state: Mapping[str, torch.Tensor],
) -> dict[str, dict[str, np.ndarray]]:
    """The inverse of :func:`torch_state_from_jax`: a CNN state dict in
    torch layout -> the JAX param tree ``{layer: {"bias", "kernel"}}`` of
    contiguous float32 numpy arrays (HWIO convs, ``[in, out]`` dense, fc1's
    rows in NHWC feature order; ``{"bias", "scale"}`` for BatchNorm), keys
    in sorted order as the JAX package's trees come out of a training
    step.  Keys other than parameters (running statistics) are ignored."""
    inv = np.argsort(nchw_to_nhwc_feature_perm())
    tree: dict[str, dict[str, np.ndarray]] = {}
    for layer, leaf, _ in _jax_leaves(has_bn(state)):
        a = state[f"{layer}.{'bias' if leaf == 'bias' else 'weight'}"]
        a = a.detach().to("cpu", torch.float32).numpy()
        if leaf == "kernel":
            if a.ndim == 4:  # OIHW -> HWIO
                a = a.transpose(2, 3, 1, 0)
            else:
                if layer == "fc1":
                    a = a[:, inv]
                a = a.T  # [out, in] -> [in, out]
        tree.setdefault(layer, {})[leaf] = np.ascontiguousarray(a)
    return tree


def torch_flat_from_jax(buf: np.ndarray, use_bn: bool = False) -> torch.Tensor:
    """A JAX ``--pallas-opt`` accumulator (``[rows, 128]``, or its ravel)
    -> the port's flat accumulator: 1-D float32, unpadded,
    ``named_parameters`` order, torch layouts.  ``use_bn``: the model has
    ``--syncbn``'s BatchNorm layers (the padded size does not tell)."""
    flat = np.asarray(buf, np.float32).reshape(-1)
    tree: dict[str, dict[str, np.ndarray]] = {}
    off = 0
    for layer, leaf, shape in _jax_leaves(use_bn):
        size = int(np.prod(shape))
        tree.setdefault(layer, {})[leaf] = flat[off:off + size].reshape(shape)
        off += size
    rows, _ = pad_rows(off)
    if flat.size != rows * _LANES:
        raise ValueError(
            f"flat accumulator has {flat.size} elements; the CNN's "
            f"{off} parameters pad to {rows} x {_LANES}")
    state = torch_state_from_jax(tree)
    return torch.cat([state[name].reshape(-1) for name in torch_shapes(use_bn)])


def jax_flat_from_torch(flat: torch.Tensor, use_bn: bool = False) -> np.ndarray:
    """The inverse of :func:`torch_flat_from_jax`: the port's flat
    accumulator -> the JAX package's ``[rows, 128]`` float32 buffer, zeros
    in the pad as JAX's state holds there."""
    shapes = torch_shapes(use_bn)
    flat = flat.detach().to("cpu", torch.float32).reshape(-1)
    sizes = [int(np.prod(s)) for s in shapes.values()]
    n = sum(sizes)
    if flat.numel() != n:
        raise ValueError(f"flat accumulator has {flat.numel()} elements, the CNN {n}")
    state = {k: v.view(shapes[k]) for k, v in zip(shapes, flat.split(sizes))}
    tree = jax_state_from_torch(state)
    rows, _ = pad_rows(n)
    out = np.zeros(rows * _LANES, np.float32)
    out[:n] = np.concatenate([tree[layer][leaf].reshape(-1)
                              for layer, leaf, _ in _jax_leaves(use_bn)])
    return out.reshape(rows, _LANES)


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
    float32 numpy arrays (``kernel [in, out]``, LayerNorm ``scale``), every
    level in sorted key order, as a JAX pytree comes back from a jitted step
    (so a saved archive lists its arrays in the JAX CLI's order)."""
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

    def ordered(node):
        if not isinstance(node, dict):
            return node
        return {k: ordered(node[k]) for k in sorted(node)}

    return ordered(tree)


# Megatron shards of a ViT block (the JAX package's tp_vit.py
# vit_tp_param_specs): the leaf's split dim in torch's [out, in] layout.
# qkv and mlp_in are column-parallel (JAX kernel axis 1, torch dim 0; qkv's
# head-major features split into whole heads), proj and mlp_out
# row-parallel (JAX axis 0, torch dim 1) with their biases replicated;
# every other leaf is replicated.
TP_SPLIT_DIM = {"qkv.weight": 0, "qkv.bias": 0, "mlp_in.weight": 0, "mlp_in.bias": 0,
                "proj.weight": 1, "mlp_out.weight": 1}


def tp_split_dim(name: str) -> int | None:
    """The dim a ViT state leaf splits on over the model axis, or None
    (replicated)."""
    if not name.startswith("blocks."):
        return None
    return TP_SPLIT_DIM.get(name.split(".", 2)[2])


def shard_vit_state(state: Mapping[str, torch.Tensor], index: int,
                    count: int) -> dict[str, torch.Tensor]:
    """Member ``index`` of ``count``'s part of a full ViT state: the
    contiguous ``1/count`` slice of each sharded leaf, the others whole."""
    out = {}
    for name, value in state.items():
        dim = tp_split_dim(name)
        out[name] = value if dim is None else value.chunk(count, dim)[index].contiguous()
    return out


def gather_vit_state(shards: list[Mapping[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    """The inverse: the members' parts, in member order, back into the full
    state (replicated leaves from member 0)."""
    return {name: value if (dim := tp_split_dim(name)) is None
            else torch.cat([s[name] for s in shards], dim)
            for name, value in shards[0].items()}
