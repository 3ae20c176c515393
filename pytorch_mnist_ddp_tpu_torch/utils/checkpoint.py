"""Load any trained-model artifact of the JAX package as a torch state dict.

Three formats, the same ones the JAX serving engine reads:

- a ``torch.save`` zip (``--save-model`` where torch is importable, or the
  original reference's ``mnist_cnn.pt``) — already in torch's layout, so
  it loads as it is, with the distributed-mode ``module.`` key prefix
  stripped;
- a model-only npz (``--save-model`` without torch): torch-style dotted
  keys, JAX tensor layouts;
- a ``--save-state`` training archive: ``params.<layer>.<leaf>`` keys in
  JAX layout beside optimizer state, of which only the params are kept.

The npz forms go through :func:`~.convert.torch_state_from_jax`.
BatchNorm checkpoints wait for a later slice of the port and are refused.
"""

from __future__ import annotations

import zipfile

import numpy as np
import torch

from .convert import LAYERS, torch_state_from_jax


def _is_torch_zip(path: str) -> bool:
    """torch's zip holds a ``data.pkl`` member; npz does not."""
    try:
        with zipfile.ZipFile(path) as z:
            return any(n.split("/")[-1] == "data.pkl" for n in z.namelist())
    except zipfile.BadZipFile:
        return False


def _strip_prefix(key: str) -> str:
    return key[len("module."):] if key.startswith("module.") else key


def _check_keys(keys) -> None:
    keys = set(keys)
    if any(k.split(".")[0].startswith("bn") for k in keys):
        raise ValueError(
            "BatchNorm checkpoints are not served by this port yet; serve a "
            "checkpoint without --syncbn"
        )
    want = {f"{layer}.{leaf}" for layer in LAYERS for leaf in ("weight", "bias")}
    missing = sorted(want - keys)
    if missing:
        raise ValueError(f"checkpoint is missing {missing}")


def _from_torch_file(path: str) -> dict[str, torch.Tensor]:
    raw = torch.load(path, map_location="cpu", weights_only=True)
    state = {_strip_prefix(k): v for k, v in raw.items()}
    _check_keys(state)
    return {
        k: state[k].detach().to(torch.float32).contiguous()
        for k in sorted(state)
        if k.split(".")[0] in LAYERS
    }


def _params_tree(flat: dict[str, np.ndarray], prefix: str, leaf_names) -> dict:
    """Flat dotted keys -> ``{layer: {"kernel", "bias"}}`` (JAX layout)."""
    tree: dict[str, dict[str, np.ndarray]] = {}
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        layer, leaf = _strip_prefix(key[len(prefix):]).split(".", 1)
        tree.setdefault(layer, {})[leaf_names.get(leaf, leaf)] = value
    return tree


def load_inference_state(path: str) -> dict[str, torch.Tensor]:
    """Any supported checkpoint -> float32 CPU state dict in torch layout
    (``conv1.weight`` OIHW ... ``fc1.weight`` with NCHW-ordered columns)."""
    if _is_torch_zip(path):
        return _from_torch_file(path)
    try:
        with np.load(path) as archive:
            flat = {k: archive[k] for k in archive.files}
    except ValueError:
        # Not an npz at all: a legacy (pre-zip) torch.save pickle.
        return _from_torch_file(path)
    if "step" in flat and any(k.startswith("params.") for k in flat):
        tree = _params_tree(flat, "params.", {})
    else:
        _check_keys(_strip_prefix(k) for k in flat)
        tree = _params_tree(flat, "", {"weight": "kernel"})
    return torch_state_from_jax(tree)
