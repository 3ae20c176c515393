"""Sharded serving replicas: the shard-kind registry (the JAX package's
``serving/sharded.py``).

One logical serving replica can span a ``k``-device mesh
(``serving/devices.py`` :class:`~.devices.ReplicaMesh`): tensor parallel
for the CNN (``tp``) and the ViT (``vtp``), expert parallel for the MoE ViT
(``ep``), a two-stage pipeline for the CNN (``pp``).  This module is the
table the engine consults per ``shard_kind``: which forward to build, how
to place the host weights on the replica's devices, which single-device
forward anchors the parity gate, and how tight that gate is.

One controller per replica, as JAX has: the engine holds ``k`` shard
copies of the model, shard ``i`` on ``mesh.devices[i]``, and the kind's
forward steps them in lockstep over a :class:`~..parallel.mesh.Lockstep`
(each shard on a CUDA stream of its own device, the collectives explicit
sums and copies between them).  JAX's one ``shard_map`` over the mesh
becomes a loop over layers with the ``k`` shards inside each.

Parity expectations (JAX's, pinned by tests/test_torch_sharded.py):

- **tp / vtp**: the row-parallel sum re-associates the reduction over the
  sharded contraction dim, so outputs are ~1e-7 from the single-device
  forward: gated at 1e-5 plus argmax-identical.
- **pp**: the pipeline runs the single-device forward's ops in the same
  order, a microbatch at a time: gated at 0.0 against that forward run a
  microbatch at a time (:func:`reference_fn`).
- **ep**: per-token expert math does not depend on the slot order, so with
  no capacity drops outputs agree to the last bits; capacity is per
  routing group (each shard's rows) where the dense forward has one global
  group, so at the capacity edge the two may drop different tokens and the
  gate rightly refuses: serve EP with capacity-factor headroom.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.net import Net
from ..models.vit import ViT, ViTConfig
from .devices import ReplicaMesh

# Parity-gate tolerance (max |logp_sharded - logp_reference|) per kind, plus
# argmax identity on every row.
SHARDED_PARITY_TOL = {"tp": 1e-5, "vtp": 1e-5, "pp": 0.0, "ep": 1e-5}

# The ViT and MoE configs a sharded engine serves when the caller does not
# pin one.  EP's capacity factor is 4.0, not the training default 2.0: a
# dropped token is a parity failure by design (module docstring), and at
# 4 experts a factor of 4.0 gives each expert the whole group.
DEFAULT_VIT_CFG = ViTConfig()
DEFAULT_MOE_CFG = ViTConfig(num_experts=4, capacity_factor=4.0)


def default_vit_cfg(kind: str) -> ViTConfig:
    return DEFAULT_MOE_CFG if kind == "ep" else DEFAULT_VIT_CFG


def validate_family(kind: str, state) -> None:
    """Refuse a state dict of the wrong model family at construction, with
    JAX's words (the alternative is a shape error deep in a forward)."""
    is_vit = any(name.startswith("blocks.") for name in state)
    if kind in ("tp", "pp"):
        if is_vit or "fc1.weight" not in state:
            raise ValueError(
                f"shard kind {kind!r} serves the CNN family "
                "(conv1/conv2/fc1/fc2 params); got a "
                f"{'ViT' if is_vit else 'foreign'} tree"
            )
    elif kind in ("vtp", "ep"):
        if not is_vit:
            raise ValueError(
                f"shard kind {kind!r} serves the ViT family "
                "(blocks/<i> params); got a foreign tree"
            )
        moe = any(name.startswith("blocks.0.moe.") for name in state)
        if kind == "ep" and not moe:
            raise ValueError(
                "shard kind 'ep' serves the MoE-ViT family; the given "
                "ViT tree has dense MLP blocks (use 'vtp')"
            )
        if kind == "vtp" and moe:
            raise ValueError(
                "shard kind 'vtp' serves the dense ViT family; the "
                "given tree has MoE blocks (use 'ep')"
            )


def seed_params(kind: str, seed: int, vit_cfg: ViTConfig | None = None) -> dict:
    """Fresh weights of the family ``kind`` serves, from ``torch.Generator``
    seed ``seed`` (the no-checkpoint path of ``from_seed``)."""
    gen = torch.Generator().manual_seed(seed)
    if kind in ("vtp", "ep"):
        return ViT(vit_cfg or default_vit_cfg(kind), generator=gen).state_dict()
    return Net(gen).state_dict()


def single_device_model(kind: str, state, vit_cfg: ViTConfig | None):
    """The whole model of ``kind``'s family from ``state``, in eval mode on
    the CPU (what the parity gate's reference runs)."""
    model = (ViT(vit_cfg, generator=torch.Generator()) if kind in ("vtp", "ep")
             else Net(torch.Generator()))
    model.load_state_dict(state)  # jaxlint: disable=JL022 -- nn.Module.load_state_dict of the replica's own resolved weights into the parity gate's CPU reference: no file is read and no served weight changes
    return model.eval().requires_grad_(False)


def place_params(kind: str, state, mesh: ReplicaMesh, vit_cfg: ViTConfig | None,
                 lock) -> list:
    """The host weights as ``mesh.k`` shard models, shard ``i`` cut for
    member ``i`` of the kind (``tp.shard_state``, ``tp_vit.shard_vit_tp``,
    ``ep.shard_ep``; whole for each pipeline stage, as JAX replicates it)
    and placed on ``mesh.devices[i]`` on its stream."""
    from ..parallel.mesh import Group

    group = tuple(range(mesh.k))
    shards = []
    for i, device in enumerate(mesh.devices):
        model = single_device_model(kind, state, vit_cfg)
        member = Group(group, i)
        if kind == "tp":
            from ..parallel.tp import shard_state

            shard_state(model, member)
        elif kind == "vtp":
            from ..parallel.tp_vit import shard_vit_tp

            shard_vit_tp(model, member)
        elif kind == "ep":
            from ..parallel.ep import shard_ep

            shard_ep(model, member)
        elif kind != "pp":
            raise ValueError(f"unknown shard kind {kind!r}")
        with lock.on(i):
            shards.append(model.to(device))
    return shards


def build_predict_fn(kind: str, lock, *, vit_cfg: ViTConfig | None = None,
                     pp_microbatches: int = 2, packed: bool = False):
    """The kind's serving forward over ``lock``'s shards.

    Unpacked: ``fn(shards, x) -> logp`` (``(logp, expert_load)`` for
    ``ep``).  Packed adds the segment-id vector and sets the padding rows to
    exactly 0.0, the packed forwards' contract: the mask is applied outside
    the sharded forward, on the gathered log-probs, so one wrapper serves
    every kind."""
    if kind == "tp":
        from ..parallel.tp import make_tp_predict_step

        base = make_tp_predict_step(lock)
    elif kind == "vtp":
        from ..parallel.tp_vit import make_vit_tp_predict_step

        base = make_vit_tp_predict_step(vit_cfg, lock)
    elif kind == "ep":
        from ..parallel.ep import make_ep_predict_step

        base = make_ep_predict_step(vit_cfg, lock)
    elif kind == "pp":
        from ..parallel.pp import make_pp_predict_step

        base = make_pp_predict_step(lock, num_micro=pp_microbatches)
    else:
        raise ValueError(f"unknown shard kind {kind!r}")
    if not packed:
        return base
    if kind == "ep":

        def packed_fn(shards, x, seg_ids):
            logp, load = base(shards, x)
            return torch.where(seg_ids[:, None] >= 0, logp, 0.0), load

    else:

        def packed_fn(shards, x, seg_ids):
            return torch.where(seg_ids[:, None] >= 0, base(shards, x), 0.0)

    return packed_fn


def reference_fn(kind: str, vit_cfg: ViTConfig | None, pp_microbatches: int = 1):
    """The single-device forward the parity gate compares against:
    ``ref(state, x) -> logp`` on ``x``'s device, the model built from the
    host ``state`` there (kept for the next call on the same state).  The
    same forwards the ``dp`` engine and the single-device eval paths serve.
    For ``pp`` the gate passes ``pp_microbatches``, and the reference runs
    the rows a microbatch at a time: the shapes the pipeline computes, so
    "same ops, same order" holds to the bit (a GEMM's answer for a row can
    depend on the row count: on the CPU, fc1 at 8 rows and at 16 differ in
    the last bits).  Gate time only, never on the dispatch path."""
    if kind not in ("tp", "pp", "vtp", "ep"):
        raise ValueError(f"unknown shard kind {kind!r}")
    held: dict = {}

    def ref(state, x: torch.Tensor) -> torch.Tensor:
        if held.get("state") is not state or held.get("device") != x.device:
            held.update(state=state, device=x.device,
                        model=single_device_model(kind, state, vit_cfg).to(x.device))
        model = held["model"]
        with torch.inference_mode():
            if kind == "pp":
                return torch.cat([model(part) for part in x.chunk(pp_microbatches)])
            out = model(x)
        return out[0] if kind == "ep" else out

    return ref


def expert_imbalance(load) -> float:
    """max/mean of the per-expert kept-token counts: 1.0 is perfectly
    balanced, E is total collapse onto one expert."""
    load = np.asarray(load, np.float64)
    mean = float(load.mean())
    if mean <= 0.0:
        return 0.0
    return float(load.max() / mean)


def shard_devices(mesh: ReplicaMesh) -> list[torch.device]:
    """The replica's device list in mesh order (the ``serving_shard_devices``
    gauge value is its length)."""
    return list(mesh.devices)
