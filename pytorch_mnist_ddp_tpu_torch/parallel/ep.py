"""Expert parallelism: the MoE ViT's experts sharded over the data group,
tokens routed to them by two all-to-alls (the JAX package's
``parallel/ep.py``).

EP rides the data group ("EP rides DP"): a world of W ranks holds E/W
experts a rank, rank j the contiguous block j of every expert stack
(``utils/convert.py`` ``ep_split_dim``), the gate and every other leaf
whole.  Each rank routes its own tokens (switch top-1, capacity per
routing group: its ``b * t`` tokens), then:

1. hop 1: the packed slots ``[E, C, d]``, device-major over E, go block j
   to rank j; what arrives is ``[E/W, W*C, d]``, source-major along dim 1
   (JAX's ``all_to_all(split_axis=0, concat_axis=1)``; the port's
   :func:`~.mesh.all_to_all` stacks what arrives on dim 0, so a permute
   follows it);
2. the local experts' MLP on every rank's tokens for them;
3. hop 2 returns the outputs to their tokens' owners
   (``split_axis=1, concat_axis=0``: a permute before the all-to-all),
   ``[E, C, d]`` again, and the slot gather unpacks them.

Gradients are JAX's: the backward of each all-to-all is the reverse
all-to-all, so an expert stack's gradient forms on its owning rank from
every rank's tokens and is not all-reduced; the replicated leaves are
summed over the data group; every leaf is divided by the data degree
(``parallel/ddp.py`` ``reduce_grads(sharded=...)``).  The balance loss
is averaged over the group forward (JAX's ``pmean``) with each rank's own
term taking the gradient (:func:`~.mesh.mean_forward`).  The objective is
``nll + AUX_LOSS_WEIGHT * aux`` (:func:`ep_train_forward`); the step
reports the nll.
"""

from __future__ import annotations

import torch

from ..models.moe import (
    MoE,
    MoeOut,
    capacity_for,
    expert_ffn,
    gather_from_slots,
    route,
    scatter_to_slots,
)
from ..models.vit import ViT, ViTConfig, vit_moe_forward
from ..ops.flash_attention import select_attention
from ..utils.convert import ep_split_dim, gather_vit_state, shard_vit_state
from .ddp import make_forward_eval_step, make_forward_train_step
from .mesh import Group, RankGrid, all_gather, all_to_all, mean_forward

AUX_LOSS_WEIGHT = 0.01  # the Switch weighting of the balance loss (JAX ep.py:50)


def check_expert_divisibility(cfg: ViTConfig, num: int) -> None:
    """JAX's ``_check_expert_divisibility``, with its texts."""
    if cfg.num_experts <= 0:
        raise ValueError("expert parallelism needs cfg.num_experts > 0")
    if cfg.num_experts % num:
        raise ValueError(
            f"num_experts={cfg.num_experts} not divisible by the expert "
            f"axis ({num})"
        )


def moe_mlp_ep(moe: MoE, x: torch.Tensor, cfg: ViTConfig, group: Group = Group()) -> MoeOut:
    """The expert-parallel MoE MLP of one member of ``group``: ``x`` its
    tokens ``[b, t, d]``, ``moe`` the whole gate and its own ``E/S``
    experts of each stack."""
    size, num = group.size, cfg.num_experts
    b, t, d = x.shape
    flat = x.reshape(b * t, d)
    cap = capacity_for(b * t, num, cfg.capacity_factor)
    slot, kept, gate_prob, aux = route(moe.gate, flat, num, cap)
    xin = scatter_to_slots(flat, slot, kept, num, cap)            # [E, C, d]
    # hop 1: expert block j to member j, stacked by source -> [E/S, S*C, d]
    xin = all_to_all(xin.reshape(size, num // size, cap, d), group)
    xin = xin.transpose(0, 1).reshape(num // size, size * cap, d)
    out = expert_ffn(moe, xin)                                    # [E/S, S*C, d]
    # hop 2: source j's slots back to member j -> [E, C, d], device-major
    out = all_to_all(out.reshape(num // size, size, cap, d).transpose(0, 1), group)
    y = gather_from_slots(out.reshape(num, cap, d), slot, kept, gate_prob)
    return MoeOut(y.reshape(b, t, d).to(x.dtype), mean_forward(aux, group))


def ep_vit_forward(model: ViT, x: torch.Tensor, group: Group = Group(),
                   use_flash: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE ViT's forward on this member's rows with its experts:
    ``(log_probs, aux)``."""
    cfg = model.cfg
    return vit_moe_forward(model, x, lambda moe, h: moe_mlp_ep(moe, h, cfg, group),
                           select_attention(use_flash))


@torch.no_grad()
def shard_ep(model: ViT, group: Group) -> ViT:
    """Keep this member's block of every expert stack, in place; returns
    ``model``."""
    check_expert_divisibility(model.cfg, group.size)
    shards = shard_vit_state(dict(model.named_parameters()), group.rank, group.size,
                             ep_split_dim)
    for name, param in model.named_parameters():
        if shards[name] is not param:
            param.data = shards[name]
    return model


@torch.no_grad()
def gather_ep_state(model: ViT, group: Group) -> dict[str, torch.Tensor]:
    """The full MoE ViT state from the members' expert blocks (collective
    over the group; every member returns it): JAX's
    ``gather_replicated``."""
    state = {k: v.detach() for k, v in model.state_dict().items()}
    parts = [dict(zip(state, values)) for values in zip(
        *(all_gather(v, group) for v in state.values()))]
    return gather_vit_state(parts, ep_split_dim)


def is_expert_leaf(name: str) -> bool:
    return ep_split_dim(name) is not None


def ep_train_forward(group: Group = Group(), use_flash: bool = False):
    """``forward(model, x) -> (log_probs, AUX_LOSS_WEIGHT * aux)``: what the
    step trains on (``parallel/ddp.py`` adds the weighted balance loss to
    the nll)."""

    def forward(model: ViT, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        log_probs, aux = ep_vit_forward(model, x, group, use_flash)
        return log_probs, AUX_LOSS_WEIGHT * aux

    return forward


def make_ep_train_step(cfg: ViTConfig, grid: RankGrid = RankGrid(), use_flash: bool = False,
                       rho: float = 0.9, eps: float = 1e-6):
    """``train_step(model, state, x, y, w, lr) -> nll`` on the data group,
    ``model`` sharded by :func:`shard_ep`."""
    check_expert_divisibility(cfg, grid.data.size)
    return make_forward_train_step(ep_train_forward(grid.data, use_flash), rho, eps, grid,
                                   sharded=is_expert_leaf)


def make_ep_eval_step(cfg: ViTConfig, grid: RankGrid = RankGrid(), use_flash: bool = False):
    """``eval_step(model, x, y, w) -> (loss_sum, correct)``, the
    expert-parallel forward, summed over the data group."""
    check_expert_divisibility(cfg, grid.data.size)
    return make_forward_eval_step(
        lambda model, x: ep_vit_forward(model, x, grid.data, use_flash)[0], grid.data)
