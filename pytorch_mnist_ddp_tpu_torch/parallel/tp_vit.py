"""Tensor parallelism for the ViT: Megatron-style sharded blocks over a
model group (the JAX package's ``parallel/tp_vit.py``).

- ``qkv`` and ``mlp_in`` are column-parallel: their output features split
  over the model group (torch dim 0 of the ``[out, in]`` weight, JAX's
  kernel axis 1).  qkv's features are head-major, so a contiguous split
  lands whole heads and each member attends over its ``heads/M`` heads
  alone.
- ``proj`` and ``mlp_out`` are row-parallel: their input features split
  (torch dim 1); each member's partial product is summed over the group
  and the replicated bias added after the sum (:func:`row_dense`).
- embed, pos_embed, the LayerNorms and the head stay replicated.

:func:`shard_vit_tp` keeps this member's slices (``utils/convert.py``
``shard_vit_state``, the slices of JAX's ``shard_vit_tp_state``); the
Adadelta accumulators, made after it, shard like their parameters.

Gradients are JAX's: the row-parallel sum passes its gradient unchanged
(:func:`~.mesh.reduce_forward`), and where a replicated activation enters
a column-parallel layer its gradient, each member's share, is summed over
the group (:func:`~.mesh.reduce_backward`, the psum JAX's VMA inserts).
So every replicated leaf gets the whole gradient on every member alike,
every sharded leaf its own slice's, and the step sums them only over the
data x seq ranks (``parallel/ddp.py``).

Serving (:func:`make_vit_tp_predict_step`, a ``vtpK`` replica) runs the
same blocks over ``k`` shards in one process (:class:`~.mesh.Lockstep`),
the two sums of each block explicit ones in shard order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.vit import Block, ViT, ViTConfig, dense, embed_tokens, patchify, tokens_to_logp
from ..ops.attention import full_attention
from ..ops.flash_attention import select_attention
from ..utils.convert import gather_vit_state, shard_vit_state
from .ddp import make_forward_eval_step, make_forward_train_step
from .mesh import Group, Lockstep, RankGrid, all_gather, reduce_backward, reduce_forward


def check_head_divisibility(cfg: ViTConfig, num_model: int) -> None:
    """The JAX step's checks (tp_vit.py ``_check_head_divisibility``)."""
    if cfg.heads % num_model:
        raise ValueError(
            f"heads={cfg.heads} not divisible by the model axis "
            f"({num_model}); attention shards by whole heads"
        )
    if cfg.mlp_dim % num_model:
        raise ValueError(
            f"mlp_dim={cfg.mlp_dim} not divisible by the model axis "
            f"({num_model})"
        )


@torch.no_grad()
def shard_vit_tp(model: ViT, group: Group) -> ViT:
    """Replace ``model``'s sharded leaves by this member's slices, in
    place; returns ``model``."""
    check_head_divisibility(model.cfg, group.size)
    shards = shard_vit_state(dict(model.named_parameters()), group.rank, group.size)
    for name, param in model.named_parameters():
        if shards[name] is not param:
            param.data = shards[name]
    return model


@torch.no_grad()
def gather_vit_tp_state(model: ViT, group: Group) -> dict[str, torch.Tensor]:
    """The full ViT state from the members' shards (collective over the
    group; every member returns it): the counterpart of JAX's
    ``gather_replicated``."""
    state = {k: v.detach() for k, v in model.state_dict().items()}
    parts = [dict(zip(state, values)) for values in zip(
        *(all_gather(v, group) for v in state.values()))]
    return gather_vit_state(parts)


def row_dense(x: torch.Tensor, layer: torch.nn.Linear, group: Group) -> torch.Tensor:
    """Row-parallel dense (JAX ``_row``): the local partial product summed
    over the group, then the replicated bias, in the activation dtype."""
    part = F.linear(x, layer.weight.to(x.dtype))
    return reduce_forward(part, group) + layer.bias.to(x.dtype)


def tp_block(block: Block, x: torch.Tensor, cfg: ViTConfig, group: Group,
             attention_fn) -> torch.Tensor:
    """One pre-LN block over a model shard (JAX ``_tp_block``): local heads,
    local MLP features, two sums over the group.  ``attention_fn`` is
    injected, as in ``models/vit.py``: ``sp3.py`` passes the ring."""
    b, t, _ = x.shape
    heads_local = cfg.heads // group.size
    h = reduce_backward(block.ln1(x), group)
    qkv = dense(h, block.qkv).reshape(b, t, heads_local, 3, cfg.head_dim)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    attn = attention_fn(q, k, v).reshape(b, t, heads_local * cfg.head_dim)
    x = x + row_dense(attn, block.proj, group)
    h = reduce_backward(block.ln2(x), group)
    h = F.gelu(dense(h, block.mlp_in), approximate="tanh")
    return x + row_dense(h, block.mlp_out, group)


def tp_vit_forward(model: ViT, x: torch.Tensor, group: Group = Group(),
                   use_flash: bool = False) -> torch.Tensor:
    """The ViT forward over a model shard (JAX ``_tp_vit_forward``): every
    token local, the sharded layers' local slices; ``use_flash`` runs the
    whole-forward kernel on this member's heads."""
    cfg = model.cfg
    tokens = embed_tokens(model, patchify(x, cfg), model.pos_embed)
    attention_fn = select_attention(use_flash)
    for block in model.blocks:
        tokens = tp_block(block, tokens, cfg, group, attention_fn)
    tokens = model.ln_f(tokens)
    return tokens_to_logp(model, tokens.float().mean(dim=1))


def make_vit_tp_train_step(cfg: ViTConfig, grid: RankGrid = RankGrid(), use_flash: bool = False,
                           rho: float = 0.9, eps: float = 1e-6):
    """``train_step(model, state, x, y, w, lr) -> loss`` on the ``(data,
    model)`` grid, ``model`` sharded by :func:`shard_vit_tp`."""
    check_head_divisibility(cfg, grid.model.size)
    return make_forward_train_step(
        lambda model, x: tp_vit_forward(model, x, grid.model, use_flash), rho, eps, grid)


def make_vit_tp_eval_step(cfg: ViTConfig, grid: RankGrid = RankGrid(), use_flash: bool = False):
    """``eval_step(model, x, y, w) -> (loss_sum, correct)`` on the sharded
    model, summed over the data group."""
    check_head_divisibility(cfg, grid.model.size)
    return make_forward_eval_step(
        lambda model, x: tp_vit_forward(model, x, grid.model, use_flash), grid.data)


def vit_tp_predict(shards: list[ViT], x: torch.Tensor, cfg: ViTConfig,
                   lock: Lockstep) -> torch.Tensor:
    """The ViT's tensor-parallel serving forward (JAX
    ``make_vit_tp_predict_step``) over ``lock``'s shards, ``shards[i]`` cut
    by :func:`shard_vit_tp` for member ``i``; ``x`` and the log-probs on the
    first device.  The residual stream is replicated, so it lives once, on
    the first device: each block hands ``ln1`` of it to every shard, whose
    heads attend and project into a partial sum, summed in shard order
    before proj's bias and the residual add; then ``ln2`` the same way
    through each shard's MLP features and mlp_out's sum.  Two sums a block,
    as JAX's two psums."""
    heads_local = cfg.heads // lock.size
    first = shards[0]
    tokens = embed_tokens(first, patchify(x, cfg), first.pos_embed)
    b, t, _ = tokens.shape
    for layer, block in enumerate(first.blocks):
        parts = []
        for i, h in enumerate(lock.to_shards(block.ln1(tokens))):
            with lock.on(i):
                local = shards[i].blocks[layer]
                qkv = dense(h, local.qkv).reshape(b, t, heads_local, 3, cfg.head_dim)
                attn = full_attention(qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :])
                attn = attn.reshape(b, t, heads_local * cfg.head_dim)
                parts.append(F.linear(attn, local.proj.weight))
        tokens = tokens + (lock.psum(parts) + block.proj.bias)
        parts = []
        for i, h in enumerate(lock.to_shards(block.ln2(tokens))):
            with lock.on(i):
                local = shards[i].blocks[layer]
                h = F.gelu(dense(h, local.mlp_in), approximate="tanh")
                parts.append(F.linear(h, local.mlp_out.weight))
        tokens = tokens + (lock.psum(parts) + block.mlp_out.bias)
    tokens = first.ln_f(tokens)
    return tokens_to_logp(first, tokens.float().mean(dim=1))


def make_vit_tp_predict_step(cfg: ViTConfig, lock: Lockstep):
    """``predict_fn(shards, x) -> log_probs`` over ``lock``'s shards; the
    head and MLP widths must divide by their count."""
    check_head_divisibility(cfg, lock.size)

    def predict(shards, x):
        return vit_tp_predict(shards, x, cfg, lock)

    return predict
