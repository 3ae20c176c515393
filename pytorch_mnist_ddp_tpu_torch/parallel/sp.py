"""Sequence parallelism: ring attention over a sequence group.

The JAX package's ``parallel/sp.py`` shards the ViT's tokens over a
``seq`` mesh axis: each member embeds its slice of the tokens, keeps its
query block, and the (key, value) blocks travel the ring one hop at a
time, folding into the online-softmax state (``ops/attention.py``) until
every member has seen every block; the mean-pool sums tokens over the
group.

This port runs a group of one (``--sp 1 --allow-degree-1``): the resident
block is folded and there are no hops, the token slice is 0..T and the
group sum of the pool is the identity.  The code keeps the ring's shape
(fold the resident block, then ``size - 1`` hops), and a group of more
than one raises until the port's distributed slice exists (ROADMAP
queue 1).  With ``use_flash`` every fold is the partial-mode kernel
(``ops/flash_attention.py`` ``flash_block_update``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.vit import ViT, ViTConfig, embed_tokens, patchify, run_blocks, tokens_to_logp
from ..ops.attention import block_update, finalize_block_acc, init_block_acc
from ..ops.flash_attention import flash_block_update, flash_ring_finalize, flash_ring_state
from .ddp import make_forward_eval_step, make_forward_train_step

MULTI_RANK_MESSAGE = (
    "the multi-rank sequence ring (--sp N > 1) waits for the port's "
    "distributed slice (ROADMAP queue 1); run --sp 1 --allow-degree-1"
)


class SeqGroup(NamedTuple):
    """This process's place in the sequence ring."""

    size: int = 1
    rank: int = 0


def make_seq_group(num_seq: int = 1) -> SeqGroup:
    if num_seq < 1:
        raise ValueError(f"sequence group size must be >= 1, got {num_seq}")
    if num_seq > 1:
        raise NotImplementedError(MULTI_RANK_MESSAGE)
    return SeqGroup(size=num_seq, rank=0)


def _ring_pass(x: torch.Tensor, group: SeqGroup) -> torch.Tensor:
    """Send ``x`` to the next member of the ring and receive the previous
    member's block."""
    raise NotImplementedError(MULTI_RANK_MESSAGE)


def _group_sum(x: torch.Tensor, group: SeqGroup) -> torch.Tensor:
    """Sum ``x`` over the group: the identity for a group of one."""
    if group.size > 1:
        raise NotImplementedError(MULTI_RANK_MESSAGE)
    return x


def ring_attention(q, k, v, group: SeqGroup = SeqGroup()) -> torch.Tensor:
    """Exact attention over the group's whole sequence: ``q/k/v`` are the
    local blocks ``[b, T/S, h, d]``.  Maskless: the ViT has no padding
    tokens."""
    b, t_local, h, d = q.shape
    acc = block_update(init_block_acc(b, h, t_local, d, q.device), q, k, v)
    for _ in range(group.size - 1):
        k, v = _ring_pass(k, group), _ring_pass(v, group)
        acc = block_update(acc, q, k, v)
    return finalize_block_acc(acc, q.dtype)


def ring_attention_flash(q, k, v, group: SeqGroup = SeqGroup()) -> torch.Tensor:
    """:func:`ring_attention` with every fold in the partial-mode kernel;
    the state stays in ``BlockAcc`` layout from the first fold to the
    final normalization."""
    b, t_local, h, d = q.shape
    m, l, a = flash_ring_state(b, h, t_local, d, q.device)
    m, l, a = flash_block_update(m, l, a, q, k, v)
    for _ in range(group.size - 1):
        k, v = _ring_pass(k, group), _ring_pass(v, group)
        m, l, a = flash_block_update(m, l, a, q, k, v)
    return flash_ring_finalize(m, l, a, q.dtype)


def check_token_divisibility(cfg: ViTConfig, num_seq: int) -> None:
    """A token count the group does not divide would drop tokens from
    every slice and skew the pool's denominator."""
    if cfg.num_tokens % num_seq:
        raise ValueError(
            f"num_tokens={cfg.num_tokens} not divisible by the sequence group "
            f"({num_seq}); pick a patch grid the group divides"
        )


def sp_vit_forward(model: ViT, x: torch.Tensor, group: SeqGroup = SeqGroup(),
                   use_flash: bool = False) -> torch.Tensor:
    """The ViT forward over this member's token slice: embed the slice
    (patch rows and pos-embed rows by rank, in the activation dtype), run
    every block with the ring as attention, pool in float32 by a group sum
    over tokens."""
    cfg = model.cfg
    t_local = cfg.num_tokens // group.size
    start = group.rank * t_local
    patches = patchify(x, cfg)[:, start:start + t_local]
    tokens = embed_tokens(model, patches, model.pos_embed[start:start + t_local])
    ring = ring_attention_flash if use_flash else ring_attention
    tokens = run_blocks(model.blocks, tokens, cfg, lambda q, k, v: ring(q, k, v, group))
    tokens = model.ln_f(tokens)
    # Divide by a tensor: CUDA's tensor / python_scalar multiplies by the
    # reciprocal.
    denom = torch.full((), cfg.num_tokens, dtype=torch.float32, device=tokens.device)
    pooled = _group_sum(tokens.float().sum(dim=1), group) / denom
    return tokens_to_logp(model, pooled)


def make_sp_train_step(cfg: ViTConfig, group: SeqGroup = SeqGroup(), use_flash: bool = False,
                       rho: float = 0.9, eps: float = 1e-6):
    """``train_step(model, state, x, y, w, lr) -> loss`` through the
    sequence-parallel forward; the plain Adadelta update."""
    check_token_divisibility(cfg, group.size)
    return make_forward_train_step(
        lambda model, x: sp_vit_forward(model, x, group, use_flash), rho, eps)


def make_sp_eval_step(cfg: ViTConfig, group: SeqGroup = SeqGroup(), use_flash: bool = False):
    """``eval_step(model, x, y, w) -> (loss_sum, correct)``."""
    check_token_divisibility(cfg, group.size)
    return make_forward_eval_step(lambda model, x: sp_vit_forward(model, x, group, use_flash))
