"""Sequence parallelism: ring and Ulysses attention over a seq group.

The JAX package's ``parallel/sp.py`` shards the ViT's tokens over a
``seq`` mesh axis: each member embeds its slice of the tokens and keeps
its query block.  Two strategies attend over the whole sequence:

- the ring (``--sp-impl ring``): the (key, value) blocks travel the ring
  one hop at a time (:func:`~.mesh.ring_pass`), folding into the
  online-softmax state (``ops/attention.py``) until every member has seen
  every block: the resident block first, then ``size - 1`` hops.  With
  ``use_flash`` every fold is the partial-mode kernel
  (``ops/flash_attention.py`` ``flash_block_update``), the state kept in
  its ``BlockAcc`` layout across the hops (updated in place without
  autograd, as the TPU kernel aliases it);
- Ulysses (``--sp-impl ulysses``): one all-to-all trades the token
  sharding for a head sharding, ``[b, T/S, h, d] -> [b, T, h/S, d]``,
  attention runs locally on the whole sequence (the whole-forward kernel
  under ``use_flash``), and the inverse all-to-all restores the tokens.

The mean-pool sums tokens over the group (:func:`~.mesh.reduce_forward`),
after which every member computes the head and the loss alike.  Gradient
semantics are JAX's (its VMA-inserted psums): the trunk's gradients on a
member are that member's tokens' share, the pool passes the loss's
gradient to every member unchanged, and the head's, equal on every
member, is kept on member 0 alone (:func:`~.mesh.count_once`), so that
one sum of every leaf over the data x seq ranks, divided by the data
degree, is JAX's gradient (``parallel/ddp.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.vit import ViT, ViTConfig, embed_tokens, patchify, run_blocks
from ..ops.attention import block_update, finalize_block_acc, full_attention, init_block_acc
from ..ops.flash_attention import (
    flash_attention,
    flash_block_update,
    flash_ring_finalize,
    flash_ring_state,
)
from .ddp import make_forward_eval_step, make_forward_train_step
from .mesh import Group, RankGrid, all_to_all, count_once, reduce_forward, ring_pass

IMPLS = ("ring", "ulysses")


def ring_attention(q, k, v, group: Group = Group()) -> torch.Tensor:
    """Exact attention over the group's whole sequence: ``q/k/v`` are the
    local blocks ``[b, T/S, h, d]``.  Maskless: the ViT has no padding
    tokens.  k and v travel together, one ring pass a hop."""
    b, t_local, h, d = q.shape
    acc = block_update(init_block_acc(b, h, t_local, d, q.device), q, k, v)
    kv = torch.stack((k, v)) if group.size > 1 else None
    for _ in range(group.size - 1):
        kv = ring_pass(kv, group)
        acc = block_update(acc, q, kv[0], kv[1])
    return finalize_block_acc(acc, q.dtype)


def ring_attention_flash(q, k, v, group: Group = Group()) -> torch.Tensor:
    """:func:`ring_attention` with every fold in the partial-mode kernel:
    ``size`` launches, the resident block and ``size - 1`` received ones
    (contiguous, as the kernel takes them)."""
    b, t_local, h, d = q.shape
    m, l, a = flash_ring_state(b, h, t_local, d, q.device)
    m, l, a = flash_block_update(m, l, a, q, k, v)
    kv = torch.stack((k, v)) if group.size > 1 else None
    for _ in range(group.size - 1):
        kv = ring_pass(kv, group)
        m, l, a = flash_block_update(m, l, a, q, kv[0], kv[1])
    return flash_ring_finalize(m, l, a, q.dtype)


def ulysses_attention(q, k, v, group: Group = Group(), use_flash: bool = False) -> torch.Tensor:
    """All-to-all sequence parallelism (JAX sp.py ``ulysses_attention``):
    ``[b, T/S, h, d]`` token blocks -> ``[b, T, h/S, d]`` head shards, the
    whole sequence's attention on them, and back.  Token blocks are
    contiguous in group order, so member j's block lands at j.  q, k and v
    cross in one all-to-all."""
    size = group.size
    b, t, h, d = q.shape
    # [3, b, t, h, d] -> [S, 3, b, t, h/S, d]: chunk j is for member j.
    x = torch.stack((q, k, v)).reshape(3, b, t, size, h // size, d).permute(3, 0, 1, 2, 4, 5)
    y = all_to_all(x, group)  # chunk j: member j's tokens of this member's heads
    qh, kh, vh = y.permute(1, 2, 0, 3, 4, 5).reshape(3, b, size * t, h // size, d)
    out = (flash_attention if use_flash else full_attention)(qh, kh, vh)
    # [b, T, h/S, d] -> [S, b, t, h/S, d]: member j's tokens back to j.
    back = all_to_all(out.reshape(b, size, t, h // size, d).transpose(0, 1), group)
    return back.permute(1, 2, 0, 3, 4).reshape(b, t, h, d)


def check_token_divisibility(cfg: ViTConfig, num_seq: int, impl: str = "ring") -> None:
    """The JAX step's checks (sp.py ``_check_token_divisibility``): a token
    count the group does not divide would drop tokens from every slice and
    skew the pool's denominator; Ulysses also splits the heads."""
    if cfg.num_tokens % num_seq:
        raise ValueError(
            f"num_tokens={cfg.num_tokens} not divisible by the seq axis "
            f"({num_seq}); pick a patch grid divisible by the mesh"
        )
    if impl == "ulysses" and cfg.heads % num_seq:
        raise ValueError(
            f"--sp-impl ulysses shards heads over the seq axis: "
            f"heads={cfg.heads} not divisible by {num_seq}"
        )
    if impl not in IMPLS:
        raise ValueError(f"unknown sp impl {impl!r}")


def seq_attention(group: Group, use_flash: bool = False, impl: str = "ring"):
    """The attention function of a member of ``group``."""
    if impl == "ulysses":
        return lambda q, k, v: ulysses_attention(q, k, v, group, use_flash)
    ring = ring_attention_flash if use_flash else ring_attention
    return lambda q, k, v: ring(q, k, v, group)


def embed_slice(model: ViT, x: torch.Tensor, group: Group) -> torch.Tensor:
    """This member's token slice, embedded: patch rows and pos-embed rows
    by its place in the group, in the activation dtype."""
    t_local = model.cfg.num_tokens // group.size
    start = group.rank * t_local
    patches = patchify(x, model.cfg)[:, start:start + t_local]
    return embed_tokens(model, patches, model.pos_embed[start:start + t_local])


def pool_to_logp(model: ViT, tokens: torch.Tensor, group: Group) -> torch.Tensor:
    """Mean-pool in float32 by a sum over the group's tokens, then the head
    and log_softmax, which every member computes alike: the head's
    gradient counts once over the group."""
    # Divide by a tensor: CUDA's tensor / python_scalar multiplies by the
    # reciprocal.
    denom = torch.full((), model.cfg.num_tokens, dtype=torch.float32, device=tokens.device)
    pooled = reduce_forward(tokens.float().sum(dim=1), group) / denom
    weight, bias = (count_once(p, group) for p in (model.head.weight, model.head.bias))
    return F.log_softmax(F.linear(pooled, weight, bias).float(), dim=-1)


def sp_vit_forward(model: ViT, x: torch.Tensor, group: Group = Group(),
                   use_flash: bool = False, impl: str = "ring") -> torch.Tensor:
    """The ViT forward over this member's token slice (JAX sp.py
    ``_sp_vit_forward``): every block with the group's attention, with
    ``cfg.remat``'s recompute, whose replay repeats the ring passes or
    all-to-alls in the same order on every member."""
    tokens = embed_slice(model, x, group)
    tokens = run_blocks(model.blocks, tokens, model.cfg, seq_attention(group, use_flash, impl))
    return pool_to_logp(model, model.ln_f(tokens), group)


def make_sp_train_step(cfg: ViTConfig, grid: RankGrid = RankGrid(), use_flash: bool = False,
                       impl: str = "ring", rho: float = 0.9, eps: float = 1e-6):
    """``train_step(model, state, x, y, w, lr) -> loss`` on the ``(data,
    seq)`` grid: the sequence-parallel forward on this rank's data shard,
    the gradients summed over the data x seq ranks and divided by the data
    degree, the plain Adadelta update."""
    check_token_divisibility(cfg, grid.seq.size, impl)
    return make_forward_train_step(
        lambda model, x: sp_vit_forward(model, x, grid.seq, use_flash, impl), rho, eps, grid)


def make_sp_eval_step(cfg: ViTConfig, grid: RankGrid = RankGrid(), use_flash: bool = False,
                      impl: str = "ring"):
    """``eval_step(model, x, y, w) -> (loss_sum, correct)``, summed over
    the data group (every seq member holds the same totals)."""
    check_token_divisibility(cfg, grid.seq.size, impl)
    return make_forward_eval_step(
        lambda model, x: sp_vit_forward(model, x, grid.seq, use_flash, impl), grid.data)
