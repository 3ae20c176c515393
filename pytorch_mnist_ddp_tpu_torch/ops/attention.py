"""Scaled-dot-product attention: the dense form and the blockwise online
softmax, in plain PyTorch.

The JAX package's ``ops/attention.py``, op for op.  Layouts are its own:
q/k/v ``[batch, tokens, heads, head_dim]``, scores ``[b, h, tq, tk]``, and
the running state :class:`BlockAcc` with ``m``/``l`` ``[b, h, tq]`` and
``o`` ``[b, h, tq, d]``.  Softmax state and sums are float32.

``block_update`` without a mask is the plain version of the ring-hop
kernel (``ops/flash_attention.py``, mode ``partial``); ``full_attention``
with its logsumexp is the plain version of the whole-forward kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e30  # additive mask value; finite so (masked - max) stays finite


class BlockAcc(NamedTuple):
    """Online-softmax running state for one query block.

    m: running row max            [batch, heads, q_tokens]
    l: running normalizer         [batch, heads, q_tokens]
    o: unnormalized output accum  [batch, heads, q_tokens, head_dim]
    """

    m: torch.Tensor
    l: torch.Tensor
    o: torch.Tensor


def init_block_acc(
    batch: int, heads: int, q_tokens: int, head_dim: int,
    device: torch.device | str | None = None,
) -> BlockAcc:
    return BlockAcc(
        m=torch.full((batch, heads, q_tokens), NEG_INF, dtype=torch.float32, device=device),
        l=torch.zeros((batch, heads, q_tokens), dtype=torch.float32, device=device),
        o=torch.zeros((batch, heads, q_tokens, head_dim), dtype=torch.float32, device=device),
    )


def softmax_scale(head_dim: int, device: torch.device | str | None = None) -> torch.Tensor:
    """``1 / sqrt(d)`` computed in float32, as ``block_update`` does.  ``d``
    is filled on the device: a copy from the host could not be captured in
    a CUDA graph (``parallel/fused_vit.py``)."""
    return 1.0 / torch.sqrt(torch.full((), head_dim, dtype=torch.float32, device=device))


def block_update(
    acc: BlockAcc,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
) -> BlockAcc:
    """Fold one (k, v) block into the online-softmax accumulator: rescale
    the previous (l, o) by ``exp(m_old - m_new)`` and add this block's
    contribution.  Any block order gives dense softmax.

    q:        [b, tq, h, d]
    k, v:     [b, tk, h, d]
    kv_mask:  [b, tk] bool/0-1, False = padding token (excluded exactly)
    """
    scale = softmax_scale(q.shape[-1], q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if kv_mask is not None:
        keep = kv_mask.bool()[:, None, None, :]
        s = torch.where(keep, s, torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    m_new = torch.maximum(acc.m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    if kv_mask is not None:
        # exp(NEG_INF - m) underflows to 0 already; this keeps the
        # exclusion exact when every score of a row is masked.
        p = torch.where(keep, p, torch.zeros((), dtype=p.dtype, device=p.device))
    corr = torch.exp(acc.m - m_new)
    l_new = acc.l * corr + p.sum(dim=-1)
    o_new = acc.o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return BlockAcc(m=m_new, l=l_new, o=o_new)


def finalize_block_acc(acc: BlockAcc, dtype: torch.dtype) -> torch.Tensor:
    """Normalize the accumulator into attention output ``[b, tq, h, d]``.
    Rows whose every key was masked have l == 0 and give 0, not 0/0."""
    l = acc.l[..., None]
    live = l > 0
    out = torch.where(live, acc.o / torch.where(live, l, torch.ones_like(l)),
                      torch.zeros((), dtype=acc.o.dtype, device=acc.o.device))
    return out.transpose(1, 2).to(dtype)


def block_lse(acc: BlockAcc) -> torch.Tensor:
    """Per-row logsumexp ``m + log(l)`` ``[b, h, tq]``, 0-mass rows as ``m``."""
    return acc.m + torch.log(torch.where(acc.l > 0, acc.l, torch.ones_like(acc.l)))


def full_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Dense single-device attention, written as one ``block_update`` so the
    blockwise paths and this oracle share every numerical decision."""
    b, tq, h, d = q.shape
    acc = block_update(init_block_acc(b, h, tq, d, q.device), q, k, v, kv_mask)
    return finalize_block_acc(acc, q.dtype)
