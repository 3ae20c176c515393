"""The ViT's Mixture-of-Experts MLP (the JAX package's ``models/moe.py``):
switch-style top-1 routing with a per-expert capacity.

- gate: a linear ``[dim -> E]`` and a float32 softmax; each token goes to
  its argmax expert (the first on a tie, as both packages' argmax),
  weighted by that expert's probability;
- capacity: expert e takes at most ``C = ceil(G * capacity_factor / E)``
  tokens of a routing group of ``G``, in token order; the rest are
  dropped (their MLP output is 0, the residual carries them);
- aux: the load-balance loss ``E * sum_e f_e * P_e`` (fraction of tokens
  routed to e times its mean gate probability).

Routing runs in scatter form: :func:`route` gives three ``[G]`` vectors
(slot ``e * C + pos`` for a kept token, the dummy slot ``E * C`` for a
dropped one), :func:`scatter_to_slots` packs ``[G, d] -> [E, C, d]`` and
:func:`gather_from_slots` unpacks.  Every kept token has a slot of its
own and the dropped ones share the dummy row, which is cut off, so the
scatter is a copy (``index_copy``): no kept value depends on the order of
atomic adds.  ``parallel/ep.py`` runs the same functions with the expert
dim sharded and two all-to-alls between them.  :func:`moe_mlp_dense_einsum`,
the one-hot ``[G, E, C]`` formulation, is the independent oracle the
tests hold the scatter form against; nothing on the training path calls
it.

The expert weights are ``[E, d_in, d_out]`` stacks, as in JAX, so dim 0
shards over the expert group.  Under ``--bf16`` the tokens entering the
layer are bfloat16 and the parameters float32, and JAX's type promotion
runs the gate matmul and both expert matmuls in float32 on the
bf16-rounded tokens, the output cast back to bfloat16: the port casts to
those dtypes explicitly (``torch.matmul`` takes no mixed dtypes).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn


class MoeOut(NamedTuple):
    y: torch.Tensor         # [..., dim] expert-MLP output (0 for dropped tokens)
    aux_loss: torch.Tensor  # scalar load-balance loss


class MoE(nn.Module):
    """One block's experts: ``gate`` (``weight [E, dim]``, JAX's kernel
    ``[dim, E]`` transposed), ``w_in [E, dim, mlp]``, ``b_in [E, mlp]``,
    ``w_out [E, mlp, dim]``, ``b_out [E, dim]``.  ``num_local`` experts
    of the stacks live here (``E`` unless sharded)."""

    def __init__(self, dim: int, mlp_dim: int, num_experts: int):
        super().__init__()
        self.gate = nn.utils.skip_init(nn.Linear, dim, num_experts)
        self.w_in = nn.Parameter(torch.empty(num_experts, dim, mlp_dim))
        self.b_in = nn.Parameter(torch.zeros(num_experts, mlp_dim))
        self.w_out = nn.Parameter(torch.empty(num_experts, mlp_dim, dim))
        self.b_out = nn.Parameter(torch.zeros(num_experts, dim))

    @torch.no_grad()
    def init_stacks(self, generator: torch.Generator | None) -> None:
        """U(+-1/sqrt(fan_in)) for each expert's kernels, zero biases (the
        JAX module's scheme; the gate is initialized with the model's
        other Linears)."""
        for w in (self.w_in, self.w_out):
            bound = 1.0 / math.sqrt(w.shape[1])
            w.uniform_(-bound, bound, generator=generator)
        self.b_in.zero_()
        self.b_out.zero_()


def capacity_for(num_tokens: int, num_experts: int, capacity_factor: float) -> int:
    """The per-expert capacity of a routing group of ``num_tokens``."""
    return max(1, math.ceil(num_tokens * capacity_factor / num_experts))


def gate_probs(gate: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """Float32 softmax of the gate's logits, the matmul in float32 on
    ``x`` as it is (JAX promotes bf16 tokens against float32 weights)."""
    logits = F.linear(x.float(), gate.weight, gate.bias)
    return torch.softmax(logits, dim=-1)


def _aux(probs: torch.Tensor, onehot: torch.Tensor, num_experts: int) -> torch.Tensor:
    return num_experts * (onehot.mean(dim=0) * probs.mean(dim=0)).sum()


def route(gate: nn.Linear, x: torch.Tensor, num_experts: int, capacity: int):
    """Top-1 routing of a flat token group ``x [G, dim]`` in scatter form:
    ``(slot, kept, gate_prob, aux)``, slot ``[G]`` int64 (``e * C + pos``
    kept, ``E * C`` dropped), kept ``[G]`` bool, gate_prob ``[G]`` (the
    chosen expert's probability), aux the scalar load-balance loss."""
    probs = gate_probs(gate, x)
    gate_prob, expert = probs.max(dim=-1)
    onehot = F.one_hot(expert, num_experts)
    # Position within the chosen expert's queue, in token order (exact in
    # integers, as JAX's float cumsum is exact at these sizes).
    pos = ((onehot.cumsum(dim=0) - onehot) * onehot).sum(dim=-1)
    kept = pos < capacity
    slot = torch.where(kept, expert * capacity + pos,
                       torch.full_like(pos, num_experts * capacity))
    return slot, kept, gate_prob, _aux(probs, onehot.to(probs.dtype), num_experts)


def scatter_to_slots(flat: torch.Tensor, slot: torch.Tensor, kept: torch.Tensor,
                     num_experts: int, capacity: int) -> torch.Tensor:
    """``[G, d] -> [E, C, d]``; dropped tokens land in the dummy row, cut
    off.  A copy, not an add: every kept slot is written once."""
    d = flat.shape[-1]
    buf = flat.new_zeros(num_experts * capacity + 1, d)
    buf = buf.index_copy(0, slot, flat * kept[:, None].to(flat.dtype))
    return buf[:-1].reshape(num_experts, capacity, d)


def gather_from_slots(out: torch.Tensor, slot: torch.Tensor, kept: torch.Tensor,
                      gate_prob: torch.Tensor) -> torch.Tensor:
    """``[E, C, d] -> [G, d]`` in token order, weighted by the gate;
    dropped tokens read an appended zero row."""
    e, c, d = out.shape
    flat_out = torch.cat([out.reshape(e * c, d), out.new_zeros(1, d)])
    weight = (gate_prob * kept.to(gate_prob.dtype)).to(out.dtype)
    return flat_out[slot] * weight[:, None]


def expert_ffn(moe: MoE, xin: torch.Tensor) -> torch.Tensor:
    """Each expert's MLP on its slots, ``[E, C, dim] -> [E, C, dim]``, in
    float32 (JAX's promotion of bf16 tokens against float32 stacks); GELU
    in its tanh form."""
    h = torch.bmm(xin.float(), moe.w_in) + moe.b_in[:, None, :]
    h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, moe.w_out) + moe.b_out[:, None, :]


def moe_mlp_dense(moe: MoE, x: torch.Tensor, num_experts: int,
                  capacity_factor: float) -> MoeOut:
    """The MoE MLP on one device over ``x [b, t, dim]``: one routing group
    of ``b * t`` tokens."""
    b, t, d = x.shape
    flat = x.reshape(b * t, d)
    cap = capacity_for(b * t, num_experts, capacity_factor)
    slot, kept, gate_prob, aux = route(moe.gate, flat, num_experts, cap)
    out = expert_ffn(moe, scatter_to_slots(flat, slot, kept, num_experts, cap))
    y = gather_from_slots(out, slot, kept, gate_prob)
    return MoeOut(y.reshape(b, t, d).to(x.dtype), aux)


def gate_and_dispatch(gate: nn.Linear, x: torch.Tensor, num_experts: int, capacity: int):
    """The one-hot form of :func:`route`: ``(dispatch, combine, aux)``,
    dispatch ``[G, E, C]`` 0/1, combine dispatch times the gate
    probability."""
    probs = gate_probs(gate, x)
    gate_prob, expert = probs.max(dim=-1)
    onehot = F.one_hot(expert, num_experts).to(probs.dtype)
    pos = ((onehot.cumsum(dim=0) - onehot) * onehot).sum(dim=-1).long()
    # A position past the capacity has no one-hot row: the drop.
    slots = (pos[:, None] == torch.arange(capacity, device=x.device)).to(probs.dtype)
    dispatch = onehot[:, :, None] * slots[:, None, :]
    return dispatch, dispatch * gate_prob[:, None, None], _aux(probs, onehot, num_experts)


def moe_mlp_dense_einsum(moe: MoE, x: torch.Tensor, num_experts: int,
                         capacity_factor: float) -> MoeOut:
    """The einsum oracle: dispatch and combine as ``[G, E, C]`` tensors
    (quadratic in the group; tests only)."""
    b, t, d = x.shape
    flat = x.reshape(b * t, d)
    cap = capacity_for(b * t, num_experts, capacity_factor)
    dispatch, combine, aux = gate_and_dispatch(moe.gate, flat, num_experts, cap)
    xin = torch.einsum("gec,gd->ecd", dispatch, flat.float())
    out = expert_ffn(moe, xin)
    y = torch.einsum("gec,ecd->gd", combine, out)
    return MoeOut(y.reshape(b, t, d).to(x.dtype), aux)
