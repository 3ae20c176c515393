"""The small Vision Transformer of the JAX package's ``models/vit.py``, as
a ``torch.nn.Module`` with its attention injected.

Pre-LN ViT: patchify(p=7) -> [b, 16, 49] -> linear embed + learned
pos-embed -> depth x [LN -> MHA -> +residual -> LN -> MLP(gelu) ->
+residual] -> final LN -> mean-pool over tokens -> linear head ->
log_softmax.  ``ViTConfig()`` is dim 64, depth 2, 4 heads of 16, MLP 128:
71,946 parameters.  With ``num_experts > 0`` each block's MLP is a
switch-MoE layer (``models/moe.py``; ``--experts 8``: 305,050 parameters)
and the forward returns ``(log_probs, aux)``, aux the blocks' mean
load-balance loss (JAX's ``vit_moe_forward``).

The numerics follow the JAX module where torch's defaults differ:
LayerNorm eps 1e-6 with float32 statistics, GELU in its tanh form
(``jax.nn.gelu``'s default), the head-major qkv split (the projection
reshaped to ``[b, t, heads, 3, head_dim]``), float32 mean-pool and
log_softmax.  ``ViTConfig(bf16=True)`` (``--bf16``) runs the trunk in
bfloat16 as the JAX module does: patches and ``pos_embed`` are cast to
bf16, every ``dense`` casts its float32 weight and bias to the activation
dtype at use, LayerNorm keeps float32 statistics and returns bf16, and the
attention gets bf16 q/k/v; parameters, optimizer state, the pool, the head
and ``log_softmax`` stay float32.  The functional pieces (``patchify``, ``apply_block``,
``tokens_to_logp``) are public so ``parallel/sp.py`` composes them over a
token slice, as the JAX package does.

Weights live in torch's layout (``[out, in]`` Linear, LayerNorm
``weight``/``bias``); ``utils/convert.py`` crosses them to and from the
JAX tree by transposing the kernels, with no feature reordered.  Initial
weights come from an explicit ``torch.Generator``: torch-style
U(+-1/sqrt(fan_in)) for every Linear, 0.02 N(0, 1) for ``pos_embed``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.attention import full_attention
from .moe import MoE, MoeOut, moe_mlp_dense

AttentionFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
LN_EPS = 1e-6


class ViTConfig(NamedTuple):
    image_size: int = 28
    channels: int = 1
    patch_size: int = 7
    dim: int = 64
    depth: int = 2
    heads: int = 4
    mlp_dim: int = 128
    num_classes: int = 10
    # The MoE variant (models/moe.py): 0 experts is the dense MLP.
    num_experts: int = 0
    capacity_factor: float = 2.0
    # bfloat16 activations and matmuls; parameters and the tail stay float32.
    bf16: bool = False
    # Recompute each block's activations in backward (one more forward).
    remat: bool = False

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_tokens(self) -> int:
        return self.grid * self.grid

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads


def patchify(x: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """[b, H, W, C] -> [b, tokens, patch_dim]: each patch's features in
    (row, col, C) order, tokens row-major over the patch grid."""
    b = x.shape[0]
    g, p = cfg.grid, cfg.patch_size
    x = x.reshape(b, g, p, g, p, cfg.channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, g * g, cfg.patch_dim)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """Statistics in float32, output in the activation dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * weight + bias).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias)


def dense(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """A matmul in the activation dtype: the float32 weight and bias are
    cast to ``x.dtype`` at use."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class Block(nn.Module):
    """One pre-LN transformer block's parameters: the MLP's two Linears, or
    the experts (``moe``) when ``cfg.num_experts > 0``."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.ln1 = LayerNorm(cfg.dim)
        self.qkv = nn.utils.skip_init(nn.Linear, cfg.dim, 3 * cfg.dim)
        self.proj = nn.utils.skip_init(nn.Linear, cfg.dim, cfg.dim)
        self.ln2 = LayerNorm(cfg.dim)
        if cfg.num_experts > 0:
            self.moe = MoE(cfg.dim, cfg.mlp_dim, cfg.num_experts)
        else:
            self.mlp_in = nn.utils.skip_init(nn.Linear, cfg.dim, cfg.mlp_dim)
            self.mlp_out = nn.utils.skip_init(nn.Linear, cfg.mlp_dim, cfg.dim)


def attn_sublayer(block: Block, x: torch.Tensor, cfg: ViTConfig,
                  attention_fn: AttentionFn) -> torch.Tensor:
    """ln1 -> qkv -> attention -> proj residual.  The projection's features
    are head-major, ``[heads, 3, head_dim]``: q, k and v are strided views
    of it, handed to the attention as they are."""
    b, t, _ = x.shape
    qkv = dense(block.ln1(x), block.qkv).reshape(b, t, cfg.heads, 3, cfg.head_dim)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    attn = attention_fn(q, k, v).reshape(b, t, cfg.dim)
    return x + dense(attn, block.proj)


def apply_block(block: Block, x: torch.Tensor, cfg: ViTConfig,
                attention_fn: AttentionFn) -> torch.Tensor:
    """One block over ``[b, t, dim]`` tokens: t may be the whole sequence or
    a slice of it; everything but ``attention_fn`` is per token."""
    x = attn_sublayer(block, x, cfg, attention_fn)
    h = F.gelu(dense(block.ln2(x), block.mlp_in), approximate="tanh")
    return x + dense(h, block.mlp_out)


def run_blocks(blocks: nn.ModuleList, tokens: torch.Tensor, cfg: ViTConfig,
               attention_fn: AttentionFn) -> torch.Tensor:
    """Every block in order; with ``cfg.remat`` (and autograd on) each
    block's activations are recomputed in backward.  The blocks draw no
    random numbers, so the generators' states are not kept for the
    recompute: reading a CUDA generator's state is refused while a CUDA
    graph is being captured (``parallel/fused_vit.py``)."""
    for block in blocks:
        if cfg.remat and torch.is_grad_enabled():
            tokens = checkpoint(apply_block, block, tokens, cfg, attention_fn,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            tokens = apply_block(block, tokens, cfg, attention_fn)
    return tokens


MoeFn = Callable[[MoE, torch.Tensor], MoeOut]


def apply_block_moe(block: Block, x: torch.Tensor, cfg: ViTConfig, attention_fn: AttentionFn,
                    moe_fn: MoeFn) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE block (JAX ``apply_block_moe``): the same attention
    sublayer, the experts in place of the MLP; returns ``(x, aux)``."""
    x = attn_sublayer(block, x, cfg, attention_fn)
    out = moe_fn(block.moe, block.ln2(x))
    return x + out.y, out.aux_loss


def vit_moe_forward(model: "ViT", x: torch.Tensor, moe_fn: MoeFn | None = None,
                    attention_fn: AttentionFn | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The MoE ViT's forward -> ``(log_probs, aux / depth)`` (JAX
    ``vit_moe_forward``); ``moe_fn`` defaults to the single-device layer
    (each block's tokens one routing group),
    ``parallel/ep.py`` passes the expert-parallel one; ``attention_fn`` to
    the model's."""
    cfg = model.cfg
    moe_fn = moe_fn or (lambda moe, h: moe_mlp_dense(moe, h, cfg.num_experts,
                                                     cfg.capacity_factor))
    attention_fn = attention_fn or model.attention_fn
    tokens = embed_tokens(model, patchify(x, cfg), model.pos_embed)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for block in model.blocks:
        if cfg.remat and torch.is_grad_enabled():
            tokens, aux = checkpoint(apply_block_moe, block, tokens, cfg, attention_fn, moe_fn,
                                     use_reentrant=False)
        else:
            tokens, aux = apply_block_moe(block, tokens, cfg, attention_fn, moe_fn)
        aux_total = aux_total + aux
    tokens = model.ln_f(tokens)
    depth = torch.full((), cfg.depth, dtype=torch.float32, device=x.device)
    return tokens_to_logp(model, tokens.float().mean(dim=1)), aux_total / depth


def embed_tokens(model: "ViT", patches: torch.Tensor, pos_embed: torch.Tensor) -> torch.Tensor:
    """Patches ``[b, t, patch_dim]`` and their ``pos_embed`` rows -> tokens
    in the activation dtype (bf16 under ``cfg.bf16``)."""
    dt = torch.bfloat16 if model.cfg.bf16 else patches.dtype
    return dense(patches.to(dt), model.embed) + pos_embed.to(dt)


def tokens_to_logp(model: "ViT", pooled: torch.Tensor) -> torch.Tensor:
    """Mean-pooled features -> float32 log-probs."""
    return F.log_softmax(dense(pooled, model.head).float(), dim=-1)


class ViT(nn.Module):
    """Input ``[n, 28, 28, 1]`` float32; output ``[n, 10]`` log-probs.

    ``attention_fn`` (``full_attention`` or ``ops.flash_attention``'s
    ``flash_attention``) is what ``forward`` runs in every block;
    ``generator`` draws the initial weights (torch's default generator
    when None).  The MoE ViT's ``forward`` returns ``(log_probs, aux)``.
    """

    def __init__(self, cfg: ViTConfig = ViTConfig(), attention_fn: AttentionFn = full_attention,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        self.attention_fn = attention_fn
        self.embed = nn.utils.skip_init(nn.Linear, cfg.patch_dim, cfg.dim)
        self.pos_embed = nn.Parameter(torch.empty(cfg.num_tokens, cfg.dim))
        self.head = nn.utils.skip_init(nn.Linear, cfg.dim, cfg.num_classes)
        self.ln_f = LayerNorm(cfg.dim)
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        with torch.no_grad():
            for layer in self.modules():
                if isinstance(layer, nn.Linear):
                    bound = 1.0 / math.sqrt(layer.in_features)
                    for p in (layer.weight, layer.bias):
                        p.uniform_(-bound, bound, generator=generator)
            for layer in self.modules():
                if isinstance(layer, MoE):
                    layer.init_stacks(generator)
            self.pos_embed.normal_(generator=generator).mul_(0.02)

    def forward(self, x: torch.Tensor):
        cfg = self.cfg
        if cfg.num_experts > 0:
            return vit_moe_forward(self, x)
        tokens = embed_tokens(self, patchify(x, cfg), self.pos_embed)
        tokens = self.ln_f(run_blocks(self.blocks, tokens, cfg, self.attention_fn))
        # Pool in float32, the head's numeric contract.
        return tokens_to_logp(self, tokens.float().mean(dim=1))
