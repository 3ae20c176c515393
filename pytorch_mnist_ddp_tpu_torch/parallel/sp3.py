"""3-D ViT parallelism: data x sequence x tensor (the JAX package's
``parallel/sp3.py``).

``sp.py`` shards tokens over the seq group, ``tp_vit.py`` heads and MLP
features over the model group; the two compose with no new collective:

- batch over data (the gradient sum of ``parallel/ddp.py``),
- tokens over seq (the ring of k/v blocks, the pool's sum),
- heads and MLP features over model (two row-parallel sums a block).

Each rank holds ``T/S`` tokens of ``H/M`` heads and folds every k/v block
of its own heads as the ring turns (``--flash``: the partial-mode kernel
at ``[b, T/S, H/M, d]``).  Parameters shard as in ``tp_vit.py``; tokens
are an activation axis.  Gradients: the tp rules within a model group,
the sp rules within a seq group (the head counts once over seq).
"""

from __future__ import annotations

import torch

from ..models.vit import ViT, ViTConfig
from .ddp import make_forward_eval_step, make_forward_train_step
from .mesh import RankGrid
from .sp import check_token_divisibility, embed_slice, pool_to_logp, seq_attention
from .tp_vit import check_head_divisibility, tp_block


def sp3_vit_forward(model: ViT, x: torch.Tensor, grid: RankGrid,
                    use_flash: bool = False) -> torch.Tensor:
    """The ViT forward over a (token, head) shard (JAX
    ``_sp3_vit_forward``): this rank's token slice, its heads' columns,
    the seq ring for attention, the model group's sums."""
    tokens = embed_slice(model, x, grid.seq)
    attention_fn = seq_attention(grid.seq, use_flash)
    for block in model.blocks:
        tokens = tp_block(block, tokens, model.cfg, grid.model, attention_fn)
    return pool_to_logp(model, model.ln_f(tokens), grid.seq)


def _check(cfg: ViTConfig, grid: RankGrid) -> None:
    check_token_divisibility(cfg, grid.seq.size)
    check_head_divisibility(cfg, grid.model.size)


def make_sp3_train_step(cfg: ViTConfig, grid: RankGrid, use_flash: bool = False,
                        rho: float = 0.9, eps: float = 1e-6):
    """``train_step(model, state, x, y, w, lr) -> loss`` on the 3-D grid,
    ``model`` sharded by ``tp_vit.shard_vit_tp`` over ``grid.model``."""
    _check(cfg, grid)
    return make_forward_train_step(
        lambda model, x: sp3_vit_forward(model, x, grid, use_flash), rho, eps, grid)


def make_sp3_eval_step(cfg: ViTConfig, grid: RankGrid, use_flash: bool = False):
    """``eval_step(model, x, y, w) -> (loss_sum, correct)``, summed over
    the data group."""
    _check(cfg, grid)
    return make_forward_eval_step(
        lambda model, x: sp3_vit_forward(model, x, grid, use_flash), grid.data)
