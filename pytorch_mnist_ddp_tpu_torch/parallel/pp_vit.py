"""Pipeline parallelism for the ViT: its blocks as stages (the JAX
package's ``parallel/pp_vit.py``).

``depth`` blocks split over the S stages of the model axis
(``--pp-stages``) into nearly even chunks (:func:`stage_bounds`), the
``[mb, tokens, dim]`` tokens crossing every boundary (bfloat16 under
``--bf16``):

- stage 0: patchify -> embed + pos-embed -> its blocks;
- stages 1..S-2: their blocks;
- stage S-1: its blocks -> final LN -> mean-pool -> head -> the weighted
  NLL sum.

``parallel/pipeline.py`` schedules them over ``--pp-microbatches``
microbatches.  The rank grid is ``(W/S, 1, S)``: the stages of a data
shard are one model group, and the data shards split every global batch.
The stages' disjoint gradients are summed over every rank (data x stage)
in one flat all-reduce and divided by the data degree (JAX's stage
``psum`` then data ``pmean``); every rank holds the whole model and
applies the same update.  ``--flash`` and ``--remat`` are refused with
``--pp`` (JAX's CLI texts): the stages run the plain attention.
"""

from __future__ import annotations

import torch

from ..models.vit import ViT, ViTConfig, apply_block, embed_tokens, patchify, tokens_to_logp
from ..ops.adadelta import adadelta_update
from ..ops.attention import full_attention
from ..ops.loss import nll_loss
from .ddp import reduce_grads
from .mesh import RankGrid, all_reduce_
from .pipeline import make_pipeline

STAGE_AXIS = "model"  # JAX's STAGE_AXIS = MODEL_AXIS


def stage_bounds(depth: int, num_stages: int) -> list[int]:
    """Block-index boundaries of the stages: floor-based ``i * depth //
    S``, never ``round``, so S = 2 splits ``depth // 2`` at every depth."""
    return [i * depth // num_stages for i in range(num_stages + 1)]


def _blocks(model: ViT, tokens: torch.Tensor, start: int, end: int) -> torch.Tensor:
    for block in model.blocks[start:end]:
        tokens = apply_block(block, tokens, model.cfg, full_attention)
    return tokens


def stage_fns(cfg: ViTConfig, num_stages: int) -> list:
    """The S stage bodies of ``parallel/pipeline.py``'s contract."""
    bounds = stage_bounds(cfg.depth, num_stages)

    def first(model, x_mb):
        tokens = embed_tokens(model, patchify(x_mb, cfg), model.pos_embed)
        return _blocks(model, tokens, bounds[0], bounds[1])

    def mid(start, end):
        return lambda model, act: _blocks(model, act, start, end)

    def last(model, act, y_mb, w_mb):
        tokens = model.ln_f(_blocks(model, act, bounds[-2], bounds[-1]))
        logp = tokens_to_logp(model, tokens.float().mean(dim=1))
        return nll_loss(logp, y_mb, w_mb, reduction="sum")

    return [first, *(mid(bounds[s], bounds[s + 1]) for s in range(1, num_stages - 1)), last]


def make_vit_pp_train_step(cfg: ViTConfig, grid: RankGrid, num_micro: int = 2,
                           rho: float = 0.9, eps: float = 1e-6):
    """``train_step(model, state, x, y, w, lr) -> loss`` on the ``(data, 1,
    stage)`` grid: this data shard's mean loss (every stage holds it)."""
    num_stages = grid.model.size
    if num_stages < 2:
        raise ValueError(
            f"pipeline needs a >= 2-wide '{STAGE_AXIS}' axis, got {num_stages}")
    if cfg.depth < num_stages:
        raise ValueError(f"pipeline needs depth >= {num_stages} blocks, got {cfg.depth}")
    pipeline = make_pipeline(stage_fns(cfg, num_stages), num_micro, grid.model)
    dt = torch.bfloat16 if cfg.bf16 else torch.float32
    ready = []

    def train_step(model, state, x, y, w, lr: float) -> torch.Tensor:
        n = x.shape[0]
        if n % num_micro:
            raise ValueError(f"shard batch {n} not divisible by {num_micro} microbatches")
        if not ready:
            if grid.model.backend == "nccl":
                # NCCL wants every member in a group's first call; the
                # pipeline's first is a send between two of them.
                all_reduce_(torch.zeros(1, device=x.device), grid.model)
            ready.append(True)
        mb = n // num_micro
        model.train()
        denom = torch.clamp(w.sum(), min=1.0)
        boundary = torch.empty((mb, cfg.num_tokens, cfg.dim), dtype=dt, device=x.device)
        loss_sum, grads = pipeline(model, x.reshape(num_micro, mb, *x.shape[1:]),
                                   y.reshape(num_micro, mb), w.reshape(num_micro, mb),
                                   torch.ones((), device=x.device) / denom, boundary)
        grads = reduce_grads(grads, grid.world, grid.num_data)
        adadelta_update(dict(model.named_parameters()), grads, state.opt, lr, rho, eps)
        state.step += 1
        return loss_sum / denom

    return train_step
