"""The S-stage GPipe schedule (the JAX package's ``parallel/pipeline.py``
``make_pipeline_loss_multi``), over a stage group of ranks.

S stages, M microbatches, ``M + S - 1`` ticks each way:

- forward: stage s runs microbatch j at tick ``s + j`` (stage 0 on the
  raw microbatch, the others on the activation that arrived the tick
  before); what it emits goes one stage on (:func:`~.mesh.stage_shift`);
  the last stage sums the microbatches' losses;
- backward: stage s runs microbatch j at tick ``(S-1-s) + (M-1-j)``,
  seeded on the last stage by the loss's cotangent and elsewhere by the
  cotangent that arrived from the next stage; its input's cotangent goes
  one stage back.

JAX wrote the backward by hand under ``custom_vjp`` (XLA:CPU aborts on
transposing its cond) and recomputes each stage in it; here each
microbatch keeps its autograd graph from the forward tick, and the
backward tick runs ``torch.autograd.grad`` on it with the received
cotangent: the same values.  A stage's parameter gradients accumulate
over its microbatches in the backward ticks' order, from zero, as JAX's
scan does; the stages' trees are disjoint, so the caller's one sum over
the ranks gives every rank the whole gradient.  The stage axis is the
rank grid's model axis (JAX's ``STAGE_AXIS = MODEL_AXIS``).

At every tick a rank posts its send and receive together
(``batch_isend_irecv``); an idle rank posts nothing, so no rank waits on
one that is not sending.  Every stage returns the loss summed over the
stage group (JAX's ``psum``): rank 0, stage 0, prints the last stage's
value, not 0.
"""

from __future__ import annotations

from typing import Callable

import torch

from .mesh import Group, all_reduce_, stage_shift


def make_pipeline(stage_fns: list[Callable], num_micro: int, group: Group):
    """``pipeline(model, x_mbs, y_mbs, w_mbs, seed, boundary) -> (loss_sum,
    grads)`` for the member of ``group`` whose stage body is
    ``stage_fns[group.rank]``:

    - ``stage_fns[0](model, x_mb, j) -> act``;
    - ``stage_fns[s](model, act, j) -> act`` for the middle stages;
    - ``stage_fns[-1](model, act, y_mb, w_mb, j) -> loss_sum``;

    ``j`` the microbatch's index (the CNN's per-microbatch dropout streams).

    ``x_mbs/y_mbs/w_mbs`` hold ``num_micro`` microbatches on dim 0,
    ``seed`` is the loss sum's cotangent and ``boundary`` a tensor shaped
    and typed as the activation every boundary carries.  ``grads`` is
    ``{name: gradient}``, zero for the leaves of other stages."""
    if num_micro < 1:
        raise ValueError(f"num_micro must be >= 1, got {num_micro}")
    num_stages = len(stage_fns)
    if num_stages < 2:
        raise ValueError(f"need >= 2 stage bodies, got {num_stages}")
    if group.size != num_stages:
        raise ValueError(f"{num_stages} stage bodies for a stage group of {group.size}")
    stage, fn = group.rank, stage_fns[group.rank]
    first, last = stage == 0, stage == num_stages - 1
    ticks = num_micro + num_stages - 1

    def active(s: int, j: int) -> bool:
        return 0 <= s < num_stages and 0 <= j < num_micro

    def pipeline(model, x_mbs, y_mbs, w_mbs, seed, boundary):
        params = dict(model.named_parameters())
        graphs, parts, arrived = {}, [], None
        for t in range(ticks):
            j, out = t - stage, None
            if active(stage, j):
                with torch.enable_grad():
                    inp = None if first else arrived.detach().requires_grad_()
                    if last:
                        parts.append(fn(model, inp, y_mbs[j], w_mbs[j], j))
                        graphs[j] = (inp, parts[-1])
                    else:
                        out = fn(model, x_mbs[j], j) if first else fn(model, inp, j)
                        graphs[j] = (inp, out)
            send = out.detach() if out is not None else None
            # stage s - 1 runs microbatch t - (s - 1) at this tick
            frm = stage - 1 if active(stage - 1, t - stage + 1) else None
            arrived = stage_shift(send, group, stage + 1 if send is not None else None, frm,
                                  boundary)
        loss_sum = torch.zeros((), dtype=torch.float32, device=boundary.device)
        for part in parts:
            loss_sum = loss_sum + part.detach()

        grads = {k: torch.zeros_like(p) for k, p in params.items()}
        arrived = None
        for sigma in range(ticks):
            j, g_in = num_micro - 1 - (sigma - (num_stages - 1 - stage)), None
            if active(stage, j):
                inp, out = graphs.pop(j)
                inputs = [*params.values()] + ([inp] if inp is not None else [])
                got = torch.autograd.grad(out, inputs, seed if last else arrived,
                                          allow_unused=True)
                for (k, acc), g in zip(grads.items(), got):
                    if g is not None:
                        grads[k] = acc + g
                g_in = got[-1] if inp is not None else None
            # stage s + 1 runs its backward of microbatch j at this tick
            frm = (stage + 1 if active(stage + 1, num_micro - 1 - (sigma - (num_stages - 2 - stage)))
                   else None)
            arrived = stage_shift(g_in, group, stage - 1 if g_in is not None else None, frm,
                                  boundary)
        return all_reduce_(loss_sum, group), grads

    return pipeline
