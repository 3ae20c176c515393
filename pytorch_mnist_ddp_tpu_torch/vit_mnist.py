"""ViT-family MNIST training CLI, the port's counterpart of the root
``vit_mnist.py``:

    python -m pytorch_mnist_ddp_tpu_torch.vit_mnist [flags]
    python -m pytorch_mnist_ddp_tpu_torch.vit_mnist --flash            # attention kernel
    python -m pytorch_mnist_ddp_tpu_torch.vit_mnist --bf16 --flash     # bf16 trunk
    python -m pytorch_mnist_ddp_tpu_torch.vit_mnist --fused [--pregather] [--zero] \\
        [--timings-json PATH]                                          # CUDA-graph replay
    python -m pytorch_mnist_ddp_tpu_torch.parallel.launch --nproc_per_node=W \\
        -m pytorch_mnist_ddp_tpu_torch.vit_mnist --sp S [--sp-impl ulysses] [--tp M] [--flash]
    python -m pytorch_mnist_ddp_tpu_torch.parallel.launch --nproc_per_node=W \\
        -m pytorch_mnist_ddp_tpu_torch.vit_mnist --experts 8 [--flash] | --zero [--flash] | --pp

It runs on the card (``cuda``) unless ``--no-cuda``/``--no-accel`` asks for
the CPU, and raises without a card otherwise.  Under the launcher's
environment (``RANK``/``WORLD_SIZE``, ``parallel/distributed.py``) each
process is one rank of a world, NCCL on the card and gloo on the CPU,
and ``--sp S``/``--tp M`` lay the ranks out as JAX lays out its devices:
a ``(data, seq, model)`` grid of shape ``(W/(S*M), S, M)``
(``parallel/mesh.py``).  The branches, as in the JAX CLI:

- single device (``--flash``: the whole-forward kernel in every block);
- ``--sp S``: the sequence ring (``parallel/sp.py``; ``--flash``: S
  partial-mode launches an attention call), or with ``--sp-impl ulysses``
  the all-to-all (``--flash``: the whole-forward kernel on ``h/S`` heads);
- ``--tp M``: Megatron blocks (``parallel/tp_vit.py``; ``--flash`` on
  ``h/M`` heads);
- ``--sp S --tp M``: the 3-D composition (``parallel/sp3.py``), the ring
  inside each model shard's heads;
- ``--pp``: the blocks pipelined over ``--pp-stages`` stages of the model
  axis, ``--pp-microbatches`` a data shard's batch (``parallel/pp_vit.py``);
- ``--experts E``: the switch-MoE ViT, its experts sharded over the data
  axis, E/W a rank, tokens routed by two all-to-alls (``parallel/ep.py``;
  ``--flash``: the whole-forward kernel in every block);
- ``--zero``: data parallelism with the Adadelta state sharded 1/W
  (``parallel/zero.py``; ``--flash`` as the single device);
- ``--fused``: the data-parallel epochs over device-resident sets, every
  rank on the data axis, each step replayed from one CUDA graph on the
  card and one host read an epoch (``parallel/fused_vit.py``; with
  ``--zero`` the sharded accumulators in the captured step; not with
  ``--flash``, as in JAX); ``--pregather`` gathers each epoch's rows once,
  ``--timings-json PATH`` writes JAX's attribution (:func:`run_fused`).
  ``--dry-run`` demotes ``--fused`` to the per-batch loop, as in JAX.

A parallel mode runs at degree 1 only with ``--allow-degree-1``; without
the launcher the world is of one rank.  Rows go by data coordinate: every
seq and model member of a data shard sees that shard's rows, ``--batch-size``
and ``--test-batch-size`` of them a step.  ``--bf16`` runs any mode in
bfloat16 (the kernel's bf16 mode under ``--flash``).  The flags are
``vit_mnist.py``'s, with the same names, defaults and truth table.  Only
rank 0 prints, and its lines
are the JAX CLI's (its own loss, as JAX prints its first shard's; under
``--pp`` its data shard's, summed over the stages); ``--save-model``
writes ``vit_mnist.npz`` in the JAX package's params-tree format from
rank 0, the model and expert shards gathered first.  ``--save-state``
writes the whole training state (params, per-leaf Adadelta accumulators,
step, epochs) in the JAX package's archive format, and ``--resume-state``
continues it: the schedule, the shuffle and the epoch numbering pick up
where it stopped.  They ride the replicated-state paths, as in JAX: the
single device, ``--zero`` (its chunks gathered per leaf on save, cut
again on resume, so archives cross with plain runs), ``--sp`` and
``--fused``.
``--profile DIR`` traces the run with ``torch.profiler``, ``--step-stats``
prints one latency line an epoch.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch

from .device import resolve_device
from .models.vit import ViT, ViTConfig
from .ops.adadelta import AdadeltaState, adadelta_init
from .ops.flash_attention import select_attention
from .parallel import ep, pp_vit, sp, sp3, tp_vit
from .parallel.ddp import TrainState, make_forward_eval_step, make_forward_train_step
from .parallel.zero import per_leaf_opt_to_zero, zero_init, zero_opt_to_per_leaf
from .parallel.distributed import DistState, destroy_distributed, form_world
from .parallel.fused_vit import make_fused_vit_run
from .parallel.mesh import RankGrid, make_rank_grid
from .trainer import make_shard_loaders, run_epochs, run_fused_epochs
from .utils.checkpoint import (
    TrainArchive,
    load_params_tree,
    load_vit_train_state,
    save_params_tree,
    save_vit_train_state,
)
from .utils.convert import jax_vit_tree_from_torch, torch_vit_state_from_jax
from .utils.logging import total_time_line
from .utils.profiling import trace
from .utils.rng import split_streams

SAVE_PATH = "vit_mnist.npz"
# --timings-json's keys, JAX's (vit_mnist.py's fused branch)
TIMINGS_KEYS = ("dataset", "compile_s", "data_s", "run_s", "train_size", "test_size", "epochs",
                "n_shards", "depth", "dim", "epoch1_test_accuracy", "final_test_accuracy")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_mnist_ddp_tpu_torch.vit_mnist",
        description="PyTorch/CUDA ViT MNIST example",
    )
    p.add_argument("--batch-size", type=int, default=64, metavar="N")
    p.add_argument("--test-batch-size", type=int, default=1000, metavar="N")
    p.add_argument("--epochs", type=int, default=14, metavar="N")
    p.add_argument("--lr", type=float, default=1.0, metavar="LR")
    p.add_argument("--gamma", type=float, default=0.7, metavar="M")
    p.add_argument("--seed", type=int, default=1, metavar="S")
    p.add_argument("--log-interval", type=int, default=10, metavar="N")
    p.add_argument("--no-cuda", "--no-accel", dest="no_accel",
                   action="store_true", default=False)
    p.add_argument("--dry-run", action="store_true", default=False,
                   help="run a single batch per epoch")
    p.add_argument("--data-root", type=str, default="./data")
    p.add_argument("--sp", type=int, default=None, metavar="S",
                   help="sequence-parallel degree: ring attention over an "
                        "S-way seq group of ranks (parallel/sp.py); composes "
                        "with --tp into the 3-D (data, seq, model) step")
    p.add_argument("--sp-impl", type=str, default="ring",
                   choices=("ring", "ulysses"),
                   help="sequence-parallel strategy: 'ring' rotates k/v "
                        "blocks S-1 hops; 'ulysses' re-shards "
                        "tokens->heads with one all-to-all pair and runs "
                        "dense (or --flash) attention locally "
                        "(needs heads %% S == 0; plain --sp only)")
    p.add_argument("--tp", type=int, default=None, metavar="M",
                   help="tensor-parallel degree: Megatron-style head/MLP "
                        "sharding over an M-way model group "
                        "(parallel/tp_vit.py); composes with --sp")
    p.add_argument("--allow-degree-1", action="store_true", default=False,
                   help="take the --sp/--tp parallel code paths even at "
                        "degree 1: the groups, collectives and kernels run "
                        "on a 1-wide axis — the one-card smoke of modes "
                        "whose full degree needs more ranks")
    p.add_argument("--pp", action="store_true", default=False,
                   help="pipeline the transformer blocks across 2 stages "
                        "(parallel/pp_vit.py: microbatched GPipe schedule "
                        "over a stage group of ranks); mutually exclusive "
                        "with --sp/--tp")
    p.add_argument("--pp-microbatches", type=int, default=2, metavar="M",
                   help="microbatches per shard batch in --pp mode")
    p.add_argument("--pp-stages", type=int, default=2, metavar="S",
                   help="pipeline stage count in --pp mode: depth blocks "
                        "split into S nearly-even chunks over an S-wide "
                        "stage axis (needs --depth >= S)")
    p.add_argument("--experts", type=int, default=0, metavar="E",
                   help="switch-MoE with E experts, expert-parallel over "
                        "the data axis (models/moe.py + parallel/ep.py); "
                        "mutually exclusive with --sp/--tp/--pp")
    p.add_argument("--zero", action="store_true", default=False,
                   help="ZeRO-1 data parallelism over every rank: batch "
                        "sharded on the data axis, Adadelta state sharded "
                        "1/N (parallel/zero.py); composes with --fused "
                        "(the sharded accumulators in the captured step); "
                        "mutually exclusive with --sp/--tp/--pp/--experts")
    p.add_argument("--flash", action="store_true", default=False,
                   help="flash-attention CUDA kernel "
                        "(ops/flash_attention.py, csrc/flash_attention.cu): "
                        "the whole-forward mode on the single device, under "
                        "--zero and --experts, under --sp-impl ulysses and "
                        "--tp (local head shards), the partial (ring-hop) "
                        "mode under the --sp ring and --sp --tp; not with "
                        "--pp/--fused")
    p.add_argument("--depth", type=int, default=2, metavar="N",
                   help="transformer blocks (default: 2)")
    p.add_argument("--dim", type=int, default=64, metavar="D",
                   help="token embedding width (default: 64)")
    p.add_argument("--bf16", action="store_true", default=False,
                   help="bfloat16 activations/matmuls (params, routing, "
                        "attention accumulation, and log_softmax stay fp32)")
    p.add_argument("--remat", action="store_true", default=False,
                   help="recompute each transformer block in backward "
                        "(torch.utils.checkpoint): one live block's "
                        "activations instead of depth's, one extra forward "
                        "— single-device, --zero, --sp, and --fused paths")
    p.add_argument("--fused", action="store_true", default=False,
                   help="whole-run fusion: the dataset on the device, each "
                        "epoch's steps replayed from one CUDA graph, one "
                        "host read an epoch (parallel/fused_vit.py); "
                        "data-parallel only")
    p.add_argument("--pregather", action="store_true", default=False,
                   help="(--fused only) pre-permuted-epoch input path: "
                        "one big gather per epoch + contiguous per-step "
                        "slices (parallel/fused.py pregather; "
                        "bit-identical batches)")
    p.add_argument("--save-model", action="store_true", default=False,
                   help="save the final params to vit_mnist.npz "
                        "(utils.checkpoint.save_params_tree)")
    p.add_argument("--resume", type=str, default=None, metavar="PATH",
                   help="initialize params from a vit_mnist.npz archive "
                        "instead of random init (optimizer starts fresh)")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the whole run "
                        "into DIR (utils/profiling.trace; same surface as "
                        "the CNN CLI)")
    p.add_argument("--step-stats", action="store_true", default=False,
                   help="print per-epoch host-side step-latency summaries "
                        "(per-batch paths; the fused whole-run has no "
                        "per-step host boundary)")
    p.add_argument("--timings-json", type=str, default=None, metavar="PATH",
                   help="(--fused only) write a wall-clock attribution "
                        "JSON to PATH: compile_s (the CUDA-graph capture) / "
                        "data_s / run_s, plus accuracies and dataset "
                        "provenance (tools/vit_bench.py reads it)")
    p.add_argument("--save-state", type=str, default=None, metavar="PATH",
                   help="save the FULL training state (params, Adadelta "
                        "accumulators, step/epoch counters) at the end — "
                        "a --resume-state continuation is bit-identical "
                        "to an uninterrupted run")
    p.add_argument("--resume-state", type=str, default=None, metavar="PATH",
                   help="continue training from a --save-state archive "
                        "(schedule, shuffle stream, and epoch numbering "
                        "pick up where the save left off); layout-"
                        "portable across --zero/plain runs and with the "
                        "CNN CLI's archive format")
    return p


def resolve_mode_flags(args) -> tuple[bool, bool]:
    """Validate the mode flags and return ``(sp_on, tp_on)``, the JAX
    CLI's truth table and texts for the flags this CLI takes.  ``--sp`` and
    ``--tp`` default to None (off); a parallel path is taken at degree > 1,
    or at an explicit degree 1 under ``--allow-degree-1``.  After this call
    ``args.sp``/``args.tp`` are plain ints.  Invalid flags raise SystemExit
    with the message the CLI prints."""
    for name in ("sp", "tp"):
        v = getattr(args, name)
        if v is not None and v < 1:
            raise SystemExit(f"--{name} must be >= 1, got {v}")
    sp_on = args.sp is not None and (args.sp > 1 or args.allow_degree_1)
    tp_on = args.tp is not None and (args.tp > 1 or args.allow_degree_1)
    args.sp = args.sp or 1
    args.tp = args.tp or 1
    if args.experts > 0 and (sp_on or tp_on or args.pp):
        raise SystemExit("--experts is mutually exclusive with --sp/--tp/--pp")
    if args.pp and (sp_on or tp_on):
        raise SystemExit("--pp is mutually exclusive with --sp/--tp")
    if args.zero and (sp_on or tp_on or args.pp or args.experts > 0):
        raise SystemExit(
            "--zero is plain data parallelism; drop --sp/--tp/--pp/"
            "--experts"
        )
    if args.sp_impl != "ring" and tp_on:
        raise SystemExit(
            "--sp-impl ulysses is the plain --sp path; the 3-D --sp --tp "
            "composition rides the ring"
        )
    if args.sp_impl != "ring" and not sp_on:
        raise SystemExit(
            "--sp-impl selects the --sp strategy; add --sp N (> 1)"
        )
    if args.pp and args.pp_stages < 2:
        raise SystemExit(
            f"--pp-stages must be >= 2, got {args.pp_stages}"
        )
    if args.remat and (tp_on or args.pp or args.experts > 0):
        raise SystemExit(
            "--remat rides the single-device/--zero/--sp/--fused paths; "
            "drop --tp/--pp/--experts"
        )
    if args.flash and (args.pp or args.fused):
        raise SystemExit(
            "--flash composes with every mode except the pipeline engine "
            "and the fused whole-run; drop --pp/--fused"
        )
    if args.pregather and not args.fused:
        raise SystemExit("--pregather is the fused input path; add --fused")
    if args.timings_json and not (args.fused and not args.dry_run):
        # --dry-run demotes --fused to the per-batch loop, which writes no
        # timings: exiting 0 without PATH would read as a missing run.
        raise SystemExit(
            "--timings-json needs the fused whole-run; "
            + ("drop --dry-run" if args.fused else "add --fused")
        )
    if args.fused and (sp_on or tp_on or args.pp or args.experts > 0):
        raise SystemExit(
            "--fused is the data-parallel whole-run; drop --sp/--tp/--pp/"
            "--experts"
        )
    return sp_on, tp_on


def check_state_flags(args, modes: tuple[bool, bool]) -> None:
    """The JAX CLI's refusals of ``--save-state``/``--resume-state``
    (SystemExit with its texts)."""
    _, tp_on = modes
    if (args.resume_state or args.save_state) and (tp_on or args.pp or args.experts > 0):
        raise SystemExit(
            "--save-state/--resume-state ride the replicated-state paths "
            "(single-device, --zero, --sp, --fused); drop --tp/--pp/"
            "--experts"
        )
    if args.save_state and args.dry_run:
        raise SystemExit(
            "--dry-run trains one batch per epoch; a --save-state archive "
            "from it would misrepresent its epoch count on resume — drop one"
        )
    if args.resume_state and args.resume:
        raise SystemExit(
            "--resume (model-only) and --resume-state (full state) "
            "are mutually exclusive"
        )


def _restore(model: ViT, archive: TrainArchive, path: str) -> AdadeltaState:
    """Load the archive's params into ``model``; returns its accumulators
    in ``model``'s ``named_parameters`` order on its device.  Another
    model's tree (a CNN archive, another depth) exits with the JAX CLI's
    text, a shape of another width with its shape text."""
    want = dict(model.named_parameters())
    got = archive.params
    if sorted(got) != sorted(want) or any(sorted(t) != sorted(want) for t in archive.opt):
        raise SystemExit(
            f"--resume-state {path!r} holds a different model's parameter tree: "
            f"missing {sorted(set(want) - set(got))}, "
            f"unexpected {sorted(set(got) - set(want))}"
        )
    for key, value in got.items():
        if value.shape != want[key].shape:
            raise SystemExit(
                f"--resume-state param shape {tuple(value.shape)} does not "
                f"match this config's {tuple(want[key].shape)}"
            )
    model.load_state_dict(got)
    device = next(iter(want.values())).device
    return AdadeltaState(*({k: tree[k].to(device) for k in want} for tree in archive.opt))


def _resume(model: ViT, path: str) -> None:
    """Load a params-tree archive into ``model``; a tree of another shape
    exits, as the JAX CLI does."""
    loaded = torch_vit_state_from_jax(load_params_tree(path))
    want = model.state_dict()
    if sorted(loaded) != sorted(want):
        raise SystemExit(
            f"--resume {path!r} holds a different model's parameter tree: "
            f"missing {sorted(set(want) - set(loaded))}, "
            f"unexpected {sorted(set(loaded) - set(want))}"
        )
    for key, got in loaded.items():
        if got.shape != want[key].shape:
            raise SystemExit(
                f"--resume checkpoint shape {tuple(got.shape)} does not match "
                f"this config's {tuple(want[key].shape)}"
            )
    model.load_state_dict(loaded)


def build(args, device: torch.device, modes: tuple[bool, bool],
          world: DistState = DistState(), archive: TrainArchive | None = None):
    """The model, its state, the train and eval steps and this rank's grid
    for ``args`` (``modes`` from :func:`resolve_mode_flags`): weights from
    ``--seed`` (every rank draws the same), ``--resume`` or the
    ``--resume-state`` ``archive`` (its accumulators and step too, cut into
    this rank's chunks under ``--zero``), sharded under ``--tp`` and
    ``--experts``, and the branch's steps, in the JAX CLI's branch order.
    Under ``--fused`` (not with ``--dry-run``) every rank lies on the data
    axis, as JAX's ``make_mesh(num_model=1)``.  Forms the grid's groups
    (collective over ``world``)."""
    sp_on, tp_on = modes
    data_parallel = args.experts > 0 or args.zero or (args.fused and not args.dry_run)
    minors = ([("seq", args.sp)] * sp_on + [("model", args.tp)] * tp_on
              + [("model", args.pp_stages)] * args.pp)
    if not minors and not data_parallel and world.world_size > 1:
        raise SystemExit(
            f"the single-device ViT runs on one rank; add --sp/--tp/--pp/--experts/"
            f"--zero to lay the {world.world_size} ranks out as a grid"
        )
    grid = make_rank_grid(minors, world) if minors or data_parallel else RankGrid()
    cfg = ViTConfig(depth=args.depth, dim=args.dim, num_experts=args.experts, bf16=args.bf16,
                    remat=args.remat)
    seeds = split_streams(args.seed)
    model = ViT(cfg, select_attention(args.flash), torch.Generator().manual_seed(seeds["init"]))
    if args.resume:
        _resume(model, args.resume)
    model.to(device)
    restored = _restore(model, archive, args.resume_state) if archive is not None else None
    if tp_on:
        tp_vit.shard_vit_tp(model, grid.model)
    if args.experts > 0:
        ep.shard_ep(model, grid.data)
    state = TrainState(opt=adadelta_init(dict(model.named_parameters())))
    if sp_on and tp_on:
        step_fn = sp3.make_sp3_train_step(cfg, grid, use_flash=args.flash)
        eval_fn = sp3.make_sp3_eval_step(cfg, grid, use_flash=args.flash)
    elif tp_on:
        step_fn = tp_vit.make_vit_tp_train_step(cfg, grid, use_flash=args.flash)
        eval_fn = tp_vit.make_vit_tp_eval_step(cfg, grid, use_flash=args.flash)
    elif args.pp:
        step_fn = pp_vit.make_vit_pp_train_step(cfg, grid, num_micro=args.pp_microbatches)
        eval_fn = make_forward_eval_step(lambda m, x: m(x), grid.data)
    elif sp_on:
        step_fn = sp.make_sp_train_step(cfg, grid, use_flash=args.flash, impl=args.sp_impl)
        eval_fn = sp.make_sp_eval_step(cfg, grid, use_flash=args.flash, impl=args.sp_impl)
    elif args.experts > 0:
        step_fn = ep.make_ep_train_step(cfg, grid, use_flash=args.flash)
        eval_fn = ep.make_ep_eval_step(cfg, grid, use_flash=args.flash)
    else:  # the single device, --zero and --fused: data parallelism over grid.data
        if args.zero:
            state = TrainState(opt=zero_init(dict(model.named_parameters()), grid.data))
        step_fn = make_forward_train_step(lambda m, x: m(x), grid=grid)
        eval_fn = make_forward_eval_step(lambda m, x: m(x), grid.data)
    if restored is not None:  # the replicated-state paths alone
        state = TrainState(opt=per_leaf_opt_to_zero(restored, grid.data) if args.zero
                           else restored, step=archive.step)
    return model, state, step_fn, eval_fn, grid


def fit(
    args,
    modes: tuple[bool, bool],
    device: str | torch.device | None = None,
    save_path: str | None = None,
    timings: dict | None = None,
    world: DistState = DistState(),
) -> tuple[ViT, TrainState]:
    """The full run on this rank of ``world`` (formed and torn down by the
    caller); returns the trained model (this rank's shards under
    ``--tp`` and ``--experts``) and its state.  ``modes`` is :func:`resolve_mode_flags`'
    result for ``args``.  ``device`` ``None`` means the card, and raises
    without one.  TF32 is switched off (process-wide); ``timings`` is
    ``trainer.run_epochs``'s.  ``--resume-state`` loads before any data
    or device work; ``--save-state`` writes after the last epoch, the
    chief alone (under ``--zero`` after a collective gather);
    ``--profile`` traces the whole run.  ``--fused`` (not with
    ``--dry-run``, which stays on the per-batch loop) runs
    :func:`run_fused`."""
    check_state_flags(args, modes)
    device = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    archive, epoch0 = (load_vit_train_state(args.resume_state) if args.resume_state
                       else (None, 0))
    fused = args.fused and not args.dry_run
    if fused and timings is None:
        timings = {}
    with trace(args.profile, device):
        model, state, step_fn, eval_fn, grid = build(args, device, modes, world, archive)
        loaders = make_shard_loaders(args, device, grid.coords[0], grid.num_data, timings)
        if fused:
            run_fused(args, device, model, state, grid, loaders, timings, epoch0, world)
        else:
            run_epochs(args, device, model, state, step_fn, eval_fn, loaders, timings,
                       dry_run_eval=args.dry_run, epoch0=epoch0, dist=world)
        if args.save_model and save_path:
            # the gathers are collective
            if modes[1]:
                full = tp_vit.gather_vit_tp_state(model, grid.model)
            elif args.experts > 0:
                full = ep.gather_ep_state(model, grid.data)
            else:
                full = model.state_dict()
            if world.is_chief:
                save_params_tree(jax_vit_tree_from_torch(full), save_path)
        if args.save_state:
            params = dict(model.named_parameters())
            opt = (zero_opt_to_per_leaf(state.opt, params, grid.data) if args.zero
                   else state.opt)
            if world.is_chief:
                save_vit_train_state(params, opt, state.step, args.save_state,
                                     epoch=epoch0 + args.epochs)
    return model, state


def run_fused(args, device: torch.device, model: ViT, state: TrainState, grid: RankGrid,
              loaders, timings: dict, epoch0: int = 0, world: DistState = DistState()) -> None:
    """``--fused``: the epochs over device-resident sets
    (``parallel/fused_vit.py``), each step replayed from one CUDA graph on
    the card, the lines printed by ``trainer.run_fused_epochs`` from one
    host read an epoch, the per-batch run's byte for byte.  ``timings``
    (:func:`~.trainer.make_shard_loaders`') gains JAX's attribution keys
    (:data:`TIMINGS_KEYS`), which ``--timings-json`` writes from the chief:

    - ``compile_s``: the CUDA-graph capture, the port's counterpart of
      JAX's AOT lower+compile (this path builds no kernel library);
    - ``data_s``: the upload of both sets and their tables, the device
      synchronized;
    - ``run_s``: each epoch's window from its first step to its host read
      (training, evaluation and the read), summed over the epochs, less
      ``compile_s``, which the first epoch's window holds; the prints
      between epochs stay out, as JAX prints after its one call;
    - ``dataset``: the loader's ``"idx"``/``"synthetic"`` label.

    ``--step-stats`` prints nothing here, as in JAX: there is no step on
    the host to time."""
    t0 = time.perf_counter()
    run = make_fused_vit_run(model, state, *loaders, grid, pregather=args.pregather)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    data_s = time.perf_counter() - t0
    walls = timings.setdefault("epoch_wall_s", [])
    first = len(walls)
    run_fused_epochs(args, run, loaders, timings, epoch0, world)
    compile_s = run.train.capture_s
    timings.update(compile_s=compile_s, data_s=data_s, run_s=sum(walls[first:]) - compile_s,
                   epochs=args.epochs, n_shards=grid.num_data, depth=model.cfg.depth,
                   dim=model.cfg.dim)
    if args.timings_json and world.is_chief:
        with open(args.timings_json, "w") as f:
            json.dump({k: timings[k] for k in TIMINGS_KEYS}, f)


def main(argv: list[str] | None = None) -> None:
    start = time.time()
    args = build_parser().parse_args(argv)
    modes = resolve_mode_flags(args)  # before the world forms
    device = "cpu" if args.no_accel else None
    world = form_world(device=device)
    try:
        # Only rank 0 prints, as the JAX CLI is one process.
        with contextlib.ExitStack() as quiet:
            if not world.is_chief:
                quiet.enter_context(contextlib.redirect_stdout(
                    quiet.enter_context(open(os.devnull, "w"))))
            fit(args, modes, device, SAVE_PATH, world=world)
            print(total_time_line(time.time() - start))
    finally:
        destroy_distributed()


if __name__ == "__main__":
    main()
