"""ViT-family MNIST training CLI, the port's counterpart of the root
``vit_mnist.py``:

    python -m pytorch_mnist_ddp_tpu_torch.vit_mnist [flags]
    python -m pytorch_mnist_ddp_tpu_torch.vit_mnist --flash            # attention kernel
    python -m pytorch_mnist_ddp_tpu_torch.vit_mnist --sp 1 --allow-degree-1 --flash
    python -m pytorch_mnist_ddp_tpu_torch.vit_mnist --bf16 --flash     # bf16 trunk

It runs on the card (``cuda``) unless ``--no-cuda``/``--no-accel`` asks for
the CPU, and raises without a card otherwise.  Two branches: the single
device (``--flash``: the whole-forward kernel in every block), and the
sequence-parallel ring at degree 1 (``parallel/sp.py``; ``--flash``: one
partial-mode kernel launch per attention call); ``--bf16`` runs either in
bfloat16 (the kernel's bf16 mode under ``--flash``).  The flags are a subset of
``vit_mnist.py``'s with the same names and defaults; argparse refuses the
others.  The printed lines are the JAX CLI's, and ``--save-model`` writes
``vit_mnist.npz`` in the JAX package's params-tree format.
"""

from __future__ import annotations

import argparse
import time

import torch

from .device import resolve_device
from .models.vit import ViT, ViTConfig
from .ops.adadelta import adadelta_init
from .ops.flash_attention import select_attention
from .parallel import sp
from .parallel.ddp import TrainState, make_forward_eval_step, make_forward_train_step
from .trainer import make_loaders, run_epochs
from .utils.checkpoint import load_params_tree, model_state_dict, save_params_tree
from .utils.convert import jax_vit_tree_from_torch, torch_vit_state_from_jax
from .utils.logging import total_time_line
from .utils.rng import split_streams

SAVE_PATH = "vit_mnist.npz"


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
                        "S-way sequence group (parallel/sp.py); only 1, "
                        "with --allow-degree-1, is ported so far")
    p.add_argument("--allow-degree-1", action="store_true", default=False,
                   help="take the --sp code path even at degree 1: the ring "
                        "and its kernel run on a group of one — the "
                        "one-card smoke of the sequence-parallel mode")
    p.add_argument("--flash", action="store_true", default=False,
                   help="flash-attention CUDA kernel "
                        "(ops/flash_attention.py, csrc/flash_attention.cu): "
                        "the whole-forward mode on the single device, the "
                        "partial (ring-hop) mode under --sp")
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
                        "activations instead of depth's, one extra forward")
    p.add_argument("--save-model", action="store_true", default=False,
                   help="save the final params to vit_mnist.npz "
                        "(utils.checkpoint.save_params_tree)")
    p.add_argument("--resume", type=str, default=None, metavar="PATH",
                   help="initialize params from a vit_mnist.npz archive "
                        "instead of random init (optimizer starts fresh)")
    return p


def resolve_mode_flags(args) -> bool:
    """Validate the mode flags and return ``sp_on``.  ``--sp`` defaults to
    None (off); the ring is taken at an explicit degree 1 under
    ``--allow-degree-1``.  After this call ``args.sp`` is a plain int.
    Invalid flags raise SystemExit with the message the CLI prints."""
    if args.sp is not None and args.sp < 1:
        raise SystemExit(f"--sp must be >= 1, got {args.sp}")
    if args.sp is not None and args.sp > 1:
        raise SystemExit(sp.MULTI_RANK_MESSAGE)
    sp_on = args.sp is not None and args.allow_degree_1
    args.sp = args.sp or 1
    return sp_on


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


def fit(
    args,
    device: str | torch.device | None = None,
    save_path: str | None = None,
    timings: dict | None = None,
) -> tuple[ViT, TrainState]:
    """The full run; returns the trained model and its state.  ``device``
    ``None`` means the card, and raises without one.  TF32 is switched off
    (process-wide); ``timings`` is ``trainer.run_epochs``'s."""
    sp_on = resolve_mode_flags(args)
    device = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = ViTConfig(depth=args.depth, dim=args.dim, bf16=args.bf16, remat=args.remat)
    seeds = split_streams(args.seed)
    model = ViT(cfg, select_attention(args.flash), torch.Generator().manual_seed(seeds["init"]))
    if args.resume:
        _resume(model, args.resume)
    model.to(device)
    state = TrainState(opt=adadelta_init(dict(model.named_parameters())))
    if sp_on:
        group = sp.make_seq_group(args.sp)
        step_fn = sp.make_sp_train_step(cfg, group, use_flash=args.flash)
        eval_fn = sp.make_sp_eval_step(cfg, group, use_flash=args.flash)
    else:
        step_fn = make_forward_train_step(lambda m, x: m(x))
        eval_fn = make_forward_eval_step(lambda m, x: m(x))
    loaders = make_loaders(args, device, timings)
    run_epochs(args, device, model, state, step_fn, eval_fn, loaders, timings,
               dry_run_eval=args.dry_run)
    if args.save_model and save_path:
        save_params_tree(jax_vit_tree_from_torch(model_state_dict(model)), save_path)
    return model, state


def main(argv: list[str] | None = None) -> None:
    start = time.time()
    args = build_parser().parse_args(argv)
    fit(args, "cpu" if args.no_accel else None, save_path=SAVE_PATH)
    print(total_time_line(time.time() - start))


if __name__ == "__main__":
    main()
