"""Single-device MNIST training CLI, the port's counterpart of the root
``mnist.py``:

    python -m pytorch_mnist_ddp_tpu_torch.mnist [flags]

It runs on the card (``cuda``) unless ``--no-cuda``/``--no-accel`` asks for
the CPU, and raises without a card otherwise.  The flags it takes are a
subset of ``mnist.py``'s, with the same names, defaults and meaning;
argparse refuses the others.  The printed lines are ``mnist.py``'s, byte
for byte, and ``--save-model`` writes ``mnist_cnn.pt``.  Training always
shuffles, as the JAX package does.
"""

from __future__ import annotations

import argparse

from .trainer import fit


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_mnist_ddp_tpu_torch.mnist",
        description="PyTorch/CUDA MNIST example",
    )
    p.add_argument("--batch-size", type=int, default=64, metavar="N",
                   help="training batch size (default: 64)")
    p.add_argument("--test-batch-size", type=int, default=1000, metavar="N",
                   help="eval batch size (default: 1000)")
    p.add_argument("--epochs", type=int, default=14, metavar="N",
                   help="number of epochs (default: 14)")
    p.add_argument("--lr", type=float, default=1.0, metavar="LR",
                   help="learning rate (default: 1.0)")
    p.add_argument("--gamma", type=float, default=0.7, metavar="M",
                   help="lr decay factor per epoch (default: 0.7)")
    p.add_argument("--no-cuda", "--no-accel", dest="no_accel",
                   action="store_true", default=False,
                   help="force CPU (accepts the reference's --no-cuda)")
    p.add_argument("--dry-run", action="store_true", default=False,
                   help="run a single batch per epoch")
    p.add_argument("--seed", type=int, default=1, metavar="S",
                   help="random seed (default: 1)")
    p.add_argument("--log-interval", type=int, default=10, metavar="N",
                   help="batches between train log lines (default: 10)")
    p.add_argument("--save-model", action="store_true", default=False,
                   help="save the final model checkpoint")
    p.add_argument("--pallas-opt", action="store_true", default=False,
                   help="use the fused Adadelta kernel for the optimizer "
                        "update (ops/adadelta_flat.py, csrc/adadelta.cu)")
    p.add_argument("--data-root", type=str, default="./data",
                   help="MNIST IDX directory")
    p.add_argument("--train-limit", type=int, default=0, metavar="N",
                   help="smoke-only: truncate train/test sets to N samples "
                        "(exercises the full program shape in seconds; "
                        "never a headline number)")
    return p


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    # The reference saves to mnist_cnn.pt (mnist.py:133).
    fit(args, "cpu" if args.no_accel else None, save_path="mnist_cnn.pt")


if __name__ == "__main__":
    main()
