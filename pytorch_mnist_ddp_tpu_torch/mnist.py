"""Single-device MNIST training CLI, the port's counterpart of the root
``mnist.py``:

    python -m pytorch_mnist_ddp_tpu_torch.mnist [flags]

It runs on the card (``cuda``) unless ``--no-cuda``/``--no-accel`` asks for
the CPU, and raises without a card otherwise.  The flags it takes are a
subset of ``mnist.py``'s, with the same names, defaults and meaning;
argparse refuses the others.  The printed lines are ``mnist.py``'s, byte
for byte, and ``--save-model`` writes ``mnist_cnn.pt``.  Training always
shuffles, as the JAX package does.  ``--save-state`` archives are the
JAX package's format: either package resumes the other's.  ``--profile
DIR`` writes a ``torch.profiler`` trace of the run, ``--step-stats`` one
latency line an epoch.  ``--fused`` (with ``--pregather``) trains over a
device-resident dataset, each step replayed from a CUDA graph;
``--prefetch-depth`` sets how many batches the per-batch path's loader
keeps in flight.
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
    p.add_argument("--resume", type=str, default=None, metavar="PATH",
                   help="load model parameters (and BN running statistics, "
                        "if present) from a saved checkpoint (.pt or .npz) "
                        "and continue training; the optimizer starts fresh "
                        "(the checkpoint format stores only the model, "
                        "like the reference's)")
    p.add_argument("--save-state", type=str, default=None, metavar="PATH",
                   help="save the FULL training state (params, Adadelta "
                        "accumulators, step/epoch counters, BN stats) at the end of "
                        "the run, in the JAX package's archive format; "
                        "--resume-state continues from it bit-identically")
    p.add_argument("--resume-state", type=str, default=None, metavar="PATH",
                   help="restore a --save-state archive (of either package) "
                        "and train --epochs MORE epochs, continuing the LR "
                        "schedule, shuffle stream, and epoch numbering "
                        "exactly where the saved run stopped")
    p.add_argument("--fused", action="store_true", default=False,
                   help="run the training epochs over a device-resident "
                        "dataset, each step replayed from one CUDA graph "
                        "(parallel/fused.py; same printed output, emitted "
                        "after each epoch)")
    p.add_argument("--pregather", action="store_true", default=False,
                   help="(--fused only) pre-permuted-epoch input path: one "
                        "big gather per epoch + contiguous per-step slices "
                        "(parallel/fused.py pregather; bit-identical "
                        "batches)")
    p.add_argument("--conv-impl", type=str, default="conv",
                   choices=["conv", "im2col_c1", "im2col"],
                   help="convolution lowering (models/net.py): cuDNN's "
                        "native conv (default), or GEMM-lowered via im2col "
                        "for conv1 only / both convs; same params, same "
                        "math, different reduction tree")
    p.add_argument("--pallas-opt", action="store_true", default=False,
                   help="use the fused Adadelta kernel for the optimizer "
                        "update (ops/adadelta_flat.py, csrc/adadelta.cu)")
    p.add_argument("--bf16", action="store_true", default=False,
                   help="bfloat16 activations/matmuls (params, optimizer "
                        "state, and log_softmax/NLL stay fp32)")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the run into DIR "
                        "(a Chrome trace, also read by TensorBoard's "
                        "profiler plugin; utils/profiling.py)")
    p.add_argument("--step-stats", action="store_true", default=False,
                   help="print per-epoch host-side step latency summaries "
                        "(per-batch path only)")
    p.add_argument("--elastic", action="store_true", default=False,
                   help="elastic-restart contract: when the --save-state "
                        "archive already exists, resume from it and read "
                        "--epochs as the TOTAL target (a gang restart "
                        "gets this automatically via ELASTIC_RESTART_COUNT)")
    p.add_argument("--resume-reshard", action="store_true", default=False,
                   help="accept a mid-epoch archive saved at a DIFFERENT "
                        "world size: same seed + global batch consume the "
                        "exact same global batches over the new rank "
                        "count (sampler contract) — a sample-exact "
                        "continuation with FP-level drift (reductions "
                        "re-associate), not bit-equality; without this "
                        "flag the world-fingerprint mismatch is refused")
    p.add_argument("--prefetch-depth", type=int, default=2, metavar="N",
                   help="input batches assembled and copied to the device "
                        "ahead of the step loop (per-batch path; "
                        "data/prefetch.py): 2 double-buffers the next "
                        "batch's copy under the current step, 0 restores "
                        "the synchronous serial feed; batches (and all "
                        "printed output) are bit-identical either way. "
                        "The --fused path keeps the whole dataset on the "
                        "device, so the flag is a no-op there")
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
