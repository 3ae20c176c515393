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
keeps in flight.  ``--telemetry-dir`` writes JSONL events and a
Prometheus file; the resilient runtime's flags (``--checkpoint-every-steps``,
``--preempt-grace-s``, ``--loss-guard`` and its ``--spike-factor``/
``--anomaly-*``, ``--step-timeout-s``/``--stall-abort``) and ``--chaos``
(a fault schedule, ``serving/faults.py``) are the JAX CLI's, with its
defaults; an exhausted anomaly budget ends the run with one diagnostic
on stderr and exit 70.
"""

from __future__ import annotations

import argparse
import sys

from .resilience import EXIT_ANOMALY, AnomalyBudgetExhausted
from .serving import faults
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
    p.add_argument("--telemetry-dir", type=str, default=None, metavar="DIR",
                   help="write structured telemetry into DIR: JSONL "
                        "step/epoch/eval events (chief-only in distributed "
                        "mode) plus a Prometheus text exposition "
                        "(metrics.prom) at end of run; stdout is unchanged")
    # The resilient training runtime (resilience/).  All default to off:
    # the flagless run builds none of it and prints the same lines.
    p.add_argument("--checkpoint-every-steps", type=int, default=0,
                   metavar="N",
                   help="write a mid-epoch full-state archive to the "
                        "--save-state path every N optimizer steps, with a "
                        "rotating last/last-1 publish so a kill at ANY "
                        "point (including mid-save) leaves a loadable "
                        "archive; --resume-state continues bit-identically "
                        "from the exact batch cursor.  SIGTERM/SIGINT also "
                        "land an emergency archive at the next step "
                        "boundary and exit 128+signum (per-batch DP paths; "
                        "requires --save-state)")
    p.add_argument("--preempt-grace-s", type=float, default=30.0,
                   metavar="S",
                   help="bounded grace for the emergency save after "
                        "SIGTERM/SIGINT: if the clean save+exit has not "
                        "finished in S seconds the process force-exits "
                        "with the same code (default: 30)")
    p.add_argument("--loss-guard", action="store_true", default=False,
                   help="guard each step's loss (NaN/Inf or a spike over "
                        "the accepted-loss EWMA): the poisoned update is "
                        "rolled back from a pre-step snapshot and retried "
                        "— first at the original LR (a transient anomaly "
                        "heals with zero numeric divergence), then with "
                        "LR backoff — aborting with one diagnostic when "
                        "--anomaly-budget is exhausted.  Syncs the loss to "
                        "host every step (the --step-stats trade)")
    p.add_argument("--spike-factor", type=float, default=10.0, metavar="F",
                   help="--loss-guard spike threshold: loss > F x EWMA of "
                        "accepted losses is an anomaly; 0 disables spike "
                        "detection (NaN/Inf only; default: 10)")
    p.add_argument("--anomaly-budget", type=int, default=3, metavar="K",
                   help="rollback-and-retry attempts per step before the "
                        "run aborts (default: 3)")
    p.add_argument("--anomaly-lr-backoff", type=float, default=0.5,
                   metavar="F",
                   help="LR multiplier applied from the second retry of an "
                        "anomalous step on (the first retry keeps the "
                        "original LR so a transient heals bit-exactly; "
                        "default: 0.5)")
    p.add_argument("--step-timeout-s", type=float, default=0.0, metavar="S",
                   help="hung-step watchdog: emit a train_stall event (and "
                        "train_stalls_total) when a step exceeds S seconds "
                        "(includes the first step — budget for it); 0 "
                        "disables.  Enabling syncs each step's output to "
                        "host (the watchdog needs a completion signal to "
                        "watch)")
    p.add_argument("--stall-abort", action="store_true", default=False,
                   help="with --step-timeout-s: exit 75 (EX_TEMPFAIL) on a "
                        "stalled step after flushing telemetry, instead of "
                        "only reporting it")
    p.add_argument("--chaos", type=str, default=None, metavar="SPEC",
                   help="deterministic fault injection for the trainer "
                        "(serving/faults.py grammar; sites step/data_next/"
                        "ckpt_save, ops fail/hang/kill/nan — e.g. "
                        "'kill:step:after=7' or 'nan:step:after=5')")
    p.add_argument("--chaos-seed", type=int, default=0, metavar="S",
                   help="seed for probabilistic (p=) chaos triggers")
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


def run_cli(args, body) -> None:
    """The CLIs' shared tail: install ``--chaos``'s schedule (if any), run
    ``body()``, and turn an exhausted anomaly budget into one diagnostic on
    stderr and exit ``EXIT_ANOMALY`` instead of a traceback.  The schedule
    is uninstalled at the end, so an in-process caller keeps none."""
    if getattr(args, "chaos", None):
        faults.install(faults.FaultInjector(args.chaos, seed=getattr(args, "chaos_seed", 0))
                       ).start()
    try:
        body()
    except AnomalyBudgetExhausted as e:
        print(f"fatal: {e}", file=sys.stderr)
        raise SystemExit(EXIT_ANOMALY)
    finally:
        if getattr(args, "chaos", None):
            faults.uninstall()


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    # The reference saves to mnist_cnn.pt (mnist.py:133).
    run_cli(args, lambda: fit(args, "cpu" if args.no_accel else None,
                              save_path="mnist_cnn.pt"))


if __name__ == "__main__":
    main()
