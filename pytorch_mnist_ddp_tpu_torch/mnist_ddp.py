"""Distributed MNIST training CLI, the port's counterpart of the root
``mnist_ddp.py`` (the reference's ``mnist_ddp.py``):

    python -m pytorch_mnist_ddp_tpu_torch.parallel.launch --nproc_per_node=4 \\
        -m pytorch_mnist_ddp_tpu_torch.mnist_ddp --batch-size 200 --epochs 20
    python -m pytorch_mnist_ddp_tpu_torch.mnist_ddp [flags]   # a world of one

It takes the port's ``mnist.py`` flags plus the DDP ones (``--local_rank``,
``--world-size``, ``--dist-url``, ``--rdzv-timeout-s``,
``--rdzv-attempts``, ``--tp``, ``--pp``, ``--pp-microbatches``,
``--syncbn``, ``--zero``), with the JAX CLI's help text.  ``--zero``
shards the Adadelta state over the ranks (``parallel/zero.py``) and is
refused with ``--pallas-opt``, with the JAX trainer's text.  ``--tp N``
shards the dense head over N ranks of a model group (``parallel/tp.py``)
and ``--pp`` pipelines the two stages over two (``parallel/pp.py``); both
need a world of more than one rank and refuse what the JAX trainer
refuses with them.  The telemetry, resilience and ``--chaos`` flags are
``mnist.py``'s; ``--loss-guard`` is refused on more than one process,
with the JAX trainer's text.  ``RANK``/``WORLD_SIZE``
(the launcher's) or ``SLURM_PROCID`` in the environment make this process
one rank of a world (``parallel/distributed.py``): NCCL on the card,
gloo with ``--no-cuda``.  Without them it prints "Not using distributed
mode" and trains alone.  ``--batch-size`` is per rank.  ``--save-model``
writes ``mnist_cnn.pt`` in distributed mode and ``mnist_cnn_.pt``
otherwise, the reference's quirk.  Every process ends with the
reference's wall-clock line.
"""

from __future__ import annotations

import argparse
import time

from .mnist import build_parser as mnist_parser
from .mnist import run_cli
from .parallel.distributed import init_distributed_mode
from .trainer import fit
from .utils.logging import total_time_line


def build_parser() -> argparse.ArgumentParser:
    p = mnist_parser()
    p.prog = "python -m pytorch_mnist_ddp_tpu_torch.mnist_ddp"
    # --local_rank is accepted for launcher compatibility, but the
    # environment wins, as in the reference (declared, never read).
    p.add_argument("--local_rank", type=int, default=0,
                   help="accepted for launcher compatibility; env wins")
    p.add_argument("--world-size", type=int, default=1,
                   help="number of processes (env WORLD_SIZE wins)")
    p.add_argument("--dist-url", type=str, default="env://",
                   help="rendezvous URL for multi-host init")
    p.add_argument("--rdzv-timeout-s", type=float, default=None, metavar="S",
                   help="total rendezvous budget: world formation fails "
                        "with a pointed diagnostic instead of hanging past "
                        "it (default: the launcher's RDZV_TIMEOUT_S env, "
                        "else 60)")
    p.add_argument("--rdzv-attempts", type=int, default=None, metavar="K",
                   help="bounded rendezvous attempts within the budget "
                        "(default: RDZV_ATTEMPTS env, else 2)")
    p.add_argument("--tp", type=int, default=1, metavar="N",
                   help="tensor-parallel degree: shard the dense head over "
                        "N model-axis ranks (data axis = ranks / N)")
    p.add_argument("--pp", action="store_true",
                   help="pipeline the two stages (convs | dense head) over "
                        "a 2-wide model axis of ranks, microbatched")
    p.add_argument("--pp-microbatches", type=int, default=2, metavar="M",
                   help="microbatches per shard batch in --pp mode")
    p.add_argument("--syncbn", action="store_true",
                   help="add BatchNorm after each conv with batch statistics "
                        "synced across the data axis (torch.nn.SyncBatchNorm "
                        "semantics; the scaled-batch config of BASELINE.json)")
    p.add_argument("--zero", action="store_true",
                   help="ZeRO-1 data parallelism: shard the Adadelta state "
                        "1/N over the data axis (reduce-scatter gradients, "
                        "shard-local update, all-gather deltas) instead of "
                        "replicating it; numerics match plain DP")
    return p


def run(args, timings: dict | None = None):
    """The CLI's body for parsed ``args``: form the world, train, save;
    returns ``fit``'s model and state (``timings`` is ``fit``'s)."""
    device = "cpu" if args.no_accel else None
    dist = init_distributed_mode(args.dist_url, args.rdzv_timeout_s, args.rdzv_attempts,
                                 device=device)
    # The reference saves mnist_cnn.pt distributed and mnist_cnn_.pt not
    # (mnist_ddp.py:193-197).
    return fit(args, device, "mnist_cnn.pt" if dist.distributed else "mnist_cnn_.pt",
               timings, dist)


def main(argv: list[str] | None = None) -> None:
    start = time.time()
    args = build_parser().parse_args(argv)
    run_cli(args, lambda: run(args))
    print(total_time_line(time.time() - start))


if __name__ == "__main__":
    main()
