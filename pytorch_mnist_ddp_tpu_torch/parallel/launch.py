"""Launcher CLI, the port's ``torch.distributed.launch``:

    python -m pytorch_mnist_ddp_tpu_torch.parallel.launch --nproc_per_node=4 \\
        -m pytorch_mnist_ddp_tpu_torch.mnist_ddp --batch-size 200 --epochs 20

It starts ``--nproc_per_node`` processes on this node, one per card, as
``torch.distributed.launch`` does (the JAX package's launcher instead
runs one process driving that many devices), each with the reference's
environment: ``RANK`` (``node_rank * nproc_per_node + local rank``),
``WORLD_SIZE`` (``nnodes * nproc_per_node``), ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``, and the bounded-rendezvous
``RDZV_TIMEOUT_S``/``RDZV_ATTEMPTS`` that ``init_distributed_mode`` reads.
The program is a script path, or a module with ``-m``.

It supervises the ranks: SIGTERM and SIGINT are forwarded to every rank;
when a rank exits non-zero the others are stopped (SIGTERM, then SIGKILL
after a grace period), so none waits on a collective with a dead peer,
and the launcher exits with that rank's code (``128 + signum`` for a
rank killed by a signal).  The JAX launcher's supervision flags
(``--restart-budget``, heartbeats, backoff, ``--telemetry-dir``,
``--nprocs``, ``--backend``) are not ported; argparse refuses them.
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time

GRACE_S = 5.0  # SIGTERM to SIGKILL when stopping the survivors of a failed rank
POLL_S = 0.05


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_mnist_ddp_tpu_torch.parallel.launch",
        description="Start one training process per card (torch.distributed.launch)",
    )
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="processes to start on this node, one per card, as "
                        "torch.distributed.launch counts them (the JAX "
                        "package's launcher reads it as devices per process)")
    p.add_argument("--nnodes", type=int, default=1, help="nodes in the world")
    p.add_argument("--node_rank", type=int, default=0, help="this node's rank")
    p.add_argument("--master_addr", type=str, default="127.0.0.1",
                   help="rank 0's host, exported as MASTER_ADDR")
    p.add_argument("--master_port", type=str, default="29500",
                   help="rank 0's rendezvous port, exported as MASTER_PORT")
    p.add_argument("--rdzv-timeout-s", type=float, default=60.0, metavar="S",
                   help="total rendezvous budget exported to the children: "
                        "world formation fails (with a pointed diagnostic) "
                        "instead of hanging past it")
    p.add_argument("--rdzv-attempts", type=int, default=2, metavar="K",
                   help="bounded rendezvous attempts within the budget "
                        "(retry/backoff between them)")
    p.add_argument("-m", "--module", action="store_true",
                   help="run the program as a module (python -m)")
    p.add_argument("program", type=str, help="the script path, or the module with -m")
    p.add_argument("program_args", nargs=argparse.REMAINDER)
    return p


def _child_env(args, local_rank: int) -> dict[str, str]:
    env = dict(os.environ)
    env.update({
        "RANK": str(args.node_rank * args.nproc_per_node + local_rank),
        "WORLD_SIZE": str(args.nnodes * args.nproc_per_node),
        "LOCAL_RANK": str(local_rank),
        "MASTER_ADDR": args.master_addr,
        "MASTER_PORT": str(args.master_port),
        "RDZV_TIMEOUT_S": str(args.rdzv_timeout_s),
        "RDZV_ATTEMPTS": str(args.rdzv_attempts),
    })
    return env


def _exit_code(returncode: int) -> int:
    """A rank's code as a shell reports it: ``128 + signum`` for a signal."""
    return 128 - returncode if returncode < 0 else returncode


def _signal_all(procs: list[subprocess.Popen], signum: int) -> None:
    for proc in procs:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signum)
            except ProcessLookupError:
                pass


def supervise(procs: list[subprocess.Popen], grace_s: float = GRACE_S) -> int:
    """Wait for every rank; on the first non-zero exit stop the rest.
    Returns the launcher's exit code."""
    failed = None
    while failed is None:
        codes = [proc.poll() for proc in procs]
        if all(code == 0 for code in codes):
            return 0
        failed = next((code for code in codes if code not in (None, 0)), None)
        if failed is None:
            time.sleep(POLL_S)
    _signal_all(procs, signal.SIGTERM)
    deadline = time.monotonic() + grace_s
    while any(proc.poll() is None for proc in procs) and time.monotonic() < deadline:
        time.sleep(POLL_S)
    _signal_all(procs, signal.SIGKILL)
    for proc in procs:
        proc.wait()
    return _exit_code(failed)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.nproc_per_node < 1 or args.nnodes < 1:
        raise SystemExit("--nproc_per_node and --nnodes must be at least 1")
    cmd = [sys.executable, *(["-m"] if args.module else []), args.program,
           *args.program_args]
    procs: list[subprocess.Popen] = []

    def forward(signum, _frame):
        _signal_all(procs, signum)

    previous = {s: signal.signal(s, forward) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        for local_rank in range(args.nproc_per_node):
            # A session of its own per rank: a signal reaches the rank's
            # whole process group, and a terminal's Ctrl-C reaches the
            # ranks only through the launcher.
            procs.append(subprocess.Popen(cmd, env=_child_env(args, local_rank),
                                          start_new_session=True))
        return supervise(procs)
    finally:
        _signal_all(procs, signal.SIGKILL)
        for s, handler in previous.items():
            signal.signal(s, handler)


if __name__ == "__main__":
    sys.exit(main())
