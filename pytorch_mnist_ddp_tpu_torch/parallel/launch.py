"""Supervising launcher CLI, the port's ``torch.distributed.launch``:

    python -m pytorch_mnist_ddp_tpu_torch.parallel.launch --nproc_per_node=4 \\
        -m pytorch_mnist_ddp_tpu_torch.mnist_ddp --batch-size 200 --epochs 20

It starts one process per rank, each with the reference's environment:
``RANK`` (``node_rank * local + local rank``), ``WORLD_SIZE`` (``nnodes *
local``), ``LOCAL_RANK`` (the card it drives), ``MASTER_ADDR``/
``MASTER_PORT``, and the bounded-rendezvous ``RDZV_TIMEOUT_S``/
``RDZV_ATTEMPTS`` that ``init_distributed_mode`` reads.  The program is a
script path, or a module with ``-m``.

How many processes: here one process drives one card, as in
``torch.distributed.launch``, while the JAX package's launcher runs
``--nprocs`` processes on this host that each drive ``--nproc_per_node``
devices.  The port starts ``local = --nprocs * --nproc_per_node``
processes on this node, one card each, so a command line gives the world
the JAX launcher gives: as many ranks as the JAX world has devices, the
same data-parallel degree.  ``--nprocs`` with ``--nnodes`` is refused
with the JAX launcher's text.

It supervises the ranks (``parallel/elastic.py`` ``GangSupervisor``):

- SIGTERM/SIGINT to the launcher reach every rank's process group, so
  the trainer's emergency save (``--checkpoint-every-steps``) fires
  through the launcher, and the launcher exits ``128 + signum``;
- a dead rank (or with ``--heartbeat-timeout-s`` a rank whose
  step-boundary heartbeat went silent) stops the others (SIGTERM, then
  SIGKILL after ``--grace-s``), and with ``--restart-budget K`` the world
  is restarted after a seeded exponential backoff, at most K times, then
  one diagnostic and exit 69.  Restarted ranks see
  ``ELASTIC_RESTART_COUNT`` (the trainer resumes its own ``--save-state``
  archive) and run the command without its ``--chaos`` clauses;
- without ``--nprocs`` and with no budget it is transparent, as
  ``torch.distributed.launch``: the survivors are stopped and the
  launcher exits with the failed rank's code (``128 + signum`` for a
  signal).  With ``--nprocs`` and no budget a dead rank is the JAX
  launcher's exhausted gang: one diagnostic and exit 69.

``--telemetry-dir DIR`` writes ``DIR/launcher.prom`` and
``DIR/events-launcher.jsonl`` and exports DIR to the ranks for their
rendezvous events.  ``--backend cpu`` hides every card from the ranks
(``CUDA_VISIBLE_DEVICES`` empty): the JAX launcher's forced CPU platform;
the rank programs are then asked for the CPU (``--no-cuda``), as always.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

from .elastic import (
    ENV_HEARTBEAT_FILE,
    ENV_RDZV_ATTEMPTS,
    ENV_RDZV_TIMEOUT_S,
    ENV_RESTART_COUNT,
    ENV_TELEMETRY_DIR,
    GangSupervisor,
    heartbeat_path,
    strip_chaos_args,
)

BACKENDS = ("cpu", "cuda")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m pytorch_mnist_ddp_tpu_torch.parallel.launch",
        description="Start and supervise one training process per card "
                    "(torch.distributed.launch)",
    )
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="processes to start on this node, one per card, as "
                        "torch.distributed.launch counts them (the JAX "
                        "package's launcher reads it as devices per process; "
                        "with --nprocs N the node starts N times as many)")
    p.add_argument("--nprocs", type=int, default=1, metavar="N",
                   help="rank PROCESSES to spawn on this host (an N-process "
                        "world formed via the rendezvous; each drives "
                        "--nproc_per_node local devices, one process a card "
                        "here)")
    p.add_argument("--nnodes", type=int, default=1, help="nodes in the world")
    p.add_argument("--node_rank", type=int, default=0, help="this node's rank")
    p.add_argument("--master_addr", type=str, default="127.0.0.1",
                   help="rank 0's host, exported as MASTER_ADDR")
    p.add_argument("--master_port", type=str, default="29500",
                   help="rank 0's rendezvous port, exported as MASTER_PORT")
    p.add_argument("--backend", type=str, default=None,
                   help="force the ranks' platform: cpu hides every card "
                        "from them (CUDA_VISIBLE_DEVICES empty), cuda leaves "
                        "them visible (default)")
    p.add_argument("--restart-budget", type=int, default=0, metavar="K",
                   help="gang restarts from the latest coordinated archive "
                        "before escalating to one diagnostic + exit 69 "
                        "(default: 0 — no restarts; signals still forward "
                        "and the child's exit code still propagates)")
    p.add_argument("--grace-s", type=float, default=10.0, metavar="S",
                   help="SIGTERM-to-SIGKILL window when stopping survivors "
                        "of a dead rank (budget the trainer's emergency "
                        "save inside it; default: 10)")
    p.add_argument("--backoff-base-s", type=float, default=0.5)
    p.add_argument("--backoff-max-s", type=float, default=30.0)
    p.add_argument("--backoff-seed", type=int, default=0,
                   help="seed for restart-backoff jitter (deterministic "
                        "chaos schedules)")
    p.add_argument("--heartbeat-timeout-s", type=float, default=0.0, metavar="S",
                   help="treat a rank as HUNG when its step-boundary "
                        "heartbeat file goes silent for S seconds (0 = "
                        "liveness only; budget the first step)")
    p.add_argument("--rdzv-timeout-s", type=float, default=60.0, metavar="S",
                   help="total rendezvous budget exported to the children: "
                        "world formation fails (with a pointed diagnostic) "
                        "instead of hanging past it")
    p.add_argument("--rdzv-attempts", type=int, default=2, metavar="K",
                   help="bounded rendezvous attempts within the budget "
                        "(retry/backoff between them)")
    p.add_argument("--telemetry-dir", type=str, default=None, metavar="DIR",
                   help="launcher telemetry: launch_restarts_total/"
                        "rank_deaths_total/rank_heartbeat_age_seconds in "
                        "DIR/launcher.prom plus rank_death/gang_restart "
                        "JSONL events (DIR is also exported to children "
                        "for their rendezvous events)")
    p.add_argument("-m", "--module", action="store_true",
                   help="run the program as a module (python -m)")
    p.add_argument("program", type=str, help="the script path, or the module with -m")
    p.add_argument("program_args", nargs=argparse.REMAINDER)
    return p


def local_ranks(args) -> int:
    """Processes this node starts: ``--nprocs`` times ``--nproc_per_node``."""
    return args.nprocs * args.nproc_per_node


def _child_env(args, local_rank: int, restart_count: int = 0,
               hb_dir: str | None = None) -> dict[str, str]:
    local = local_ranks(args)
    rank = args.node_rank * local + local_rank
    env = dict(os.environ)
    env.update({
        "RANK": str(rank),
        "WORLD_SIZE": str(args.nnodes * local),
        "LOCAL_RANK": str(local_rank),
        "MASTER_ADDR": args.master_addr,
        "MASTER_PORT": str(args.master_port),
        ENV_RDZV_TIMEOUT_S: str(args.rdzv_timeout_s),
        ENV_RDZV_ATTEMPTS: str(args.rdzv_attempts),
        ENV_RESTART_COUNT: str(restart_count),
    })
    if args.backend == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    if hb_dir is not None:
        env[ENV_HEARTBEAT_FILE] = heartbeat_path(hb_dir, rank)
    if args.telemetry_dir:
        env[ENV_TELEMETRY_DIR] = args.telemetry_dir
    return env


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.nproc_per_node < 1 or args.nnodes < 1 or args.nprocs < 1:
        parser.error("--nproc_per_node, --nprocs and --nnodes must be at least 1")
    if args.nprocs > 1 and args.nnodes > 1:
        # Every node's gang would need its own rank range, which the env
        # contract does not carry.
        parser.error(
            "--nprocs (multi-rank gang on one host) and --nnodes "
            "(one process per node) cannot combine: per-node multi-rank "
            "worlds need distinct RANK assignment the env contract "
            "does not carry; launch one --nprocs gang per node with "
            "hand-assigned rank ranges, or drop one of the flags"
        )
    if args.backend is not None and args.backend not in BACKENDS:
        parser.error(f"--backend {args.backend!r}: have {', '.join(BACKENDS)}")

    registry = sink = None
    if args.telemetry_dir:
        from ..obs import EventSink, Registry

        registry = Registry()
        sink = EventSink(args.telemetry_dir, filename="events-launcher.jsonl")

    hb_dir = None
    if args.heartbeat_timeout_s > 0:
        import tempfile

        hb_dir = args.telemetry_dir or tempfile.mkdtemp(prefix="elastic_hb_")

    def spawn(local_rank: int, restart_count: int) -> subprocess.Popen:
        program_args = list(args.program_args)
        if restart_count > 0:
            # A restart runs clean: the chaos schedule is incarnation 0's.
            program_args = strip_chaos_args(program_args)
        cmd = [sys.executable, *(["-m"] if args.module else []), args.program, *program_args]
        # A session of its own per rank: a signal reaches the rank's whole
        # process group, and a terminal's Ctrl-C reaches the ranks only
        # through the launcher.
        return subprocess.Popen(cmd, env=_child_env(args, local_rank, restart_count, hb_dir),
                                start_new_session=True)

    supervisor = GangSupervisor(
        spawn,
        local_ranks(args),
        restart_budget=args.restart_budget,
        backoff_base_s=args.backoff_base_s,
        backoff_max_s=args.backoff_max_s,
        seed=args.backoff_seed,
        grace_s=args.grace_s,
        heartbeat_dir=hb_dir,
        heartbeat_timeout_s=args.heartbeat_timeout_s,
        propagate_exit=(args.nprocs == 1 and args.restart_budget == 0),
        registry=registry,
        sink=sink,
    )
    supervisor.install_signals()
    try:
        code = supervisor.run()
    finally:
        supervisor.uninstall_signals()
        if sink is not None:
            sink.close()
        if registry is not None:
            from ..obs import write_prometheus

            write_prometheus(registry, os.path.join(args.telemetry_dir, "launcher.prom"))
    return code


if __name__ == "__main__":
    sys.exit(main())
