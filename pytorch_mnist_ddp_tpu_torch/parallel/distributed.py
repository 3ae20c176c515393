"""World formation from the environment, with ``torch.distributed``.

The reference's ``init_distributed_mode`` (mnist_ddp.py:13-37), as the
JAX package's ``parallel/distributed.py`` keeps it:

- ``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` select distributed mode;
  ``SLURM_PROCID``/``SLURM_NTASKS`` are the fallback; with neither the run
  prints "Not using distributed mode" and is a world of one device;
- ``MASTER_ADDR``/``MASTER_PORT`` are the ``env://`` rendezvous address.

Unlike the JAX package, where one process drives every local chip, here
one process drives one card, as in the reference: rank r of N is one
process on ``cuda:LOCAL_RANK``, and the data-parallel world size is the
number of processes.  The group is NCCL for the card and gloo for the CPU
(``device="cpu"``).  Its rendezvous is bounded: ``init_process_group``
gets a timeout and is retried a few times within one budget, so a peer
that never arrives fails every rank with one pointed error.  That timeout
also bounds the group's collectives, so a rank whose peer stopped is not
left waiting in one.  Where the launcher exported
``ELASTIC_TELEMETRY_DIR`` (its ``--telemetry-dir``), each rank writes its
``rendezvous`` and ``rendezvous_retry`` events to
``events-rdzv-rank<r>.jsonl`` there, before the trainer's telemetry
exists; :class:`DistState` keeps the attempts the rendezvous took.
"""

from __future__ import annotations

import datetime
import os
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..utils.logging import NOT_DISTRIBUTED_NOTICE, distributed_init_banner

DEFAULT_RDZV_TIMEOUT_S = 60.0
DEFAULT_RDZV_ATTEMPTS = 2


@dataclass(frozen=True)
class DistState:
    """This process's place in the world: a world of one by default."""

    distributed: bool = False
    rank: int = 0
    world_size: int = 1
    local_rank: int = 0
    dist_url: str = "env://"
    # how the world was formed, not which world it is: not compared
    rendezvous_attempts: int = field(default=0, compare=False)

    @property
    def is_chief(self) -> bool:
        """Rank 0 prints the log lines and saves (mnist_ddp.py:75)."""
        return self.rank == 0


def _coordinator_address(dist_url: str) -> str | None:
    """``host:port`` of the rendezvous: the URL's own, else
    ``MASTER_ADDR:MASTER_PORT``; a half-set pair raises."""
    if dist_url and dist_url != "env://":
        return dist_url.removeprefix("tcp://")
    addr = os.environ.get("MASTER_ADDR")
    port = os.environ.get("MASTER_PORT")
    if addr and port:
        return f"{addr}:{port}"
    if addr or port:
        missing = "MASTER_PORT" if addr else "MASTER_ADDR"
        present = "MASTER_ADDR" if addr else "MASTER_PORT"
        raise ValueError(
            f"{present} is set but {missing} is not: the env:// rendezvous "
            f"needs both — export {missing} (the launcher sets the pair "
            "from --master_addr/--master_port)"
        )
    return None


def _init_method(dist_url: str) -> str:
    """The ``init_method`` for torch: a ``tcp://``/``file://`` URL as
    given, else ``tcp://MASTER_ADDR:MASTER_PORT``."""
    address = _coordinator_address(dist_url)
    if dist_url and dist_url != "env://":
        return dist_url
    if address is None:
        raise ValueError(
            "RANK/WORLD_SIZE select distributed mode, but neither MASTER_ADDR "
            "nor MASTER_PORT is set: the env:// rendezvous needs both (the "
            "launcher sets the pair from --master_addr/--master_port)"
        )
    return f"tcp://{address}"


def initialize_with_retry(
    init_method: str,
    world_size: int,
    rank: int,
    backend: str,
    timeout_s: float = DEFAULT_RDZV_TIMEOUT_S,
    attempts: int = DEFAULT_RDZV_ATTEMPTS,
    sink=None,
) -> int:
    """``init_process_group`` under one total budget: ``attempts`` tries
    share ``timeout_s`` (each gets its share as ``timeout=``, never more
    than what is left), with a backoff of 1, 2, 4... s between them.  Returns the attempts
    used; raises RuntimeError naming the address, the rank and the world
    when a peer never arrives.  ``sink`` takes a ``rendezvous`` event at
    the end (``ok`` true or false) and a ``rendezvous_retry`` event a
    failed attempt that is retried."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    per_attempt = max(1, int(timeout_s / attempts))
    deadline = time.monotonic() + float(timeout_s)
    coordinator = init_method.removeprefix("tcp://")
    last_err: Exception | None = None
    for attempt in range(1, attempts + 1):
        if attempt > 1 and time.monotonic() >= deadline:
            break
        window = max(1, min(per_attempt, int(deadline - time.monotonic())))
        try:
            dist.init_process_group(
                backend, init_method=init_method, world_size=world_size, rank=rank,
                timeout=datetime.timedelta(seconds=window),
            )
            if sink is not None:
                sink.emit("rendezvous", attempts=attempt, ok=True, coordinator=coordinator,
                          rank=rank, world=world_size)
            return attempt
        except RuntimeError as e:  # torch's DistError and its timeouts
            last_err = e
            if dist.is_initialized():
                dist.destroy_process_group()
            if attempt < attempts:
                if sink is not None:
                    sink.emit("rendezvous_retry", attempt=attempt, timeout_s=per_attempt,
                              coordinator=coordinator, error=f"{type(e).__name__}: {e}")
                time.sleep(min(2.0 ** (attempt - 1),
                               max(0.0, deadline - time.monotonic())))
    if sink is not None:
        sink.emit("rendezvous", attempts=attempts, ok=False, coordinator=coordinator,
                  rank=rank, world=world_size)
    raise RuntimeError(
        f"rendezvous at {init_method.removeprefix('tcp://')!r} failed after "
        f"{attempts} attempt(s) x {per_attempt}s (budget {timeout_s:g}s) as "
        f"process {rank} of {world_size}: a peer never arrived — check that "
        f"every rank 0..{world_size - 1} is running and that "
        "MASTER_ADDR/MASTER_PORT match on every host "
        f"(last error: {type(last_err).__name__}: {last_err})"
    ) from last_err


def init_distributed_mode(
    dist_url: str = "env://",
    rdzv_timeout_s: float | None = None,
    rdzv_attempts: int | None = None,
    backend: str | None = None,
    device: str | torch.device | None = None,
) -> DistState:
    """Resolve the world from the environment (reference mnist_ddp.py:13-37)
    and form it: :func:`form_world`, with the reference's lines.  A world
    of one prints "Not using distributed mode"; every rank of a larger one
    prints the reference's banner."""
    state = form_world(dist_url, rdzv_timeout_s, rdzv_attempts, backend, device)
    if state.distributed:
        print(distributed_init_banner(state.rank, dist_url, state.local_rank,
                                      state.world_size), flush=True)
    else:
        print(NOT_DISTRIBUTED_NOTICE)
    return state


def form_world(
    dist_url: str = "env://",
    rdzv_timeout_s: float | None = None,
    rdzv_attempts: int | None = None,
    backend: str | None = None,
    device: str | torch.device | None = None,
) -> DistState:
    """The world of the environment, formed, printing nothing.

    ``RANK``/``WORLD_SIZE`` (``LOCAL_RANK``), else ``SLURM_PROCID``/
    ``SLURM_NTASKS``, make this process one rank; with neither it is a
    world of one.  ``device`` ``None`` is the card (``resolve_device``):
    rank r takes ``cuda:LOCAL_RANK`` and the group is NCCL; ``"cpu"``
    forms a gloo group.  ``backend`` overrides that choice (gloo between
    ranks that share one card, which NCCL refuses).  ``rdzv_timeout_s``
    and ``rdzv_attempts`` bound the rendezvous; ``None`` reads the
    launcher's ``RDZV_TIMEOUT_S``/``RDZV_ATTEMPTS``, else 60 s over 2
    attempts.
    """
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        rank, world_size = int(env["RANK"]), int(env["WORLD_SIZE"])
        local_rank = int(env.get("LOCAL_RANK", 0))
    elif "SLURM_PROCID" in env:
        rank, world_size = int(env["SLURM_PROCID"]), int(env.get("SLURM_NTASKS", 1))
        local_rank = int(env.get("SLURM_LOCALID", 0))
    else:
        return DistState(dist_url=dist_url)

    dev = resolve_device(device)
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        if local_rank >= count:
            raise RuntimeError(
                f"LOCAL_RANK={local_rank} but this host has {count} CUDA "
                f"device(s): one process drives one card, so launch at most "
                f"{count} processes per node"
            )
        torch.cuda.set_device(local_rank)
    if rdzv_timeout_s is None:
        rdzv_timeout_s = float(env.get("RDZV_TIMEOUT_S", DEFAULT_RDZV_TIMEOUT_S))
    if rdzv_attempts is None:
        rdzv_attempts = int(env.get("RDZV_ATTEMPTS", DEFAULT_RDZV_ATTEMPTS))
    sink = _rendezvous_sink(rank)
    try:
        attempts = initialize_with_retry(
            _init_method(dist_url), world_size, rank,
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            timeout_s=rdzv_timeout_s, attempts=rdzv_attempts, sink=sink,
        )
    finally:
        if sink is not None:
            sink.close()
    return DistState(distributed=True, rank=rank, world_size=world_size,
                     local_rank=local_rank, dist_url=dist_url,
                     rendezvous_attempts=attempts)


def _rendezvous_sink(rank: int):
    """This rank's sink for its rendezvous events, where the launcher
    exported ``ELASTIC_TELEMETRY_DIR``: the events must land before the
    trainer's telemetry exists."""
    directory = os.environ.get("ELASTIC_TELEMETRY_DIR")
    if not directory:
        return None
    from ..obs.events import EventSink

    return EventSink(directory, rank=rank, filename=f"events-rdzv-rank{rank}.jsonl")


def destroy_distributed() -> None:
    """Tear the group down, where one was formed."""
    if dist.is_initialized():
        dist.destroy_process_group()
