"""The training run: train loop, eval loop, final save, on one device or
as one rank of a data-parallel world.

The body of the reference's ``mnist.py`` and ``mnist_ddp.py`` ``main()``:
data, model, Adadelta, StepLR once per epoch, evaluation after every
epoch, and ``--save-model``; with the JAX package's ``--resume``
(parameters from a model checkpoint, a fresh optimizer),
``--save-state``/``--resume-state`` (the whole training state, continued
bit for bit, from a final or a mid-epoch archive of either package),
``--conv-impl``, ``--bf16``, ``--syncbn``, ``--zero`` (the Adadelta
state sharded over the ranks, ``parallel/zero.py``; archives per leaf on
disk, so they cross with plain runs of either package), ``--elastic``
(resume the run's own ``--save-state`` archive, ``--epochs`` the total),
``--resume-reshard`` (a mid-epoch archive of another world size),
``--profile``/``--step-stats`` (``utils/profiling.py``), the model
axis: ``--tp N`` (``parallel/tp.py``) and ``--pp`` (``parallel/pp.py``)
over a ``(data, model)`` rank grid, ``--fused`` (``--pregather``): the
data-parallel epochs over device-resident sets, each step replayed from a
CUDA graph (``parallel/fused.py``), and ``--prefetch-depth N``: the
per-batch path's batches assembled and copied N ahead of the step loop
(``data/prefetch.py``).  Given a distributed ``DistState``
(``parallel/distributed.py``) each rank trains on its shard of every
epoch, the gradients are all-reduced (``parallel/ddp.py``), every rank
evaluates its shard of the test set and the totals are summed; only rank
0 prints and saves.  The data and the epoch loop are shared with the ViT
CLI (``vit_mnist.py``).  The printed lines are the JAX package's (and so
the reference's), byte for byte.

``--telemetry-dir DIR`` (``obs/``) writes JSONL events (``step``,
``epoch_train_end``, ``eval``, spans, ``prefetch_epoch``, ...; the chief's
in a distributed run) and ``DIR/metrics.prom`` at the end; it reads each
step's loss on the host, the JAX package's opt-in trade.  The resilient
runtime (``resilience/``) takes the per-batch data-parallel steps when
``--checkpoint-every-steps``, ``--loss-guard`` or ``--step-timeout-s`` is
set, when a fault injector is installed (``--chaos``,
``serving/faults.py``), or when the supervising launcher exported a
heartbeat file; a run with none of these builds no runtime and no sink,
and its step loop reads nothing more from the device than before.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch

from .data.loader import DataLoader
from .data.mnist import MNIST
from .device import resolve_device
from .models.net import Net
from .obs import Telemetry
from .ops.adadelta import AdadeltaState, adadelta_init
from .ops.adadelta_flat import FlatAdadeltaState, ensure_opt_layout, is_flat_state
from .ops.schedule import step_lr
from .parallel import pp, tp
from .parallel.ddp import (
    TrainState,
    broadcast_from_chief,
    make_eval_step,
    make_forward_eval_step,
    make_train_state,
    make_train_step,
)
from .parallel.distributed import DistState, destroy_distributed
from .parallel.elastic import RankHeartbeat
from .parallel.fused import FusedRun
from .parallel.mesh import RankGrid, make_rank_grid, world_group
from .parallel.zero import per_leaf_opt_to_zero, zero_opt_to_per_leaf
from .resilience import LossGuard, MidEpochCheckpointer, PreemptionHandler, ResilientRuntime
from .serving import faults
from .utils.checkpoint import (
    PREV_SUFFIX,
    TrainArchive,
    load_latest_train_state,
    load_resume_state,
    model_state_dict,
    save_state_dict,
    save_train_state,
)
from .utils.logging import test_summary_lines, train_log_line
from .utils.profiling import StepStats, trace
from .utils.rng import split_streams


def train_one_epoch(
    step_fn,
    model: Net,
    state: TrainState,
    loader: DataLoader,
    epoch: int,
    lr: float,
    log_interval: int = 10,
    dry_run: bool = False,
    start_batch: int = 0,
    dist: DistState = DistState(),
    step_stats: StepStats | None = None,
    telemetry: Telemetry | None = None,
    runtime: ResilientRuntime | None = None,
) -> int:
    """One training epoch (reference ``train()``); returns the steps taken.
    The loss is read from the device only on log steps, by rank 0 alone:
    its own loss, and the global sample counter ``batch_idx`` times the
    loader's global batch (``world_size * batch_size`` in distributed mode,
    mnist_ddp.py:78; ``num_data * batch_size`` for the grids of the ViT
    and of ``--tp``/``--pp``).  ``start_batch`` resumes a mid-epoch
    archive at its batch cursor: batch numbering and log lines go on as if
    the run had never stopped.  ``step_stats`` times every step, waiting
    for its loss.

    ``telemetry`` (``--telemetry-dir``) reads every step's loss on the
    host (one read a step, the opt-in trade): a ``step`` event with this
    rank's own loss, ``train_steps_total``, ``train_samples_total``,
    ``train_step_latency_seconds``, and after the loop
    ``train_samples_per_second`` and an ``epoch_train_end`` event.
    ``runtime`` (``resilience/runtime.py``) takes each step through its
    guarded attempt and each step boundary through its checkpoints and
    preemption poll; a loss it already read is reused, never read
    twice."""
    num_batches = len(loader)
    steps = 0
    if step_stats is not None:
        step_stats.start()
    if telemetry is not None:
        registry = telemetry.registry
        step_counter = registry.counter("train_steps_total", help="optimizer steps executed")
        sample_counter = registry.counter("train_samples_total",
                                          help="global training samples consumed")
        latency_hist = registry.histogram("train_step_latency_seconds",
                                          help="host-observed per-step latency (blocking read)")
        steps_recorded = samples_recorded = 0
        epoch_t0 = step_t0 = time.perf_counter()
    if runtime is not None:
        runtime.begin_train()
    try:
        for batch_idx, (x, y, w) in enumerate(loader.epoch(epoch, start_batch),
                                              start=start_batch):
            loss_host = None
            if runtime is not None:
                loss, loss_host = runtime.run_step(step_fn, model, state, x, y, w, lr,
                                                   epoch=epoch, batch_idx=batch_idx)
            else:
                loss = step_fn(model, state, x, y, w, lr)
            if step_stats is not None:
                # a step the runtime read is already synchronized
                step_stats.mark(loss if loss_host is None else None)
            steps += 1
            if telemetry is not None:
                if loss_host is None:
                    loss_host = loss.item()
                now = time.perf_counter()
                step_counter.inc()
                sample_counter.inc(loader.global_batch)
                steps_recorded += 1
                samples_recorded += loader.global_batch
                latency_hist.observe(now - step_t0)
                telemetry.events.emit("step", epoch=epoch, step=batch_idx, loss=loss_host,
                                      latency_s=now - step_t0, samples=loader.global_batch)
                step_t0 = time.perf_counter()
            if dist.is_chief and batch_idx % log_interval == 0:
                print(train_log_line(
                    epoch, batch_idx * loader.global_batch, loader.dataset_len, batch_idx,
                    num_batches, loss.item() if loss_host is None else loss_host,
                ))
            if runtime is not None:
                # may raise SystemExit (a preemption, its archive written)
                runtime.after_step(model, state, epoch=epoch, batch_idx=batch_idx)
            if dry_run:
                break
    finally:
        if runtime is not None:
            runtime.end_train()
    if telemetry is not None:
        duration = time.perf_counter() - epoch_t0
        sps = samples_recorded / duration if duration > 0 else 0.0
        telemetry.registry.gauge("train_samples_per_second",
                                 help="throughput of the most recent epoch").set(sps)
        telemetry.events.emit("epoch_train_end", epoch=epoch, steps=steps_recorded,
                              samples=samples_recorded, duration_s=duration,
                              samples_per_s=sps)
    return steps


def evaluate(
    eval_fn, model: Net, loader: DataLoader, dry_run: bool = False,
    dist: DistState = DistState(), telemetry: Telemetry | None = None,
) -> tuple[float, int]:
    """Whole-test-set NLL and accuracy (reference ``test()``); rank 0
    prints the summary, and every rank returns ``(avg_loss, correct)``.
    Per batch it reads two numbers (the all-reduced totals of every rank's
    shard, in distributed mode) and sums them in Python floats, as the JAX
    package does.  With ``dry_run`` only the first batch is evaluated (the
    ViT CLI's dry run); the average still divides by the whole set.  With
    ``telemetry`` the pass runs in an ``evaluate`` span."""
    loss_sum = 0.0
    correct = 0.0
    with telemetry.span("evaluate") if telemetry is not None else contextlib.nullcontext():
        for x, y, w in loader.epoch(0):
            batch_loss, batch_correct = eval_fn(model, x, y, w)
            loss_sum += batch_loss.item()
            correct += batch_correct.item()
            if dry_run:
                break
    n = loader.dataset_len
    avg = loss_sum / n
    if dist.is_chief:
        print(test_summary_lines(avg, int(correct), n))
    return avg, int(correct)


def _datasets(args, timings: dict | None) -> tuple[MNIST, MNIST]:
    """Both splits of MNIST (the synthetic set without IDX files), cut to
    ``--train-limit`` where the CLI has that flag; records the sizes in
    ``timings``."""
    train_set = MNIST(root=args.data_root, train=True)
    test_set = MNIST(root=args.data_root, train=False)
    limit = getattr(args, "train_limit", 0)
    if limit:  # smoke runs: truncate both splits
        for ds in (train_set, test_set):
            ds.images = ds.images[:limit]
            ds.labels = ds.labels[:limit]
    if timings is not None:
        timings.update(dataset=train_set.source, train_size=len(train_set),
                       test_size=len(test_set), epoch_train_s=[], epoch_steps=[])
    return train_set, test_set


def _feed(args, registry, pipeline: str, sink=None) -> dict:
    """The loaders' prefetch settings: ``--prefetch-depth`` (2 where the
    CLI has no such flag, as in the JAX package), the registry their
    histograms go to and the sink of their events."""
    return {"prefetch_depth": int(getattr(args, "prefetch_depth", 2)),
            "registry": registry, "pipeline": pipeline, "sink": sink}


def make_loaders(
    args, device: torch.device, timings: dict | None = None,
    dist: DistState = DistState(), registry=None, sink=None,
) -> tuple[DataLoader, DataLoader]:
    """Shuffled train and ordered test loaders on ``device`` for rank
    ``dist.rank`` of ``dist.world_size``: ``--batch-size`` samples a step
    on every rank, ``ceil(--test-batch-size / world_size)`` an eval batch
    (the JAX trainer's split), the test loader's padding duplicates at
    weight 0 (:func:`_datasets`' sets).  Both prefetch ``--prefetch-depth``
    batches and record into ``registry`` (``obs/registry.py``) and
    ``sink`` (``obs/events.py``) if given."""
    train_set, test_set = _datasets(args, timings)
    world = {"rank": dist.rank, "world_size": dist.world_size}
    train_loader = DataLoader(train_set.images, train_set.labels, args.batch_size,
                              device, shuffle=True, seed=args.seed, **world,
                              **_feed(args, registry, "train", sink))
    test_loader = DataLoader(test_set.images, test_set.labels,
                             -(-args.test_batch_size // dist.world_size), device,
                             shuffle=False, mask_padding=True, **world,
                             **_feed(args, registry, "eval", sink))
    return train_loader, test_loader


def make_shard_loaders(
    args, device: torch.device, shard: int = 0, num_shards: int = 1,
    timings: dict | None = None,
) -> tuple[DataLoader, DataLoader]:
    """The loaders of data shard ``shard`` of ``num_shards``, as the JAX
    ViT CLI shards its global batches over the mesh's data axis
    (vit_mnist.py:594-606): ``--batch-size`` and ``--test-batch-size``
    rows a shard, global batches ``num_shards`` times those."""
    train_set, test_set = _datasets(args, timings)
    train_loader = DataLoader(train_set.images, train_set.labels, args.batch_size, device,
                              shuffle=True, seed=args.seed, shard=shard,
                              num_shards=num_shards, **_feed(args, None, "train"))
    test_loader = DataLoader(test_set.images, test_set.labels, args.test_batch_size, device,
                             shuffle=False, mask_padding=True, shard=shard,
                             num_shards=num_shards, **_feed(args, None, "eval"))
    return train_loader, test_loader


def run_epochs(
    args,
    device: torch.device,
    model: torch.nn.Module,
    state: TrainState,
    step_fn,
    eval_fn,
    loaders: tuple[DataLoader, DataLoader],
    timings: dict | None = None,
    dry_run_eval: bool = False,
    epoch0: int = 0,
    start_batch: int = 0,
    dist: DistState = DistState(),
    telemetry: Telemetry | None = None,
    runtime: ResilientRuntime | None = None,
) -> None:
    """``--epochs`` epochs of training after ``epoch0`` completed ones, each
    followed by evaluation, with StepLR (``--lr``, ``--gamma``) once per
    epoch; the first starts at batch ``start_batch``.  ``--step-stats``
    prints one latency line an epoch (rank 0), before the evaluation, as
    the JAX trainer does.  With ``timings`` (a
    dict from :func:`make_loaders` or :func:`make_shard_loaders`) the run
    records per-epoch training seconds (``epoch_train_s``, the device
    synchronized at each end),
    ``epoch_steps``, ``epoch1_test_accuracy`` (of the run's first epoch)
    and ``final_test_accuracy``.  ``telemetry`` and ``runtime`` are
    :func:`train_one_epoch`'s; with ``telemetry`` each epoch runs in an
    ``epoch`` span and is followed by an ``eval`` event and the
    ``test_accuracy`` gauge."""
    train_loader, test_loader = loaders
    lr_fn = step_lr(args.lr, args.gamma, step_size=1)
    for epoch in range(epoch0 + 1, epoch0 + args.epochs + 1):
        stats = StepStats() if getattr(args, "step_stats", False) else None
        t0 = time.perf_counter()
        with (telemetry.span("epoch", epoch=epoch) if telemetry is not None
              else contextlib.nullcontext()):
            steps = train_one_epoch(step_fn, model, state, train_loader, epoch,
                                    lr_fn(epoch), args.log_interval, args.dry_run,
                                    start_batch if epoch == epoch0 + 1 else 0, dist, stats,
                                    telemetry, runtime)
            if timings is not None:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                timings["epoch_train_s"].append(time.perf_counter() - t0)
                timings["epoch_steps"].append(steps)
            if stats is not None and dist.is_chief:
                print(stats.summary_line(epoch))
            avg_loss, correct = evaluate(eval_fn, model, test_loader, dry_run_eval, dist,
                                         telemetry)
        if telemetry is not None:
            _record_eval(telemetry, epoch, avg_loss, correct, test_loader.dataset_len)
        if timings is not None:
            timings.setdefault("epoch_wall_s", []).append(time.perf_counter() - t0)
            _record_accuracy(timings, correct, test_loader.dataset_len)
        # scheduler.step() is implicit: lr_fn(epoch + 1) next iteration.


def _record_accuracy(timings: dict, correct: int, n_test: int) -> None:
    timings.setdefault("epoch1_test_accuracy", correct / n_test)
    timings["final_test_accuracy"] = correct / n_test


def _record_eval(telemetry: Telemetry, epoch: int, avg_loss: float, correct: int,
                 n_test: int) -> None:
    """An evaluation's ``eval`` event and ``test_accuracy`` gauge."""
    acc = correct / n_test
    telemetry.registry.gauge("test_accuracy", help="accuracy of the latest eval pass").set(acc)
    telemetry.events.emit("eval", epoch=epoch, avg_loss=avg_loss, correct=correct, accuracy=acc)


def run_fused_epochs(
    args,
    run: FusedRun,
    loaders: tuple[DataLoader, DataLoader],
    timings: dict | None = None,
    epoch0: int = 0,
    dist: DistState = DistState(),
    telemetry: Telemetry | None = None,
) -> None:
    """:func:`run_epochs` on the fused path (``parallel/fused.py``): each
    epoch trains and evaluates on the device, and then rank 0 prints its
    train lines (``--log-interval``) and the test summary from the one
    host read, the per-batch run's lines byte for byte.  ``timings`` gains
    ``epoch_wall_s`` (training, evaluation and the read), ``epoch_steps``,
    the accuracies, ``host_syncs`` and the graph's ``replays``.  With
    ``telemetry`` the chief records each epoch's steps and samples in
    ``train_steps_total``/``train_samples_total`` and its ``eval`` event
    and ``test_accuracy`` from the same read, as the JAX package records
    its fused run's: the path adds no host read a step.  The JAX
    package warns that XLA:CPU lowers the convolutions of its fused scan
    poorly; the port runs the same eager ops on the CPU either way and has
    no such warning."""
    train_loader, test_loader = loaders
    lr_fn = step_lr(args.lr, args.gamma, step_size=1)
    num_batches = run.num_batches
    for epoch in range(epoch0 + 1, epoch0 + args.epochs + 1):
        t0 = time.perf_counter()
        losses, (loss_sum, correct) = run.epoch(epoch, lr_fn(epoch))
        wall = time.perf_counter() - t0
        n_test = test_loader.dataset_len
        if dist.is_chief:
            for batch_idx in range(0, num_batches, args.log_interval):
                print(train_log_line(
                    epoch, batch_idx * train_loader.global_batch, train_loader.dataset_len,
                    batch_idx, num_batches, float(losses[batch_idx, 0]),
                ))
            print(test_summary_lines(loss_sum / n_test, correct, n_test))
            if telemetry is not None:
                registry = telemetry.registry
                registry.counter("train_steps_total",
                                 help="optimizer steps executed").inc(num_batches)
                registry.counter("train_samples_total",
                                 help="global training samples consumed").inc(
                    num_batches * train_loader.global_batch)
                _record_eval(telemetry, epoch, loss_sum / n_test, correct, n_test)
        if timings is not None:
            timings.setdefault("epoch_wall_s", []).append(wall)
            timings["epoch_steps"].append(num_batches)
            _record_accuracy(timings, correct, n_test)
    if timings is not None:
        timings.update(host_syncs=run.host_syncs, replays=run.train.replays)


def _resume_cursor(
    path: str, extras: dict[str, int], epoch0: int, args, world_size: int
) -> int:
    """The batch cursor of a mid-epoch archive (0 for a final one), after
    the JAX trainer's checks that this run can continue it: the epoch in
    progress follows the completed ones, the seed and the global batch
    (``--batch-size`` times the world size) are the saved run's, and so is
    the world size unless ``--resume-reshard`` accepts another.  At the
    same seed and global batch every world size consumes the same global
    batches (``parallel/sampler.py``): a re-shard continues sample for
    sample, its sums re-associated."""
    in_progress = extras.get("epoch_in_progress", 0)
    if not in_progress:
        return 0
    if in_progress != epoch0 + 1:
        raise ValueError(
            f"--resume-state {path!r} is inconsistent: "
            f"epoch_in_progress={in_progress} but epochs_completed={epoch0}"
        )
    saved_seed = extras.get("seed")
    if saved_seed is not None and saved_seed != args.seed:
        raise ValueError(
            f"--resume-state {path!r} was saved mid-epoch under --seed "
            f"{saved_seed}; resuming with --seed {args.seed} would replay a "
            "DIFFERENT permutation from the saved batch cursor — pass the "
            "original seed"
        )
    global_batch = args.batch_size * world_size
    saved_gb = extras.get("global_batch")
    if saved_gb is not None and saved_gb != global_batch:
        raise ValueError(
            f"--resume-state {path!r} was saved mid-epoch at global batch "
            f"{saved_gb}; this run's {global_batch} re-chunks the epoch and "
            "the saved batch cursor no longer addresses the same samples — "
            "match --batch-size and the device count"
        )
    saved_ws = extras.get("world_size")
    if (saved_ws is not None and saved_ws != world_size
            and not getattr(args, "resume_reshard", False)):
        raise ValueError(
            f"--resume-state {path!r} was saved mid-epoch at world size "
            f"{saved_ws}; this run's world size is {world_size}.  Matching "
            "seed and global batch make a re-shard consume the exact same "
            "global batches (sampler contract; reductions re-associate, so "
            "expect FP-level drift, not bit-equality) — pass --resume-reshard "
            "to accept it, or relaunch at the original world size"
        )
    return extras.get("batch_cursor", 0)


def _opt_to(opt: AdadeltaState | FlatAdadeltaState, device: torch.device):
    if is_flat_state(opt):
        return FlatAdadeltaState(*(t.to(device) for t in opt))
    return AdadeltaState(*({k: v.to(device) for k, v in tree.items()} for tree in opt))


def _opt_tensors(opt: AdadeltaState | FlatAdadeltaState) -> list[torch.Tensor]:
    if is_flat_state(opt):
        return list(opt)
    return [t for tree in opt for t in tree.values()]


def fit(
    args,
    device: str | torch.device | None = None,
    save_path: str | None = None,
    timings: dict | None = None,
    dist: DistState | None = None,
    registry=None,
) -> tuple[Net, TrainState]:
    """The full run; returns the trained model and its state.  ``device``
    ``None`` means the card, and raises without one (``resolve_device``).
    ``dist`` is this process's place in the world (``DistState()``, a world
    of one, by default); a distributed world's group is torn down at the
    end.  ``--profile DIR`` traces the whole run (``utils/profiling.py``),
    and the trace is written also when the run raises.  ``registry``
    (``obs/registry.py``) takes the loaders' prefetch histograms.

    TF32 is switched off for the f32 path, in convolutions and matmuls
    alike (cuDNN would otherwise run the convs in TF32 by default), and
    cuDNN is made deterministic: ``--resume-state`` promises the
    uninterrupted run's bits, and cuDNN's own choice of a conv backward on
    the H100 sums with atomics (``wgrad_alg0_engine``), so two runs of the
    same steps differ.  The switches are process-wide.  ``timings`` is
    :func:`run_epochs`'s.

    ``--resume-state`` continues the archive's run: epoch numbering, the
    lr schedule and the shuffle from its completed epochs (and batch
    cursor), the dropout seeds from its step counter, its accumulators in
    the layout this run's ``--pallas-opt`` executes.  ``--elastic`` (or
    ``ELASTIC_RESTART_COUNT`` > 0 in the environment, a gang restart's
    mark) resumes from the run's own ``--save-state`` archive (or its
    ``.prev``) when one exists and no ``--resume-state`` is given, and then
    reads ``--epochs`` as the total.  ``--save-state`` writes the final
    archive after the last epoch.  Before the first step every rank takes
    rank 0's parameters and BatchNorm averages (and, resumed from an
    archive, its accumulators and step), as ``DistributedDataParallel``'s
    constructor broadcasts them.

    ``--tp N`` and ``--pp`` lay the ranks out as JAX lays out its devices,
    a ``(W/N, 1, N)`` grid (N = 2 for ``--pp``): every model member of a
    data shard sees that shard's ``--batch-size`` rows a step.  They refuse
    the flags the JAX trainer refuses, with its texts.

    ``--fused`` (not with ``--dry-run``, which stays on the per-batch loop)
    trains the data-parallel epochs over device-resident sets
    (``parallel/fused.py``), on the card each step replayed from one CUDA
    graph; it prints the same lines after each epoch and writes the same
    files.  It refuses a mid-epoch archive and the model axis, and
    ``--pregather`` needs it, with the JAX trainer's texts.

    ``--telemetry-dir DIR`` (module docstring) runs the whole run in a
    ``run`` span and writes ``DIR/metrics.prom`` at its end, with a
    ``run_complete`` event (``wall_seconds``); ``registry`` then is the
    bundle's.  The resilience flags (``--checkpoint-every-steps`` with
    ``--save-state``, ``--preempt-grace-s``, ``--loss-guard`` with
    ``--spike-factor``/``--anomaly-budget``/``--anomaly-lr-backoff``,
    ``--step-timeout-s``/``--stall-abort``) take the per-batch
    data-parallel path through :class:`~.resilience.ResilientRuntime`,
    built only when needed (:func:`_make_runtime`); they and a trainer-site
    chaos clause are refused where the JAX trainer refuses them, with its
    texts (:func:`_refuse_resilience`).
    """
    world = dist or DistState()
    telemetry = None
    try:
        dev = resolve_device(device)
        if getattr(args, "telemetry_dir", None):
            telemetry = Telemetry(args.telemetry_dir, rank=world.rank,
                                  distributed=world.distributed, registry=registry)
            if world.rendezvous_attempts:
                telemetry.registry.counter(
                    "rendezvous_attempts_total",
                    help="bounded rendezvous attempts this process took to form the world",
                ).inc(world.rendezvous_attempts)
        with trace(getattr(args, "profile", None), dev):
            if telemetry is None:
                return _fit(args, device, save_path, timings, world, registry)
            t0 = time.perf_counter()
            with telemetry.span("run"):
                result = _fit(args, device, save_path, timings, world,
                              telemetry.registry, telemetry)
            telemetry.events.emit("run_complete", wall_seconds=time.perf_counter() - t0)
            telemetry.write_exposition()
            return result
    finally:
        if telemetry is not None:
            telemetry.close()
        if world.distributed:
            destroy_distributed()


def _model_axis(args, world: DistState) -> tuple[int, bool]:
    """``(tp degree, pp)`` after the JAX trainer's refusals of the flags
    the model axis does not take."""
    tp_degree = int(getattr(args, "tp", 1) or 1)
    pp_on = bool(getattr(args, "pp", False))
    if tp_degree > 1 and pp_on:
        raise ValueError("--tp and --pp both claim the model axis; pick one")
    if tp_degree == 1 and not pp_on:
        return 1, False
    if getattr(args, "fused", False):
        raise ValueError("--fused is data-parallel only; drop it for --tp/--pp")
    if args.pallas_opt:
        raise ValueError(
            "--pallas-opt is implemented for the DP paths; drop --tp/--pp"
        )
    if not world.distributed:
        raise ValueError("--tp/--pp need a multi-device mesh (use the launcher)")
    if getattr(args, "syncbn", False):
        raise ValueError("--syncbn rides the DP paths; drop --tp/--pp")
    if getattr(args, "zero", False):
        raise ValueError("--zero rides the DP paths; drop --tp/--pp")
    if args.conv_impl != "conv":
        raise ValueError("--conv-impl rides the DP paths; drop --tp/--pp")
    if args.save_state or args.resume_state:
        raise ValueError(
            "--save-state/--resume-state ride the DP paths; drop --tp/--pp"
        )
    return tp_degree, pp_on


def _resilience_flags(args) -> tuple[int, bool, float]:
    """``(--checkpoint-every-steps, --loss-guard, --step-timeout-s)``;
    a CLI without them has them off."""
    return (int(getattr(args, "checkpoint_every_steps", 0) or 0),
            bool(getattr(args, "loss_guard", False)),
            float(getattr(args, "step_timeout_s", 0) or 0.0))


def _refuse_resilience(args, world: DistState, num_model: int) -> None:
    """The JAX trainer's refusals, with its texts: the resilience flags and
    a trainer-site chaos clause need the per-batch data-parallel step
    loop, ``--loss-guard`` one process, and ``--checkpoint-every-steps`` a
    ``--save-state`` path."""
    ckpt_every, loss_guard, step_timeout = _resilience_flags(args)
    on = ckpt_every > 0 or loss_guard or step_timeout > 0
    fused = bool(getattr(args, "fused", False))
    if fused and faults.active_sites() & set(faults.TRAINER_SITES):
        # such a clause could never fire: a vacuous chaos run
        raise ValueError(
            "--chaos clauses at trainer sites (step/data_next/ckpt_save) "
            "need the per-batch step loop; drop --fused"
        )
    if on:
        if fused:
            raise ValueError(
                "--checkpoint-every-steps/--loss-guard/--step-timeout-s "
                "need the per-batch step loop; drop --fused"
            )
        if num_model > 1:
            raise ValueError("the resilient runtime rides the DP paths; drop --tp/--pp")
        if loss_guard and world.world_size > 1:
            # each rank would decide a rollback from its own loss
            raise ValueError(
                "--loss-guard is single-controller (a rollback decision "
                "taken from per-host loss shards could diverge across "
                "ranks); drop it on multi-process runs"
            )
    if ckpt_every > 0 and not args.save_state:
        raise ValueError(
            "--checkpoint-every-steps writes mid-epoch archives to the "
            "--save-state path; add --save-state PATH"
        )


def _host_state(model: Net, state: TrainState, zero: bool, world: DistState) -> TrainArchive:
    """The training state as an archive holds it, on the host: the
    parameters, the accumulators (ZeRO's chunks gathered per leaf, a
    collective every rank runs), the step and the BatchNorm averages."""
    params = dict(model.named_parameters())
    opt = state.opt
    if zero:
        opt = zero_opt_to_per_leaf(opt, params, world_group(world))
    opt = _opt_to(opt, torch.device("cpu"))
    stats = {k: v.detach().cpu() for k, v in model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    return TrainArchive(params={k: v.detach().cpu() for k, v in params.items()}, opt=opt,
                        step=int(state.step), batch_stats=stats)


def _make_runtime(args, world: DistState, zero: bool, global_batch: int, extras: dict,
                  telemetry: Telemetry | None) -> ResilientRuntime | None:
    """The resilient runtime, where a resilience flag is set, a fault
    injector is installed or ``ELASTIC_HEARTBEAT_FILE`` is; else None (the
    step loop as it is without one)."""
    heartbeat = RankHeartbeat.from_env()
    ckpt_every, loss_guard, step_timeout = _resilience_flags(args)
    if not (ckpt_every > 0 or loss_guard or step_timeout > 0 or faults.active()
            or heartbeat is not None):
        return None
    registry = telemetry.registry if telemetry is not None else None
    sink = telemetry.events if telemetry is not None else None
    guard = (LossGuard(spike_factor=float(getattr(args, "spike_factor", 10.0)),
                       retry_budget=int(getattr(args, "anomaly_budget", 3)),
                       lr_backoff=float(getattr(args, "anomaly_lr_backoff", 0.5)))
             if loss_guard else None)
    checkpointer = (MidEpochCheckpointer(args.save_state, ckpt_every, seed=int(args.seed),
                                         global_batch=global_batch,
                                         world_size=world.world_size,
                                         registry=registry, sink=sink)
                    if ckpt_every > 0 else None)
    preemption = (PreemptionHandler(grace_s=float(getattr(args, "preempt_grace_s", 30.0)))
                  if checkpointer is not None else None)
    return ResilientRuntime(
        guard=guard, checkpointer=checkpointer, preemption=preemption,
        step_timeout_s=step_timeout, stall_abort=bool(getattr(args, "stall_abort", False)),
        prepare=lambda model, state: _host_state(model, state, zero, world),
        global_batch=global_batch, steps_total=int(extras.get("steps_total", 0)),
        samples_total=int(extras.get("samples_total", 0)), registry=registry, sink=sink,
        is_chief=world.is_chief, heartbeat=heartbeat,
    ).start()


def _elastic_archive(args) -> str | None:
    """The run's own ``--save-state`` archive to resume under the elastic
    contract, or None."""
    elastic = bool(getattr(args, "elastic", False)) or int(
        os.environ.get("ELASTIC_RESTART_COUNT", "0") or 0) > 0
    path = args.save_state
    if elastic and path and not args.resume_state and (
            os.path.exists(path) or os.path.exists(path + PREV_SUFFIX)):
        return path
    return None


def _fit(args, device, save_path, timings, world: DistState,
         registry=None, telemetry: Telemetry | None = None) -> tuple[Net, TrainState]:
    tp_degree, pp_on = _model_axis(args, world)
    _refuse_resilience(args, world, tp_degree if tp_degree > 1 else 2 if pp_on else 1)
    if getattr(args, "pregather", False) and not getattr(args, "fused", False):
        raise ValueError("--pregather is the fused input path; add --fused")
    fused = bool(getattr(args, "fused", False)) and not args.dry_run
    use_pallas, conv_impl = args.pallas_opt, args.conv_impl
    syncbn = bool(getattr(args, "syncbn", False))
    zero = bool(getattr(args, "zero", False))
    if zero and use_pallas:
        raise ValueError("--zero and --pallas-opt both re-lay-out the "
                         "Adadelta state; pick one")
    resume_path, resume_state_path = args.resume, args.resume_state
    if resume_path and resume_state_path:
        raise ValueError(
            "--resume (model-only checkpoint) and --resume-state (full "
            "training state) are mutually exclusive"
        )
    elastic_path = _elastic_archive(args)
    resume_state_path = resume_state_path or elastic_path
    device = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    compute_dtype = torch.bfloat16 if args.bf16 else torch.float32

    # Checkpoints load before any data or device work, so a wrong file
    # fails fast.
    epoch0, start_batch, archive, params, step0, extras = 0, 0, None, None, 0, {}
    if resume_state_path:
        archive, epoch0, extras, used_path = load_latest_train_state(resume_state_path,
                                                                     syncbn)
        if fused and extras.get("epoch_in_progress", 0):
            raise ValueError(
                f"--resume-state {resume_state_path!r} is a MID-EPOCH "
                "archive; finishing the epoch needs the per-batch step "
                "loop — drop --fused (the next end-of-run archive can "
                "resume fused again)"
            )
        start_batch = _resume_cursor(resume_state_path, extras, epoch0, args,
                                     world.world_size)
        params = {**archive.params, **archive.batch_stats}
        if elastic_path:
            # Epochs as the total: a restart reruns the same command, so
            # "train 2 epochs" finishes the 2-epoch run.
            args = argparse.Namespace(**{**vars(args),
                                         "epochs": max(int(args.epochs) - epoch0, 0)})
    elif resume_path:
        params, step0 = load_resume_state(resume_path, syncbn)

    grid = (make_rank_grid([("model", tp_degree if tp_degree > 1 else pp.NUM_STAGES)], world)
            if tp_degree > 1 or pp_on else None)
    shard = (DistState(rank=grid.coords[0], world_size=grid.num_data) if grid is not None
             else world)
    loaders = make_loaders(args, device, timings, shard, registry,
                           telemetry.events if telemetry is not None else None)
    seeds = split_streams(args.seed)
    model = Net(torch.Generator().manual_seed(seeds["init"]), use_bn=syncbn).to(device)
    if params is not None:
        model.load_state_dict(params)
    if world.distributed:
        broadcast_from_chief([*model.parameters(), *model.buffers()])
    if grid is not None:
        step_fn, eval_fn = _model_axis_steps(args, model, grid, tp_degree > 1, seeds["dropout"],
                                             compute_dtype)
        state = TrainState(opt=adadelta_init(dict(model.named_parameters())), step=step0)
    else:
        state = make_train_state(model, use_pallas=use_pallas, zero=zero, world=world)
        state.step = step0
        if archive is not None:
            opt = ensure_opt_layout(archive.opt, dict(model.named_parameters()), use_pallas)
            state = TrainState(opt=_opt_to(opt, device), step=archive.step)
        if world.distributed and archive is not None:
            step = torch.tensor([state.step], dtype=torch.int64, device=device)
            broadcast_from_chief([*_opt_tensors(state.opt), step])
            state.step = int(step.item())
        if zero and archive is not None:  # this rank's chunks of the archive's
            state.opt = per_leaf_opt_to_zero(state.opt, world_group(world))
        step_fn = make_train_step(use_pallas=use_pallas, dropout_seed=seeds["dropout"],
                                  compute_dtype=compute_dtype, conv_impl=conv_impl,
                                  world=world)
        eval_fn = make_eval_step(compute_dtype, conv_impl, world)
    if fused:
        run = FusedRun(model, state, *loaders, dropout_seed=seeds["dropout"],
                       use_pallas=use_pallas, compute_dtype=compute_dtype,
                       conv_impl=conv_impl, world=world,
                       pregather=bool(getattr(args, "pregather", False)))
        run_fused_epochs(args, run, loaders, timings, epoch0, world, telemetry)
    else:
        runtime = _make_runtime(args, world, zero, loaders[0].global_batch, extras, telemetry)
        if telemetry is not None and extras.get("epoch_in_progress", 0):
            # the counters go on from the killed run's totals
            base_steps = int(extras.get("steps_total", 0))
            base_samples = int(extras.get("samples_total", 0))
            if base_steps:
                telemetry.registry.counter("train_steps_total",
                                           help="optimizer steps executed").inc(base_steps)
            if base_samples:
                telemetry.registry.counter("train_samples_total",
                                           help="global training samples consumed"
                                           ).inc(base_samples)
            telemetry.events.emit("train_resume", epoch=extras["epoch_in_progress"],
                                  batch_cursor=start_batch, steps_total=base_steps,
                                  archive=used_path)
        try:
            run_epochs(args, device, model, state, step_fn, eval_fn, loaders, timings,
                       epoch0=epoch0, start_batch=start_batch, dist=world,
                       telemetry=telemetry, runtime=runtime)
        finally:
            if runtime is not None:
                runtime.stop()

    if args.save_model and save_path:
        # --tp's gather is collective; the chief alone writes
        full = tp.gather_replicated(model, grid.model) if tp_degree > 1 else model
        if world.is_chief:
            save_state_dict(model_state_dict(full, ddp_prefix=world.distributed,
                                             num_batches=state.step if syncbn else None),
                            save_path)
    if args.save_state:
        host = _host_state(model, state, zero, world)  # ZeRO's gather is collective
        if world.is_chief:
            # Epochs completed: where a continuation picks up the schedule,
            # the shuffle and the numbering.
            save_train_state(host.params, host.opt, host.step, args.save_state,
                             epoch=epoch0 + args.epochs, batch_stats=host.batch_stats)
    return model, state


def _model_axis_steps(args, model: Net, grid: RankGrid, tp_on: bool, dropout_seed: int,
                      compute_dtype: torch.dtype):
    """The train and eval steps of ``--tp`` (``model`` cut to this member's
    shards) or ``--pp``."""
    if tp_on:
        tp.shard_state(model, grid.model)
        return (tp.make_tp_train_step(grid, dropout_seed=dropout_seed,
                                      compute_dtype=compute_dtype),
                tp.make_tp_eval_step(grid, compute_dtype))
    return (pp.make_pp_train_step(grid, args.pp_microbatches, dropout_seed=dropout_seed,
                                  compute_dtype=compute_dtype),
            make_forward_eval_step(lambda m, x: m(x, None, "conv", compute_dtype), grid.data))
