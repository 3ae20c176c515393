"""The training run: train loop, eval loop, final save, on one device or
as one rank of a data-parallel world.

The body of the reference's ``mnist.py`` and ``mnist_ddp.py`` ``main()``:
data, model, Adadelta, StepLR once per epoch, evaluation after every
epoch, and ``--save-model``; with the JAX package's ``--resume``
(parameters from a model checkpoint, a fresh optimizer),
``--save-state``/``--resume-state`` (the whole training state, continued
bit for bit, from a final or a mid-epoch archive of either package),
``--conv-impl``, ``--bf16``, ``--syncbn`` and ``--zero`` (the Adadelta
state sharded over the ranks, ``parallel/zero.py``; archives per leaf on
disk, so they cross with plain runs of either package).  Given a distributed
``DistState`` (``parallel/distributed.py``) each rank trains on its shard
of every epoch, the gradients are all-reduced (``parallel/ddp.py``),
every rank evaluates its shard of the test set and the totals are
summed; only rank 0 prints and saves.  The data and the epoch loop are
shared with the ViT CLI (``vit_mnist.py``).  The printed lines are the
JAX package's (and so the reference's), byte for byte.  The JAX
package's other paths (fused, TP/PP, telemetry, the resilient and
elastic runtimes) are not ported yet.
"""

from __future__ import annotations

import time

import torch

from .data.loader import DataLoader
from .data.mnist import MNIST
from .device import resolve_device
from .models.net import Net
from .ops.adadelta import AdadeltaState
from .ops.adadelta_flat import FlatAdadeltaState, ensure_opt_layout, is_flat_state
from .ops.schedule import step_lr
from .parallel.ddp import (
    TrainState,
    broadcast_from_chief,
    make_eval_step,
    make_train_state,
    make_train_step,
)
from .parallel.distributed import DistState, destroy_distributed
from .parallel.mesh import world_group
from .parallel.zero import per_leaf_opt_to_zero, zero_opt_to_per_leaf
from .utils.checkpoint import (
    load_latest_train_state,
    load_resume_state,
    model_state_dict,
    save_state_dict,
    save_train_state,
)
from .utils.logging import test_summary_lines, train_log_line
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
) -> int:
    """One training epoch (reference ``train()``); returns the steps taken.
    The loss is read from the device only on log steps, by rank 0 alone:
    its own loss, and the global sample counter ``batch_idx`` times the
    loader's global batch (``world_size * batch_size`` in distributed mode,
    mnist_ddp.py:78; ``num_data * batch_size`` for the ViT's grids).
    ``start_batch`` resumes a mid-epoch archive at its batch cursor: batch
    numbering and log lines go on as if the run had never stopped."""
    num_batches = len(loader)
    steps = 0
    for batch_idx, (x, y, w) in enumerate(loader.epoch(epoch, start_batch),
                                          start=start_batch):
        loss = step_fn(model, state, x, y, w, lr)
        steps += 1
        if dist.is_chief and batch_idx % log_interval == 0:
            print(train_log_line(
                epoch, batch_idx * loader.global_batch,
                loader.dataset_len, batch_idx, num_batches, loss.item(),
            ))
        if dry_run:
            break
    return steps


def evaluate(
    eval_fn, model: Net, loader: DataLoader, dry_run: bool = False,
    dist: DistState = DistState(),
) -> tuple[float, int]:
    """Whole-test-set NLL and accuracy (reference ``test()``); rank 0
    prints the summary, and every rank returns ``(avg_loss, correct)``.
    Per batch it reads two numbers (the all-reduced totals of every rank's
    shard, in distributed mode) and sums them in Python floats, as the JAX
    package does.  With ``dry_run`` only the first batch is evaluated (the
    ViT CLI's dry run); the average still divides by the whole set."""
    loss_sum = 0.0
    correct = 0.0
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


def make_loaders(
    args, device: torch.device, timings: dict | None = None,
    dist: DistState = DistState(),
) -> tuple[DataLoader, DataLoader]:
    """Shuffled train and ordered test loaders on ``device`` for rank
    ``dist.rank`` of ``dist.world_size``: ``--batch-size`` samples a step
    on every rank, ``ceil(--test-batch-size / world_size)`` an eval batch
    (the JAX trainer's split), the test loader's padding duplicates at
    weight 0 (:func:`_datasets`' sets)."""
    train_set, test_set = _datasets(args, timings)
    world = {"rank": dist.rank, "world_size": dist.world_size}
    train_loader = DataLoader(train_set.images, train_set.labels, args.batch_size,
                              device, shuffle=True, seed=args.seed, **world)
    test_loader = DataLoader(test_set.images, test_set.labels,
                             -(-args.test_batch_size // dist.world_size), device,
                             shuffle=False, mask_padding=True, **world)
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
                              num_shards=num_shards)
    test_loader = DataLoader(test_set.images, test_set.labels, args.test_batch_size, device,
                             shuffle=False, mask_padding=True, shard=shard,
                             num_shards=num_shards)
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
) -> None:
    """``--epochs`` epochs of training after ``epoch0`` completed ones, each
    followed by evaluation, with StepLR (``--lr``, ``--gamma``) once per
    epoch; the first starts at batch ``start_batch``.  With ``timings`` (a
    dict from :func:`make_loaders` or :func:`make_shard_loaders`) the run
    records per-epoch training seconds (``epoch_train_s``, the device
    synchronized at each end),
    ``epoch_steps``, ``epoch1_test_accuracy`` (of the run's first epoch)
    and ``final_test_accuracy``."""
    train_loader, test_loader = loaders
    lr_fn = step_lr(args.lr, args.gamma, step_size=1)
    for epoch in range(epoch0 + 1, epoch0 + args.epochs + 1):
        t0 = time.perf_counter()
        steps = train_one_epoch(step_fn, model, state, train_loader, epoch,
                                lr_fn(epoch), args.log_interval, args.dry_run,
                                start_batch if epoch == epoch0 + 1 else 0, dist)
        if timings is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            timings["epoch_train_s"].append(time.perf_counter() - t0)
            timings["epoch_steps"].append(steps)
        _, correct = evaluate(eval_fn, model, test_loader, dry_run_eval, dist)
        if timings is not None:
            n_test = test_loader.dataset_len
            timings.setdefault("epoch1_test_accuracy", correct / n_test)
            timings["final_test_accuracy"] = correct / n_test
        # scheduler.step() is implicit: lr_fn(epoch + 1) next iteration.


def _resume_cursor(
    path: str, extras: dict[str, int], epoch0: int, args, world_size: int
) -> int:
    """The batch cursor of a mid-epoch archive (0 for a final one), after
    the JAX trainer's checks that this run can continue it: the epoch in
    progress follows the completed ones, and the seed, the global batch
    (``--batch-size`` times the world size) and the world size are the
    saved run's."""
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
    if saved_ws is not None and saved_ws != world_size:
        raise ValueError(
            f"--resume-state {path!r} was saved mid-epoch at world size "
            f"{saved_ws}; this run's world size is {world_size}.  Re-sharding "
            "a mid-epoch archive is not ported: relaunch at the original "
            "world size"
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
) -> tuple[Net, TrainState]:
    """The full run; returns the trained model and its state.  ``device``
    ``None`` means the card, and raises without one (``resolve_device``).
    ``dist`` is this process's place in the world (``DistState()``, a world
    of one, by default); a distributed world's group is torn down at the
    end.

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
    the layout this run's ``--pallas-opt`` executes.  ``--save-state``
    writes the final archive after the last epoch.  Before the first
    step every rank takes rank 0's parameters and BatchNorm averages (and,
    resumed from an archive, its accumulators and step), as
    ``DistributedDataParallel``'s constructor broadcasts them.
    """
    world = dist or DistState()
    try:
        return _fit(args, device, save_path, timings, world)
    finally:
        if world.distributed:
            destroy_distributed()


def _fit(args, device, save_path, timings, world: DistState) -> tuple[Net, TrainState]:
    resume_path, resume_state_path = args.resume, args.resume_state
    if resume_path and resume_state_path:
        raise ValueError(
            "--resume (model-only checkpoint) and --resume-state (full "
            "training state) are mutually exclusive"
        )
    device = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    use_pallas, conv_impl = args.pallas_opt, args.conv_impl
    syncbn = bool(getattr(args, "syncbn", False))
    zero = bool(getattr(args, "zero", False))
    if zero and use_pallas:
        raise ValueError("--zero and --pallas-opt both re-lay-out the "
                         "Adadelta state; pick one")
    compute_dtype = torch.bfloat16 if args.bf16 else torch.float32

    # Checkpoints load before any data or device work, so a wrong file
    # fails fast.
    epoch0, start_batch, archive, params, step0 = 0, 0, None, None, 0
    if resume_state_path:
        archive, epoch0, extras, _ = load_latest_train_state(resume_state_path, syncbn)
        start_batch = _resume_cursor(resume_state_path, extras, epoch0, args,
                                     world.world_size)
        params = {**archive.params, **archive.batch_stats}
    elif resume_path:
        params, step0 = load_resume_state(resume_path, syncbn)

    loaders = make_loaders(args, device, timings, world)
    seeds = split_streams(args.seed)
    model = Net(torch.Generator().manual_seed(seeds["init"]), use_bn=syncbn).to(device)
    if params is not None:
        model.load_state_dict(params)
    state = make_train_state(model, use_pallas=use_pallas, zero=zero, world=world)
    state.step = step0
    if archive is not None:
        opt = ensure_opt_layout(archive.opt, dict(model.named_parameters()), use_pallas)
        state = TrainState(opt=_opt_to(opt, device), step=archive.step)
    if world.distributed:
        broadcast_from_chief([*model.parameters(), *model.buffers()])
        if archive is not None:
            step = torch.tensor([state.step], dtype=torch.int64, device=device)
            broadcast_from_chief([*_opt_tensors(state.opt), step])
            state.step = int(step.item())
    if zero and archive is not None:  # this rank's chunks of the archive's
        state.opt = per_leaf_opt_to_zero(state.opt, world_group(world))
    step_fn = make_train_step(use_pallas=use_pallas, dropout_seed=seeds["dropout"],
                              compute_dtype=compute_dtype, conv_impl=conv_impl, world=world)
    run_epochs(args, device, model, state, step_fn,
               make_eval_step(compute_dtype, conv_impl, world), loaders, timings,
               epoch0=epoch0, start_batch=start_batch, dist=world)

    if args.save_model and save_path and world.is_chief:
        save_state_dict(model_state_dict(model, ddp_prefix=world.distributed,
                                         num_batches=state.step if syncbn else None),
                        save_path)
    opt = state.opt
    if args.save_state and zero:  # per leaf on disk; the gather is collective
        opt = zero_opt_to_per_leaf(opt, dict(model.named_parameters()), world_group(world))
    if args.save_state and world.is_chief:
        # Epochs completed: where a continuation picks up the schedule,
        # the shuffle and the numbering.
        stats = {k: v for k, v in model.state_dict().items()
                 if k.endswith(("running_mean", "running_var"))}
        save_train_state(dict(model.named_parameters()), opt, state.step,
                         args.save_state, epoch=epoch0 + args.epochs, batch_stats=stats)
    return model, state
