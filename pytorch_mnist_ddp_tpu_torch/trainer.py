"""The training run on one device: train loop, eval loop, final save.

The body of the reference's ``mnist.py`` ``main()``: data, model,
Adadelta, StepLR once per epoch, evaluation after every epoch, and
``--save-model``.  The data and the epoch loop are shared with the ViT
CLI (``vit_mnist.py``).  The printed lines are the JAX package's (and so
the reference's), byte for byte.  The JAX package's other paths (resume,
fused, DDP, telemetry, the resilient runtime) are not ported yet.
"""

from __future__ import annotations

import time

import torch

from .data.loader import DataLoader
from .data.mnist import MNIST
from .device import resolve_device
from .models.net import Net
from .ops.schedule import step_lr
from .parallel.ddp import TrainState, make_eval_step, make_train_state, make_train_step
from .utils.checkpoint import model_state_dict, save_state_dict
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
) -> int:
    """One training epoch (reference ``train()``); returns the steps taken.
    The loss is read from the device only on log steps."""
    num_batches = len(loader)
    steps = 0
    for batch_idx, (x, y, w) in enumerate(loader.epoch(epoch)):
        loss = step_fn(model, state, x, y, w, lr)
        steps += 1
        if batch_idx % log_interval == 0:
            print(train_log_line(
                epoch, batch_idx * loader.batch_size, loader.dataset_len,
                batch_idx, num_batches, loss.item(),
            ))
        if dry_run:
            break
    return steps


def evaluate(eval_fn, model: Net, loader: DataLoader, dry_run: bool = False) -> tuple[float, int]:
    """Whole-test-set NLL and accuracy (reference ``test()``); prints the
    summary and returns ``(avg_loss, correct)``.  Per batch it reads two
    numbers and sums them in Python floats, as the JAX package does.  With
    ``dry_run`` only the first batch is evaluated (the ViT CLI's dry run);
    the average still divides by the whole set."""
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
    print(test_summary_lines(avg, int(correct), n))
    return avg, int(correct)


def make_loaders(
    args, device: torch.device, timings: dict | None = None
) -> tuple[DataLoader, DataLoader]:
    """Both splits of MNIST (the synthetic set without IDX files), cut to
    ``--train-limit`` where the CLI has that flag, as shuffled train and
    ordered test loaders on ``device``.  Records the sizes in ``timings``."""
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
    train_loader = DataLoader(train_set.images, train_set.labels, args.batch_size,
                              device, shuffle=True, seed=args.seed)
    test_loader = DataLoader(test_set.images, test_set.labels, args.test_batch_size,
                             device, shuffle=False)
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
) -> None:
    """``--epochs`` epochs of training, each followed by evaluation, with
    StepLR (``--lr``, ``--gamma``) once per epoch.  With ``timings`` (a
    dict from :func:`make_loaders`) the run records per-epoch training
    seconds (``epoch_train_s``, the device synchronized at each end),
    ``epoch_steps``, ``epoch1_test_accuracy`` and ``final_test_accuracy``."""
    train_loader, test_loader = loaders
    lr_fn = step_lr(args.lr, args.gamma, step_size=1)
    for epoch in range(1, args.epochs + 1):
        t0 = time.perf_counter()
        steps = train_one_epoch(step_fn, model, state, train_loader, epoch,
                                lr_fn(epoch), args.log_interval, args.dry_run)
        if timings is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            timings["epoch_train_s"].append(time.perf_counter() - t0)
            timings["epoch_steps"].append(steps)
        _, correct = evaluate(eval_fn, model, test_loader, dry_run=dry_run_eval)
        if timings is not None:
            n_test = test_loader.dataset_len
            timings.setdefault("epoch1_test_accuracy", correct / n_test)
            timings["final_test_accuracy"] = correct / n_test
        # scheduler.step() is implicit: lr_fn(epoch + 1) next iteration.


def fit(
    args,
    device: str | torch.device | None = None,
    save_path: str | None = None,
    timings: dict | None = None,
) -> tuple[Net, TrainState]:
    """The full run; returns the trained model and its state.  ``device``
    ``None`` means the card, and raises without one (``resolve_device``).

    TF32 is switched off for the f32 path, in convolutions and matmuls
    alike (cuDNN would otherwise run the convs in TF32 by default); the
    switches are process-wide.  ``timings`` is :func:`run_epochs`'s.
    """
    device = resolve_device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    loaders = make_loaders(args, device, timings)
    seeds = split_streams(args.seed)
    model = Net(torch.Generator().manual_seed(seeds["init"])).to(device)
    state = make_train_state(model, use_pallas=args.pallas_opt)
    step_fn = make_train_step(use_pallas=args.pallas_opt, dropout_seed=seeds["dropout"])
    run_epochs(args, device, model, state, step_fn, make_eval_step(), loaders, timings)

    if args.save_model and save_path:
        save_state_dict(model_state_dict(model), save_path)
    return model, state
