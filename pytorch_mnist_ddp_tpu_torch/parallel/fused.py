"""The fused path (``--fused``): the dataset on the device, each epoch's
steps replayed from one CUDA graph, one host read an epoch (the JAX
package's ``parallel/fused.py``).

The per-batch path pays the host for every step: batch assembly, the copy
to the device, the launch of every op, and a read of the loss on log
steps.  Here:

- the raw uint8 train and test sets live on the device (47 MB and 7.8 MB
  at MNIST's size), with each epoch's index and weight tables
  (``DataLoader.index_table``: the per-batch loader's rows in its order,
  the final partial batch wrap-filled at weight 0) uploaded once an epoch;
- a step gathers its rows by index and normalizes them on the device,
  ``x * scale + shift`` as two rounded ops, bit for bit the host's numpy
  form (``data/transforms.py``), then runs the per-batch step's own body
  (``parallel/ddp.py`` ``make_step_body``: dropout, the masked NLL, the
  gradient mean or ZeRO-1's update, the delta kernel under
  ``--pallas-opt`` or the plain update).  The body and the eval forward
  are arguments, the CNN's by default: ``parallel/fused_vit.py`` passes
  the ViT's (``make_forward_step_body``), as JAX's ``fused_vit.py``
  passes its step to ``fused.py``'s scan skeletons;
- on the card, after :data:`WARMUP_STEPS` eager steps on a side stream,
  one step is captured into a ``torch.cuda.CUDAGraph`` and every later
  step replays it.  The graph reads the step's row of the tables through
  a device cursor it advances itself, the learning rate from a 0-d device
  tensor the host writes between epochs, and the dropout generator's seed,
  which the host sets before each replay (the generator is registered with
  the graph), so a replay draws the masks the eager step draws.  The delta
  kernel's launches count once a replay (``ops/adadelta_flat.py``).  On
  the CPU the same step runs eagerly;
- losses stay on the device as ``[num_batches, n_shards]`` (all-gathered
  over the ranks) and the eval's per-batch ``(loss_sum, correct)`` rows
  as one table, all-reduced once; the host reads both in one copy an
  epoch and sums the eval rows in Python floats, as the per-batch
  evaluation does, so the printed lines are the per-batch run's.

``pregather`` gathers the whole permuted epoch once, at the epoch's start,
and each step takes its rows as one contiguous block: the same rows in
the same order, so the same bits.

The epoch's permutation is the port's own sampler's (``parallel/
sampler.py``), so a world-of-one fused run trains on exactly the
per-batch run's batches and ends on its bits.  JAX draws its permutation
on the device from ``jax.random``, which the port does not reproduce;
``perm=`` takes an explicit one in JAX's layout (each global batch of
``batch * n_shards`` rows cut into the shards' contiguous parts), which is
how the tests hold this path to JAX's.

Collectives: only NCCL's can be captured.  On the card a world whose
backend is another (gloo ranks sharing a card) is refused; on the CPU gloo
ranks run the same steps eagerly.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..data.loader import DataLoader
from ..data.transforms import MNIST_MEAN, MNIST_STD
from ..ops import adadelta_flat
from .ddp import TrainState, dropout_seed_of, make_forward_eval_step, make_step_body
from .distributed import DistState
from .mesh import all_gather_flat, world_group

# Eager steps before the capture, on a side stream: cuDNN's and cuBLAS's
# handles and workspaces, NCCL's communicator and the allocator's blocks
# are set up outside the graph.
WARMUP_STEPS = 2


def normalize_dev(x_u8: torch.Tensor) -> torch.Tensor:
    """uint8 ``[n, 28, 28]`` -> float32 ``[n, 28, 28, 1]`` on the device:
    ``data/transforms.py``'s ``x * scale + shift`` with the same f32
    constants, a rounded multiply and then a rounded add (no FMA), in the
    loader's layout (numpy's ``x[..., None]``: the channel axis at stride
    0; the convolutions may sum in another order for another layout)."""
    on = {"dtype": torch.float32, "device": x_u8.device}
    # Filled on the device (a copy from the host could not be captured).
    scale = torch.full((), float(np.float32(1.0 / (255.0 * MNIST_STD))), **on)
    shift = torch.full((), float(np.float32(-MNIST_MEAN / MNIST_STD)), **on)
    x = x_u8.to(torch.float32).mul(scale).add(shift)
    return x.as_strided((*x.shape, 1), (*x.stride(), 0))


def device_put_dataset(images: np.ndarray, labels: np.ndarray,
                       device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The raw uint8 images and int64 labels on ``device``, once a run."""
    return (torch.from_numpy(np.array(images, np.uint8)).to(device),
            torch.from_numpy(np.array(labels, np.int64)).to(device))


def perm_table(perm, batch: int, shard: int = 0,
               num_shards: int = 1) -> tuple[np.ndarray, np.ndarray]:
    """JAX's fused layout of an epoch's permutation ``perm`` of n rows:
    global batches of ``batch * num_shards`` rows, ``shard``'s ``batch``
    rows of each, the last global batch filled by wrapping ``perm`` at
    weight 0.  Returns ``(idx [batches, batch], w [batches, batch])``."""
    perm = np.asarray(perm, np.int64)
    n, global_batch = len(perm), batch * num_shards
    pos = (np.arange(-(-n // global_batch))[:, None] * global_batch + shard * batch
           + np.arange(batch))
    return perm[pos % n], (pos < n).astype(np.float32)


def _upload(dst: torch.Tensor, src: np.ndarray) -> None:
    """``src`` into ``dst`` without waiting for the device (pinned,
    ``non_blocking``; the host allocator holds the pinned block until the
    copy has read it)."""
    t = torch.from_numpy(src)
    if dst.is_cuda:
        t = t.pin_memory()
    dst.copy_(t, non_blocking=dst.is_cuda)


def _refuse_uncapturable(device: torch.device, world: DistState) -> None:
    if device.type == "cuda" and world.distributed and dist.get_backend() != "nccl":
        raise ValueError(
            "--fused on the card replays each step from a CUDA graph, and only "
            f"NCCL's collectives can be captured; this world's backend is "
            f"{dist.get_backend()}: run one rank a card over NCCL, or drop --fused"
        )


class FusedEpoch:
    """``model`` and ``state`` trained in place over the epochs of
    ``loader`` (its rows, batch size and rank): ``epoch(e, lr)`` runs every
    step of epoch ``e`` and returns the losses ``[num_batches, n_shards]``
    on the device.  :meth:`load` and :meth:`step` run part of an epoch.

    On the card the step is captured in a CUDA graph after
    :data:`WARMUP_STEPS` eager steps; ``replays`` and ``eager_steps`` count
    the two kinds, and ``capture_s`` is the seconds the capture took.
    ``body`` is the step's work, ``body(model, opt, x, y, w, lr,
    generator) -> loss`` (``parallel/ddp.py``); by default the CNN's,
    :func:`~.ddp.make_step_body` of the arguments below, which are
    :func:`~.ddp.make_train_step`'s.  Without ``dropout`` no generator is
    made, passed or registered with the graph."""

    def __init__(
        self,
        model: torch.nn.Module,
        state: TrainState,
        loader: DataLoader,
        dropout: bool = True,
        dropout_seed: int = 0,
        use_pallas: bool = False,
        compute_dtype: torch.dtype = torch.float32,
        conv_impl: str = "conv",
        world: DistState | None = None,
        pregather: bool = False,
        rho: float = 0.9,
        eps: float = 1e-6,
        body: Callable[..., torch.Tensor] | None = None,
    ) -> None:
        self.world = world or DistState()
        self.device = next(model.parameters()).device
        _refuse_uncapturable(self.device, self.world)
        self.model, self.state, self.loader = model, state, loader
        self.dropout_seed = dropout_seed
        self.use_graph = self.device.type == "cuda"
        self.images, self.labels = device_put_dataset(loader.images, loader.labels, self.device)
        self.num_batches, bs = len(loader), loader.batch_size
        on = {"device": self.device}
        self.idx = torch.zeros(self.num_batches, bs, dtype=torch.int64, **on)
        self.w = torch.zeros(self.num_batches, bs, dtype=torch.float32, **on)
        self.cursor = torch.zeros(1, dtype=torch.int64, **on)
        self.lr = torch.zeros((), dtype=torch.float32, **on)
        self.losses = torch.zeros(self.num_batches, dtype=torch.float32, **on)
        self.pregathered = None
        if pregather:
            self.pregathered = (
                torch.empty(self.num_batches, bs, *self.images.shape[1:], dtype=torch.uint8,
                            **on),
                torch.empty(self.num_batches, bs, dtype=torch.int64, **on))
        self.body = body or make_step_body(use_pallas, rho, eps, compute_dtype, conv_impl,
                                           self.world)
        self.generator = torch.Generator(device=self.device) if dropout else None
        self.graph: torch.cuda.CUDAGraph | None = None
        self.recorded: dict[str, int] = {}
        self.eager_steps = 0
        self.replays = 0
        self.capture_s = 0.0
        self._side = None

    def load(self, epoch: int, lr, perm=None) -> None:
        """Epoch ``epoch``'s tables (the loader's, or ``perm`` in JAX's
        layout over the ranks), the pregathered rows, the cursor at its
        first step, and ``lr``."""
        if perm is None:
            idx, w = self.loader.index_table(epoch)
        else:
            idx, w = perm_table(perm, self.loader.batch_size, self.world.rank,
                                self.world.world_size)
        if idx.shape != tuple(self.idx.shape):
            raise ValueError(f"perm gives {idx.shape[0]} batches of {idx.shape[1]}; "
                             f"this epoch has {tuple(self.idx.shape)}")
        _upload(self.idx, idx)
        _upload(self.w, w)
        if self.pregathered is not None:
            flat = self.idx.view(-1)
            xs, ys = self.pregathered
            torch.index_select(self.images, 0, flat, out=xs.view(-1, *xs.shape[2:]))
            torch.index_select(self.labels, 0, flat, out=ys.view(-1))
        self.cursor.zero_()
        self.lr.fill_(lr)

    def _batch(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        row = self.cursor
        if self.pregathered is not None:
            xs, ys = self.pregathered
            x_u8, y = xs.index_select(0, row)[0], ys.index_select(0, row)[0]
        else:
            idx = self.idx.index_select(0, row)[0]
            x_u8, y = self.images.index_select(0, idx), self.labels.index_select(0, idx)
        return normalize_dev(x_u8), y, self.w.index_select(0, row)[0]

    def _run_step(self) -> None:
        """The step the graph holds: this cursor's batch, the body, its
        loss into the table, the cursor on."""
        x, y, w = self._batch()
        loss = self.body(self.model, self.state.opt, x, y, w, self.lr, self.generator)
        self.losses.index_copy_(0, self.cursor, loss.view(1))
        self.cursor.add_(1)

    def _capture(self) -> None:
        t0 = time.perf_counter()
        adadelta_flat.take_captured()
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        with torch.cuda.graph(graph):
            self._run_step()
        self.recorded = adadelta_flat.take_captured()
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def step(self) -> None:
        """The next step of the loaded epoch."""
        if self.generator is not None:
            self.generator.manual_seed(dropout_seed_of(self.dropout_seed, self.state.step,
                                                       self.world))
        if self.use_graph and self.graph is None and self.eager_steps >= WARMUP_STEPS:
            self._capture()
        if self.graph is not None:
            self.graph.replay()
            adadelta_flat.count_replay(self.recorded)
            self.replays += 1
        elif self.use_graph:
            current = torch.cuda.current_stream(self.device)
            if self._side is None:
                self._side = torch.cuda.Stream(self.device)
            self._side.wait_stream(current)
            with torch.cuda.stream(self._side):
                self._run_step()
            current.wait_stream(self._side)
            self.eager_steps += 1
        else:
            self._run_step()
            self.eager_steps += 1
        self.state.step += 1

    def gathered_losses(self) -> torch.Tensor:
        """``[num_batches, n_shards]``: every rank's losses, on the device."""
        if not self.world.distributed:
            return self.losses.view(-1, 1).clone()
        every = all_gather_flat(self.losses, world_group(self.world))
        return every.view(self.world.world_size, -1).t().contiguous()

    def epoch(self, epoch: int, lr, perm=None) -> torch.Tensor:
        """Every step of ``epoch`` at ``lr``; the losses, on the device."""
        self.load(epoch, lr, perm)
        for _ in range(self.num_batches):
            self.step()
        return self.gathered_losses()


class FusedEval:
    """The whole test set of ``loader`` on the device: ``__call__(model)``
    returns the per-batch ``(loss_sum, correct)`` rows ``[batches, 2]``
    over the real (weight-1) samples, summed over the ranks by one
    all-reduce.  ``forward(model, x) -> log-probs`` is the eval forward;
    by default the CNN's with ``compute_dtype`` and ``conv_impl``."""

    def __init__(self, loader: DataLoader, compute_dtype: torch.dtype = torch.float32,
                 conv_impl: str = "conv", world: DistState | None = None,
                 device: torch.device | None = None,
                 forward: Callable[[torch.nn.Module, torch.Tensor], torch.Tensor] | None = None,
                 ) -> None:
        self.world = world or DistState()
        device = torch.device(device or loader.device)
        self.images, self.labels = device_put_dataset(loader.images, loader.labels, device)
        idx, w = loader.index_table(0)
        self.idx, self.w = torch.from_numpy(idx).to(device), torch.from_numpy(w).to(device)
        self.eval_step = make_forward_eval_step(
            forward or (lambda model, x: model(x, None, conv_impl, compute_dtype)))

    def __call__(self, model: torch.nn.Module) -> torch.Tensor:
        rows = []
        for idx, w in zip(self.idx, self.w):
            x = normalize_dev(self.images.index_select(0, idx))
            rows.append(torch.stack(self.eval_step(model, x, self.labels.index_select(0, idx),
                                                   w)))
        table = torch.stack(rows)
        if self.world.distributed:
            dist.all_reduce(table)
        return table


def eval_totals(table: np.ndarray) -> tuple[float, int]:
    """``(loss_sum, correct)`` from the host copy of a :class:`FusedEval`
    table: the rows summed in Python floats in batch order, as the
    per-batch evaluation sums what it reads."""
    loss_sum = correct = 0.0
    for batch_loss, batch_correct in table.tolist():
        loss_sum += batch_loss
        correct += batch_correct
    return loss_sum, int(correct)


class FusedRun:
    """Training epochs and their evaluations over device-resident sets,
    one host read an epoch (``host_syncs`` counts them); the trainer's
    ``run_fused_epochs`` drives it over ``--epochs`` from the resumed
    epoch on, at the host's StepLR values.  ``eval_forward`` is
    :class:`FusedEval`'s ``forward``; the other keyword arguments are
    :class:`FusedEpoch`'s."""

    def __init__(self, model: torch.nn.Module, state: TrainState, train_loader: DataLoader,
                 test_loader: DataLoader, eval_forward=None, **kwargs) -> None:
        self.model = model
        self.train = FusedEpoch(model, state, train_loader, **kwargs)
        self.eval = FusedEval(test_loader, kwargs.get("compute_dtype", torch.float32),
                              kwargs.get("conv_impl", "conv"), self.train.world,
                              self.train.device, eval_forward)
        self.num_batches = self.train.num_batches
        self.host_syncs = 0

    def epoch(self, epoch: int, lr) -> tuple[np.ndarray, tuple[float, int]]:
        """Epoch ``epoch``'s training and evaluation; returns the losses
        ``[num_batches, n_shards]`` and ``(loss_sum, correct)``."""
        losses = self.train.epoch(epoch, lr)
        table = self.eval(self.model)
        host = torch.cat([losses.reshape(-1), table.reshape(-1)]).cpu().numpy()
        self.host_syncs += 1
        return host[:losses.numel()].reshape(losses.shape), eval_totals(
            host[losses.numel():].reshape(table.shape))
