"""The rank grid (data x seq x model) and the collectives the parallel ViT
runs over it.

The JAX package lays its devices out as a mesh (``parallel/mesh.py``
``make_nd_mesh``): ``devices[:need]`` reshaped to ``(data, *minors)``,
data outermost and model innermost, the data degree whatever the minor
axes leave.  Here one process drives one card, so rank r of the world sits
where JAX puts device r: ``r = (d * S + s) * M + m`` for coordinates
``(d, s, m)`` on a grid of shape ``(D, S, M)``.

Each axis gives process groups: a seq ring per (d, m), a model group per
(d, s), a data group per (s, m), and a gradient group per m, the ranks
that share a model coordinate (data x seq), over which the sp/tp steps sum
their gradients; ``RankGrid.world`` is every rank (the default group),
over which the pipeline (``--pp``, the model axis its stages) sums its
stages' disjoint gradients.  ``dist.new_group`` is collective over the world, so
every rank creates every group, in the same order, those it is not in
included.  A group of one has no process group and launches no
collective: a world of one runs the degree-1 paths with none.

The collectives are autograd functions with the gradients JAX's VMA
transposes give (``ops`` of :class:`Group`):

- :func:`ring_pass`: this member's block to the next member of the ring,
  the previous member's block back, as one paired ``isend``/``irecv``;
  its backward sends the gradient the other way;
- :func:`reduce_forward` (a ``psum`` whose result every member uses
  alike): all-reduce forward, identity backward;
- :func:`reduce_backward` (a replicated value entering a per-member
  computation): identity forward, all-reduce backward;
- :func:`all_to_all`: chunk j of dim 0 to member j; self-transposed;
- :func:`mean_forward` (JAX's ``pmean`` of a per-member value under
  VMA): the group's mean forward, the gradient passed to each member's
  own value as it is;
- :func:`count_once`: identity forward; backward keeps the gradient on
  member 0 and zeroes it elsewhere, for a parameter every member uses
  alike after a :func:`reduce_forward` (its gradient then sums once over
  the group).

Transport.  NCCL takes device tensors as they are, and so do gloo's
all-reduce, all-gather and all-to-all.  gloo's point-to-point send and
receive do not: its TCP transport reads and writes the tensor's memory
from the host (a CUDA tensor fails with ``writev ...: Bad address``,
``tools/gloo_cuda_probe.py``).  So the ring pass of a CUDA tensor in a
gloo group goes through a host copy each way, and :data:`STAGED` counts
those passes and their bytes.  Which transport runs is fixed by the
group's backend and the tensor's device; nothing switches between them.

:class:`Lockstep` is the other way to run ``k`` shards: one process steps
them all, each on a stream of its own device, and its collectives are
copies between those streams (the sharded serving replicas).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from .distributed import DistState

AXES = ("data", "seq", "model")
# Ring passes that went through a host copy (gloo with CUDA tensors): the
# passes and the bytes sent.
STAGED = {"calls": 0, "bytes": 0}


@dataclass(frozen=True)
class Group:
    """One group of the grid as this rank sees it: its members' global
    ranks in group order, this rank's position, the process group (None
    for a group of one) and its backend."""

    ranks: tuple[int, ...] = (0,)
    rank: int = 0
    pg: object = field(default=None, compare=False)
    backend: str | None = None

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclass(frozen=True)
class RankGrid:
    """This rank's place on the ``(data, seq, model)`` grid and its groups.
    ``RankGrid()`` is a world of one."""

    shape: tuple[int, int, int] = (1, 1, 1)
    coords: tuple[int, int, int] = (0, 0, 0)
    data: Group = Group()
    seq: Group = Group()
    model: Group = Group()
    grad: Group = Group()
    world: Group = Group()

    @property
    def num_data(self) -> int:
        return self.shape[0]


def grid_rank(d: int, s: int, m: int, shape: tuple[int, int, int]) -> int:
    """The global rank at ``(d, s, m)``: JAX's row-major device order."""
    _, num_seq, num_model = shape
    return (d * num_seq + s) * num_model + m


def grid_coords(rank: int, shape: tuple[int, int, int]) -> tuple[int, int, int]:
    _, num_seq, num_model = shape
    return rank // (num_seq * num_model), (rank // num_model) % num_seq, rank % num_model


def grid_shape(minors: list[tuple[str, int]], world_size: int) -> tuple[int, int, int]:
    """``(D, S, M)`` for the minor axes ``minors`` (``[("seq", S)]``,
    ``[("model", M)]`` or both) over ``world_size`` ranks, with JAX's
    ``make_nd_mesh`` texts when they do not divide it."""
    sizes = dict(minors)
    minor = 1
    for _, size in minors:
        minor *= size
    if world_size % minor:
        raise ValueError(
            f"{world_size} devices not divisible by "
            + "*".join(f"{n}={s}" for n, s in minors)
        )
    return world_size // minor, sizes.get("seq", 1), sizes.get("model", 1)


def _members(shape: tuple[int, int, int]) -> dict[str, list[tuple[int, ...]]]:
    """Every group of every axis, as tuples of global ranks, in the one
    order every rank creates them."""
    num_data, num_seq, num_model = shape
    at = lambda d, s, m: grid_rank(d, s, m, shape)  # noqa: E731
    return {
        "data": [tuple(at(d, s, m) for d in range(num_data))
                 for s in range(num_seq) for m in range(num_model)],
        "seq": [tuple(at(d, s, m) for s in range(num_seq))
                for d in range(num_data) for m in range(num_model)],
        "model": [tuple(at(d, s, m) for m in range(num_model))
                  for d in range(num_data) for s in range(num_seq)],
        "grad": [tuple(at(d, s, m) for d in range(num_data) for s in range(num_seq))
                 for m in range(num_model)],
    }


def make_rank_grid(minors: list[tuple[str, int]], world: DistState = DistState()) -> RankGrid:
    """The grid of ``world`` for the minor axes ``minors``, the data degree
    what they leave (JAX's ``num_data=None``), with this rank's groups.
    Collective over a distributed world: every rank calls it once, with the
    same ``minors``."""
    shape = grid_shape(minors, world.world_size)
    backend = dist.get_backend() if world.distributed else None
    mine = {}
    for axis, groups in _members(shape).items():
        for ranks in groups:
            # new_group is collective: every rank creates every group.
            pg = dist.new_group(list(ranks)) if len(ranks) > 1 else None
            if world.rank in ranks:
                mine[axis] = Group(ranks, ranks.index(world.rank), pg, backend)
    return RankGrid(shape, grid_coords(world.rank, shape), world=world_group(world), **mine)


def world_group(world: DistState = DistState()) -> Group:
    """Every rank of ``world`` as a :class:`Group`: the default process
    group (``pg`` None)."""
    backend = dist.get_backend() if world.distributed else None
    return Group(tuple(range(world.world_size)), world.rank, None, backend)


# -- transport -----------------------------------------------------------------

def all_reduce_(t: torch.Tensor, group: Group) -> torch.Tensor:
    """Sum ``t`` over the group in place; returns ``t``."""
    if group.size > 1:
        dist.all_reduce(t, group=group.pg)
    return t


def all_gather(t: torch.Tensor, group: Group) -> list[torch.Tensor]:
    """Every member's ``t``, in group order."""
    if group.size == 1:
        return [t]
    src = t.contiguous()
    out = [torch.empty_like(src) for _ in range(group.size)]
    dist.all_gather(out, src, group=group.pg)
    return out


def _exchange(x: torch.Tensor, group: Group, to: int, frm: int) -> torch.Tensor:
    """Send ``x`` to member ``to`` and receive a tensor like it from member
    ``frm``, posted together; through host copies for gloo's send and
    receive of a CUDA tensor."""
    x = x.contiguous()
    staged = x.is_cuda and group.backend == "gloo"
    src = x.cpu() if staged else x
    dst = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, group.ranks[to], group.pg),
           dist.P2POp(dist.irecv, dst, group.ranks[frm], group.pg)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        STAGED["calls"] += 1
        STAGED["bytes"] += x.numel() * x.element_size()
        return dst.to(x.device)
    return dst


def reduce_scatter(flat: torch.Tensor, group: Group) -> torch.Tensor:
    """This member's chunk of ``flat`` summed over the group: ``flat`` is
    ``size`` equal chunks, member j gets the sum of chunk j."""
    if group.size == 1:
        return flat
    out = flat.new_empty(flat.numel() // group.size)
    dist.reduce_scatter_tensor(out, flat.contiguous(), group=group.pg)
    return out


def all_gather_flat(t: torch.Tensor, group: Group) -> torch.Tensor:
    """Every member's 1-D ``t`` concatenated in group order."""
    if group.size == 1:
        return t
    out = t.new_empty(t.numel() * group.size)
    dist.all_gather_into_tensor(out, t.contiguous(), group=group.pg)
    return out


def stage_shift(x: torch.Tensor | None, group: Group, to: int | None, frm: int | None,
                like: torch.Tensor) -> torch.Tensor | None:
    """The pipeline's one-way hop: send ``x`` to member ``to`` (None: send
    nothing) and receive a tensor shaped and typed as ``like`` from member
    ``frm`` (None: receive nothing), posted together; returns what
    arrived.  A member with neither posts nothing.  Through host copies
    for gloo and CUDA tensors, each staged send counted in
    :data:`STAGED`."""
    staged = like.is_cuda and group.backend == "gloo"
    ops, dst = [], None
    if to is not None:
        src = x.contiguous()
        if staged:
            src = src.cpu()
            STAGED["calls"] += 1
            STAGED["bytes"] += x.numel() * x.element_size()
        ops.append(dist.P2POp(dist.isend, src, group.ranks[to], group.pg))
    if frm is not None:
        dst = torch.empty(like.shape, dtype=like.dtype, device="cpu" if staged else like.device)
        ops.append(dist.P2POp(dist.irecv, dst, group.ranks[frm], group.pg))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if dst is not None and staged:
        return dst.to(like.device)
    return dst


def _all_to_all(x: torch.Tensor, group: Group) -> torch.Tensor:
    x = x.contiguous()
    dst = torch.empty_like(x)
    dist.all_to_all_single(dst, x, group=group.pg)
    return dst


# -- autograd collectives --------------------------------------------------------

class _RingPass(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group, (group.rank + 1) % group.size,
                         (group.rank - 1) % group.size)

    @staticmethod
    def backward(ctx, g):
        group = ctx.group
        return _exchange(g, group, (group.rank - 1) % group.size,
                         (group.rank + 1) % group.size), None


class _ReduceForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ReduceBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _MeanForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        size = torch.full((), group.size, dtype=x.dtype, device=x.device)
        return all_reduce_(x.clone(), group).div_(size)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CountOnce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.first = group.rank == 0
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.first else torch.zeros_like(g)), None


def ring_pass(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The previous member's ``x``; ours goes to the next member."""
    return x if group.size == 1 else _RingPass.apply(x, group)


def reduce_forward(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x`` summed over the group; the gradient passes as it is."""
    return x if group.size == 1 else _ReduceForward.apply(x, group)


def reduce_backward(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x`` as it is; its gradient summed over the group."""
    return x if group.size == 1 else _ReduceBackward.apply(x, group)


def all_to_all(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x [size, ...]``: chunk j goes to member j, and chunk j of the
    result came from member j."""
    return x if group.size == 1 else _AllToAll.apply(x, group)


def mean_forward(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x`` averaged over the group (divided by a tensor); the gradient
    reaches each member's own ``x`` as it is: the cotangent JAX's VMA
    gives a ``pmean``'d per-device value whose result every device adds to
    its own loss (the group's cotangents sum to ``size`` times each, the
    mean divides them back)."""
    return x if group.size == 1 else _MeanForward.apply(x, group)


def count_once(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``x`` as it is; its gradient kept on member 0 only."""
    return x if group.size == 1 else _CountOnce.apply(x, group)


# -- one controller over k shards -------------------------------------------------

def _on(stream):
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


class Lockstep:
    """``k`` shards stepped by one controller: the single-process
    counterpart of a ``shard_map`` over a ``k``-device mesh, which the
    sharded serving replicas run (``serving/sharded.py``).  Shard ``i``
    works on ``devices[i]`` on a CUDA stream of its own (none on the CPU);
    the controller is whatever stream is current on ``devices[0]`` when a
    collective is called (the engine's), and holds the replica's inputs,
    its replicated activations and its answers.

    The collectives are explicit copies between streams: :meth:`psum` sums
    the shards' parts in shard order on the controller, :meth:`gather`
    concatenates them there, :meth:`to_shards` hands a controller value to
    every shard, and :meth:`send` moves a tensor from shard ``i`` to shard
    ``j`` (EP's all-to-all slices, PP's hop to the next stage).  Each
    hand-off makes the reader's stream wait on the writer's (an event), and
    a tensor read on a stream it was not made on is marked used there
    (``record_stream``), so the caching allocator does not hand its memory
    out before the reader is done.  Call the collectives outside
    :meth:`on` blocks: they read the controller's stream as current.
    """

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        self.streams = tuple(torch.cuda.Stream(d) if d.type == "cuda" else None
                             for d in self.devices)

    @property
    def size(self) -> int:
        return len(self.devices)

    def on(self, i: int):
        """A context in which shard ``i``'s stream is current."""
        return _on(self.streams[i])

    def _controller(self):
        dev = self.devices[0]
        return torch.cuda.current_stream(dev) if dev.type == "cuda" else None

    @staticmethod
    def _hop(t: torch.Tensor, src, device: torch.device, dst) -> torch.Tensor:
        """``t``, written on stream ``src``, as a tensor stream ``dst`` may
        read on ``device``.  A copy between cards runs on ``src`` behind a
        two-way barrier with ``dst`` (PyTorch's cross-device copy)."""
        if dst is not None and src is not None and dst != src:
            dst.wait_stream(src)
        if t.device == device:
            if dst is not None:
                t.record_stream(dst)
            return t
        with _on(src), _on(dst):
            return t.to(device, non_blocking=True)

    def to_shard(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """A controller value handed to shard ``i``."""
        return self._hop(t, self._controller(), self.devices[i], self.streams[i])

    def to_shards(self, t: torch.Tensor) -> list[torch.Tensor]:
        """A replicated controller value handed to every shard."""
        return [self.to_shard(t, i) for i in range(self.size)]

    def scatter_rows(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Row block ``i`` of a controller value to shard ``i`` (the data
        axis; the row count must divide)."""
        return [self.to_shard(block, i) for i, block in enumerate(t.chunk(self.size))]

    def send(self, t: torch.Tensor, i: int, j: int) -> torch.Tensor:
        """Shard ``i``'s ``t`` handed to shard ``j``."""
        return self._hop(t, self.streams[i], self.devices[j], self.streams[j])

    def to_controller(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """Shard ``i``'s ``t`` handed to the controller."""
        return self._hop(t, self.streams[i], self.devices[0], self._controller())

    def psum(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The shards' parts summed in shard order on the controller."""
        total = self.to_controller(parts[0], 0)
        for i in range(1, self.size):
            total = total + self.to_controller(parts[i], i)
        return total

    def gather(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The shards' row blocks concatenated on the controller."""
        return torch.cat([self.to_controller(p, i) for i, p in enumerate(parts)])
