"""Adadelta as one CUDA kernel over flat f32 buffers (``--pallas-opt``).

Both TPU kernels of the JAX package's ``ops/pallas_adadelta.py`` become
one launch of ``csrc/adadelta.cu`` with an ``apply_lr`` flag:

- ``fused_adadelta_flat`` (``apply_lr=1``, the TPU's ``_make_kernel``):
  reads p, g, square_avg, acc_delta and lr; writes p, square_avg and
  acc_delta in place.  Reached from ``adadelta_update_pallas``, which
  concatenates per-parameter state around the call.
- ``adadelta_delta_flat`` (``apply_lr=0``, the TPU's
  ``_make_delta_kernel``): reads g, square_avg, acc_delta; writes the raw
  delta over g's buffer (the TPU kernel's ``input_output_aliases={0: 0}``)
  and the accumulators in place.  Reached from ``adadelta_update_flat``,
  the trainer's ``--pallas-opt`` step, whose accumulators persist as
  :class:`FlatAdadeltaState` across steps, and from
  ``adadelta_step_flat`` with the data-parallel step's all-reduced flat
  gradient.

The flat order is ``named_parameters()`` order (OIHW convs), one 1-D f32
buffer of N elements with no lane padding; it is the port's own and is not
the JAX package's ``ravel_pytree`` order (``utils/convert.py`` maps an
archive's buffer between the two).  :func:`ensure_opt_layout` converts
between the flat and per-parameter layouts to match what a run executes.

For CPU tensors the wrappers run :func:`adadelta_flat_reference`, the
plain PyTorch version (``ops/adadelta.py``'s op order); for CUDA tensors
they launch the kernel or raise.  Nothing falls back from the card.

The launch goes on the current stream, so a CUDA graph captures it
(``parallel/fused.py``).  A launch recorded into a graph counts once per
replay, not at the capture: the graph's owner takes the recorded launches
(:func:`take_captured`) and adds them at each replay (:func:`count_replay`).
``lr`` may be a 0-d f32 tensor on the device, which a graph reads at each
replay, where a Python number would be baked into it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .adadelta import AdadeltaState, Params, adadelta_delta, adadelta_update

# Kernel launches by mode (one per launch; the CPU path does not count).
LAUNCHES = {"adadelta_delta": 0, "adadelta_fused": 0}
# Launches recorded into a graph under capture, not yet taken by its owner.
CAPTURED = {"adadelta_delta": 0, "adadelta_fused": 0}


def take_captured() -> dict[str, int]:
    """The launches recorded since the last call, per mode; resets them."""
    taken = dict(CAPTURED)
    for k in CAPTURED:
        CAPTURED[k] = 0
    return taken


def count_replay(recorded: dict[str, int]) -> None:
    """One replay of a graph that recorded ``recorded`` launches."""
    for k, n in recorded.items():
        LAUNCHES[k] += n


class FlatAdadeltaState(NamedTuple):
    """Accumulators as two 1-D f32 buffers of N elements in
    ``named_parameters()`` order, kept in that layout across steps.  A type
    of its own, so dispatch keys on ``isinstance``, never on a shape."""

    square_avg: torch.Tensor
    acc_delta: torch.Tensor


def adadelta_init_flat(params: Params) -> FlatAdadeltaState:
    """Zero flat accumulators on the parameters' device."""
    first = next(iter(params.values()))
    n = sum(p.numel() for p in params.values())
    return FlatAdadeltaState(
        square_avg=torch.zeros(n, dtype=torch.float32, device=first.device),
        acc_delta=torch.zeros(n, dtype=torch.float32, device=first.device),
    )


def is_flat_state(state) -> bool:
    return isinstance(state, FlatAdadeltaState)


@torch.no_grad()
def adadelta_flat_reference(
    g: torch.Tensor,
    sq: torch.Tensor,
    ac: torch.Tensor,
    rho: float,
    eps: float,
    p: torch.Tensor | None = None,
    lr: float | None = None,
) -> None:
    """Plain version of the kernel, in place: with ``p`` (and ``lr``)
    updates p, sq and ac; without, writes delta over g and updates sq
    and ac."""
    delta, new_sq, new_ac = adadelta_delta(g, sq, ac, rho, eps)
    if p is None:
        g.copy_(delta)
    else:
        p.sub_(delta.mul(lr))
    sq.copy_(new_sq)
    ac.copy_(new_ac)


def _check(tensors: dict[str, torch.Tensor]) -> tuple[str, int]:
    """All 1-D contiguous f32 of one length on one cuda or cpu device;
    returns ``(device type, n)``."""
    first = next(iter(tensors.values()))
    device, n = first.device, first.numel()
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"adadelta runs on cuda or cpu, got {device}")
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if t.dim() != 1 or t.numel() != n:
            raise ValueError(f"{name} must be 1-D of length {n}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return device.type, n


@functools.cache
def _launcher():
    fn = _build.library("adadelta").adadelta_launch
    p = ctypes.c_void_p
    f = ctypes.c_float
    fn.argtypes = [ctypes.c_int, p, p, p, p, ctypes.c_longlong, f, f, f, f,
                   ctypes.c_int, p]
    fn.restype = ctypes.c_int
    return fn


def _launch(g, sq, ac, rho: float, eps: float, p=None, lr: float = 0.0) -> None:
    dev = g.device
    n = g.numel()
    if n == 0:
        return
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        capturing = torch.cuda.is_current_stream_capturing()
        # rho, 1 - rho, eps and lr round to f32 once, here, as the plain
        # version's Python scalars do when torch multiplies an f32 tensor.
        rc = _launcher()(
            dev.index, None if p is None else p.data_ptr(), g.data_ptr(),
            sq.data_ptr(), ac.data_ptr(), n, rho, 1.0 - rho, eps, lr,
            int(p is not None), stream,
        )
    if rc != 0:
        raise RuntimeError(f"adadelta kernel launch failed: CUDA error {rc}")
    kind = "adadelta_fused" if p is not None else "adadelta_delta"
    (CAPTURED if capturing else LAUNCHES)[kind] += 1


def fused_adadelta_flat(
    flat_p: torch.Tensor,
    flat_g: torch.Tensor,
    flat_sq: torch.Tensor,
    flat_ac: torch.Tensor,
    lr: float,
    rho: float = 0.9,
    eps: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole update with ``p -= lr * delta`` inside, in place on 1-D
    f32 buffers; returns ``(p, square_avg, acc_delta)``, the same tensors."""
    kind, _ = _check({"p": flat_p, "g": flat_g, "square_avg": flat_sq,
                      "acc_delta": flat_ac})
    if kind == "cpu":
        adadelta_flat_reference(flat_g, flat_sq, flat_ac, rho, eps, flat_p, lr)
    else:
        _launch(flat_g, flat_sq, flat_ac, rho, eps, flat_p, float(lr))
    return flat_p, flat_sq, flat_ac


def adadelta_delta_flat(
    flat_g: torch.Tensor,
    flat_sq: torch.Tensor,
    flat_ac: torch.Tensor,
    rho: float = 0.9,
    eps: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The recurrence emitting raw delta over ``flat_g``'s buffer, the
    accumulators in place; returns ``(delta, square_avg, acc_delta)``,
    the same tensors as given."""
    kind, _ = _check({"g": flat_g, "square_avg": flat_sq, "acc_delta": flat_ac})
    if kind == "cpu":
        adadelta_flat_reference(flat_g, flat_sq, flat_ac, rho, eps)
    else:
        _launch(flat_g, flat_sq, flat_ac, rho, eps)
    return flat_g, flat_sq, flat_ac


def _ravel(tree: Params) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tree.values()])


def _unravel_into(flat: torch.Tensor, tree: Params) -> None:
    off = 0
    for t in tree.values():
        t.copy_(flat[off:off + t.numel()].view_as(t))
        off += t.numel()


@torch.no_grad()
def adadelta_step_flat(
    params: Params,
    flat_g: torch.Tensor,
    state: FlatAdadeltaState,
    lr: float,
    rho: float = 0.9,
    eps: float = 1e-6,
) -> tuple[Params, FlatAdadeltaState]:
    """The ``--pallas-opt`` step from a gradient that is already one flat
    buffer in ``named_parameters`` order (the data-parallel step's
    all-reduced one): one kernel launch writing delta over it, then
    ``p - lr * delta`` per parameter (a multiply, then a subtract), in
    place.  Returns ``(params, state)``, the same objects."""
    delta, _, _ = adadelta_delta_flat(flat_g, state.square_avg, state.acc_delta, rho, eps)
    off = 0
    for p in params.values():
        p.sub_(delta[off:off + p.numel()].view_as(p).mul(lr))
        off += p.numel()
    return params, state


def adadelta_update_flat(
    params: Params,
    grads: Params,
    state: FlatAdadeltaState,
    lr: float,
    rho: float = 0.9,
    eps: float = 1e-6,
) -> tuple[Params, FlatAdadeltaState]:
    """The ``--pallas-opt`` step over persistent flat accumulators: one
    concat of the grads, then :func:`adadelta_step_flat`."""
    return adadelta_step_flat(params, _ravel(grads), state, lr, rho, eps)


@torch.no_grad()
def adadelta_update_pallas(
    params: Params,
    grads: Params,
    state: AdadeltaState,
    lr: float,
    rho: float = 0.9,
    eps: float = 1e-6,
) -> tuple[Params, AdadeltaState]:
    """Per-parameter state through the fused kernel: concatenate params,
    grads and both accumulators, one launch, copy the results back."""
    flats = [_ravel(t) for t in (params, grads, state.square_avg, state.acc_delta)]
    fused_adadelta_flat(*flats, lr, rho, eps)
    for flat, tree in zip((flats[0], flats[2], flats[3]),
                          (params, state.square_avg, state.acc_delta)):
        _unravel_into(flat, tree)
    return params, state


def ensure_opt_layout(
    opt: AdadeltaState | FlatAdadeltaState, params: Params, use_pallas: bool
) -> AdadeltaState | FlatAdadeltaState:
    """Accumulators in the layout this run executes: flat with
    ``use_pallas`` (the delta kernel on the card, its plain version on the
    CPU), per parameter without; the JAX package's ``ensure_opt_layout``.
    Both layouts hold the same values in the port's order; an archive
    saved under one flag resumes under the other."""
    if is_flat_state(opt) == bool(use_pallas):
        return opt
    if use_pallas:
        return FlatAdadeltaState(square_avg=_ravel(opt.square_avg),
                                 acc_delta=_ravel(opt.acc_delta))
    trees = []
    for flat in (opt.square_avg, opt.acc_delta):
        tree = {k: torch.empty_like(p) for k, p in params.items()}
        _unravel_into(flat, tree)
        trees.append(tree)
    return AdadeltaState(*trees)


def adadelta_update_best(
    params: Params,
    grads: Params,
    state: AdadeltaState | FlatAdadeltaState,
    lr: float,
    rho: float = 0.9,
    eps: float = 1e-6,
    use_pallas: bool | None = None,
):
    """The JAX package's dispatch: flat state -> the delta kernel (the
    trainer's ``--pallas-opt`` path); per-parameter state with
    ``use_pallas`` -> the fused kernel; otherwise the plain update."""
    if is_flat_state(state):
        return adadelta_update_flat(params, grads, state, lr, rho, eps)
    if use_pallas:
        return adadelta_update_pallas(params, grads, state, lr, rho, eps)
    return adadelta_update(params, grads, state, lr, rho, eps)
