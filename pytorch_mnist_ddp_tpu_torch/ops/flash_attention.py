"""Flash attention as one CUDA kernel (``--flash``), with autograd.

Both TPU kernels of the JAX package's ``ops/pallas_attention.py`` become
one launch of ``csrc/flash_attention.cu`` with a mode flag:

- ``flash_fwd`` (mode ``fwd``, the TPU's ``_fwd_kernel``): the whole
  attention of q against every key, from the empty state; returns ``out
  [b, t, h, d]`` and ``lse [b, h, t]``.  Reached from
  :func:`flash_attention`, the single-device ``--flash`` path.
- ``flash_partial`` (mode ``partial``, the TPU's ``_partial_kernel``): one
  ring hop, folding a k/v block into the state ``(m, l, a)`` of
  ``ops/attention.py``'s ``BlockAcc`` layout and returning the raw state.
  With ``inplace=True`` the state buffers are updated in place, as the TPU
  kernel aliases them.  Reached from :func:`flash_block_update`, the
  ``--sp --flash`` ring (``parallel/sp.py``).

q, k and v keep JAX's ``[b, t, h, d]`` layout, share one dtype (float32
or bfloat16) and are passed by their (b, t, h) strides with stride 1 along
d: the ViT hands in the q/k/v views of its head-major qkv projection, and a
copy of each would cost as much traffic as the kernel itself at the ViT's
shapes.  Nothing is padded; the kernel copies k/v 16 bytes at a time where
their bases and strides allow, else one element at a time, and takes any
d >= 1 (past 128 columns it loops over the output in 128-column slabs).
The softmax state (m, l, a) and lse are float32 in both dtypes; the output
takes the input dtype.  float16 is refused: the JAX package's kernel would
take it, but no path of the repo runs it (ROADMAP queue 3).

The kernel follows the Pallas kernel's ``_fold_block``, which for bf16
inputs is not ``ops/attention.py``'s ``block_update``: scores accumulate in
float32 from the bf16 inputs, ``l`` sums the unrounded float32 ``p``, and
``p`` is rounded to bf16 (to nearest even) only for P·V; the output is
``acc / l`` cast to bf16.  The plain versions :func:`flash_fwd_reference`
and :func:`flash_partial_reference` are written to that contract
(:func:`kernel_fold`); for float32 it coincides with ``block_update``.
f32 products run on the tensor cores as 3xTF32 (each operand split into
two TF32 halves, three ``mma.sync`` passes, the two small terms accumulated
apart from the large one); bf16 ones as one bf16 ``mma.sync`` pass.  The
kernel is checked only on the card: ``chip_smoke.py`` holds it to the plain
versions (f32 quantities within rtol 1e-5 / atol 1e-6, bf16 outputs within
a bf16 ulp), records the share of the gate each quantity uses, and holds
kernel and plain version against the fold in f64 at t = 8192.
``tests/test_torch_attention.py`` models the split in numpy on the CPU to
show why one TF32 pass would not do; it runs no kernel.

For CPU tensors the wrappers run the plain PyTorch versions; for CUDA
tensors they launch the kernel or raise.  Nothing falls back from the card.
JAX has no backward kernel, so none is written here:
:func:`flash_attention`'s backward is a torch port of the JAX package's
blockwise backward (``_bwd_blockwise``, in float32 from upcast inputs), and
:func:`flash_block_update`'s recomputes through :func:`partial_twin`, the
port of JAX's ``_partial_ref``: the fold in float32 from upcast q/k/v, p
unrounded, so both backwards take the gradient of the unrounded function,
as JAX's do.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .attention import (
    BlockAcc,
    block_lse,
    finalize_block_acc,
    full_attention,
    init_block_acc,
    softmax_scale,
)

# Kernel launches by mode (one per launch; the CPU path does not count).
LAUNCHES = {"flash_fwd": 0, "flash_partial": 0}
_MODES = {"flash_fwd": 0, "flash_partial": 1}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # the kernel's dtype codes
_MAX_BLOCK = 128  # key block rows of the blockwise backward (JAX's _block)


def _check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """q ``[b, tq, h, d]``, k and v ``[b, tk, h, d]``, all float32 or all
    bfloat16, one cuda or cpu device; on cuda, stride 1 along d.  Returns
    the device type."""
    device = q.device
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash attention runs on cuda or cpu, got {device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype == torch.float16:
            raise ValueError(f"{name} is float16, which is not ported: flash attention takes "
                             "float32 or bfloat16")
        if t.dtype not in _DTYPES:
            raise ValueError(f"{name} must be float32 or bfloat16, got {t.dtype}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}: q, k and v share one dtype")
        if t.dim() != 4:
            raise ValueError(f"{name} must be [b, t, h, d], got {tuple(t.shape)}")
    b, tq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if min(tq, k.shape[1], d) < 1:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if device.type == "cuda":
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.stride(3) != 1:
                raise ValueError(f"{name} needs stride 1 along head_dim, got {t.stride()}")
    return device.type


def _check_state(m: torch.Tensor, l: torch.Tensor, a: torch.Tensor, q: torch.Tensor) -> None:
    b, tq, h, d = q.shape
    for name, t, shape in (("m", m, (b, h, tq)), ("l", l, (b, h, tq)),
                           ("a", a, (b, h, tq, d))):
        if t.device != q.device or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {q.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@functools.cache
def _launcher():
    fn = _build.library("flash_attention").flash_attention_launch
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = ([i32, i32, i32, ptr, ptr, ptr] + [i64] * 9 + [i32] * 5 + [ctypes.c_float]
                   + [ptr] * 8 + [ptr])
    fn.restype = i32
    return fn


@functools.cache
def _scale(d: int) -> float:
    """``softmax_scale(d)`` as a Python float (it is an f32 value)."""
    return float(softmax_scale(d))


def _launch(mode: str, q, k, v, out=None, lse=None, state_in=(None,) * 3,
            state_out=(None,) * 3) -> None:
    dev = q.device
    b, tq, h, d = q.shape
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    strides = [s for t in (q, k, v) for s in t.stride()[:3]]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _launcher()(
            dev.index, _MODES[mode], _DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), *strides,
            b, h, tq, k.shape[1], d, _scale(d), ptr(out), ptr(lse),
            *map(ptr, state_in), *map(ptr, state_out), stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash attention kernel ({mode}) launch failed: CUDA error {rc}")
    LAUNCHES[mode] += 1


def kernel_fold(acc: BlockAcc, q, k, v, round_p: bool = True) -> BlockAcc:
    """One unmasked fold of ``(k, v)`` into ``acc`` in the Pallas kernel's
    contract (``_fold_block``): scores in float32 from the inputs (products
    of bf16 values are exact in float32), ``l`` from the unrounded float32
    ``p``, and ``p`` rounded to the inputs' dtype only for P·V
    (``round_p``; without it, JAX's ``_partial_ref``).  For float32 inputs
    this is ``block_update`` op for op."""
    scale = softmax_scale(q.shape[-1], q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    m_new = torch.maximum(acc.m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(acc.m - m_new)
    l_new = acc.l * corr + p.sum(dim=-1)
    pv = p.to(v.dtype).float() if round_p else p
    o_new = acc.o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", pv, v.float())
    return BlockAcc(m=m_new, l=l_new, o=o_new)


def partial_twin(m, l, a, q, k, v) -> BlockAcc:
    """The JAX package's ``_partial_ref``: the fold with p unrounded, the
    recompute target of :func:`flash_block_update`'s backward."""
    return kernel_fold(BlockAcc(m, l, a), q, k, v, round_p=False)


@torch.no_grad()
def flash_fwd_reference(q, k, v) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of mode ``fwd``: the fold from the empty state,
    normalized into the inputs' dtype, and its logsumexp, ``(out [b, t, h,
    d], lse [b, h, t])``."""
    b, tq, h, d = q.shape
    acc = kernel_fold(init_block_acc(b, h, tq, d, q.device), q, k, v)
    return finalize_block_acc(acc, q.dtype), block_lse(acc)


@torch.no_grad()
def flash_partial_reference(m, l, a, q, k, v) -> BlockAcc:
    """Plain version of mode ``partial``: one :func:`kernel_fold`."""
    return kernel_fold(BlockAcc(m, l, a), q, k, v)


@torch.no_grad()
def flash_fwd(q, k, v) -> tuple[torch.Tensor, torch.Tensor]:
    """The whole-forward kernel: ``(out [b, t, h, d]`` in the inputs' dtype,
    ``lse [b, h, t]`` float32)."""
    if _check_qkv(q, k, v) == "cpu":
        return flash_fwd_reference(q, k, v)
    b, tq, h, d = q.shape
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q, k, v, out=out, lse=lse)
    return out, lse


@torch.no_grad()
def flash_partial(m, l, a, q, k, v, inplace: bool = False) -> BlockAcc:
    """One ring hop: fold ``(k, v)`` into the state ``(m, l, a)``.  With
    ``inplace`` the result is written over the given buffers, which are
    returned; otherwise into new ones."""
    kind = _check_qkv(q, k, v)
    _check_state(m, l, a, q)
    if kind == "cpu":
        new = flash_partial_reference(m, l, a, q, k, v)
        if not inplace:
            return new
        for dst, src in zip((m, l, a), new):
            dst.copy_(src)
        return BlockAcc(m, l, a)
    dst = (m, l, a) if inplace else tuple(torch.empty_like(t) for t in (m, l, a))
    _launch("flash_partial", q, k, v, state_in=(m, l, a), state_out=dst)
    return BlockAcc(*dst)


def _fold(x: torch.Tensor) -> torch.Tensor:
    """[b, t, h, d] -> [b*h, t, d]."""
    b, t, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, t, d)


def _unfold(x3: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """[b*h, t, d] -> [b, t, h, d]."""
    _, t, d = x3.shape
    return x3.reshape(b, h, t, d).transpose(1, 2)


def _block(t: int) -> int:
    """Key block rows of the backward: JAX's ``_block``."""
    return _MAX_BLOCK if t >= _MAX_BLOCK else -(-t // 8) * 8


def flash_bwd_blockwise(q, k, v, out, lse, g) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of attention from the saved ``(out, lse)``: a loop over
    key blocks rebuilds each probability tile exactly as ``exp(s - lse)``
    (no second online pass), accumulates dq and emits dk, dv per block.
    The JAX package's ``_bwd_blockwise``, in f32, in [b, t, h, d] layout."""
    b, t, h, d = q.shape
    scale = _scale(d)
    q3, k3, v3, g3 = (_fold(x).float() for x in (q, k, v, g))
    lse3 = lse.reshape(b * h, t)
    block = _block(t)
    # delta_i = sum_d dO_i * O_i, the rowwise term of the softmax jacobian.
    delta = (g3 * _fold(out).float()).sum(dim=-1)
    dq = torch.zeros_like(q3)
    dks, dvs = [], []
    for k0 in range(0, k3.shape[1], block):
        kf, vf = k3[:, k0:k0 + block], v3[:, k0:k0 + block]
        p = torch.exp(scale * torch.einsum("bqd,bkd->bqk", q3, kf) - lse3[..., None])
        dvs.append(torch.einsum("bqk,bqd->bkd", p, g3))
        ds = p * (torch.einsum("bqd,bkd->bqk", g3, vf) - delta[..., None])
        dq = dq + scale * torch.einsum("bqk,bkd->bqd", ds, kf)
        dks.append(scale * torch.einsum("bqk,bqd->bkd", ds, q3))
    dk, dv = torch.cat(dks, dim=1), torch.cat(dvs, dim=1)
    return tuple(_unfold(x, b, h).to(ref.dtype) for x, ref in ((dq, q), (dk, k), (dv, v)))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        return flash_bwd_blockwise(*ctx.saved_tensors, g)


def flash_attention(q, k, v, kv_mask=None) -> torch.Tensor:
    """Fused attention with ``full_attention``'s signature; q/k/v ``[b, t,
    h, d]``.  Maskless: a ``kv_mask`` raises rather than attending to
    padding (route masked inputs to ``full_attention``)."""
    if kv_mask is not None:
        raise ValueError(
            "flash_attention does not support kv_mask; use "
            "ops.attention.full_attention for masked inputs"
        )
    return _FlashAttention.apply(q, k, v)


class _FlashBlockUpdate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, m, l, a, q, k, v):
        ctx.save_for_backward(m, l, a, q, k, v)
        return tuple(flash_partial(m, l, a, q, k, v))

    @staticmethod
    def backward(ctx, gm, gl, ga):
        inputs = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            new = partial_twin(*inputs)
        return torch.autograd.grad(new, inputs, (gm, gl, ga), allow_unused=True)


def flash_block_update(m, l, a, q, k, v) -> BlockAcc:
    """One fused ring hop, differentiable: the backward recomputes through
    :func:`partial_twin` (no residual score tensors); q/k/v gradients come
    back in their dtype.  Without
    autograd (no grad mode, or no input that needs a grad) the state is
    updated in place and returned, as the TPU kernel aliases it."""
    tensors = (m, l, a, q, k, v)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return BlockAcc(*_FlashBlockUpdate.apply(*tensors))
    return flash_partial(*tensors, inplace=True)


def flash_ring_state(b: int, h: int, t: int, d: int, device=None) -> BlockAcc:
    """Empty state for a ring of :func:`flash_block_update` hops."""
    return init_block_acc(b, h, t, d, device)


def flash_ring_finalize(m, l, a, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Normalize the ring state into ``[b, t, h, d]`` (l == 0 rows give 0)."""
    return finalize_block_acc(BlockAcc(m, l, a), dtype)


def select_attention(use_flash: bool):
    """``use_flash`` -> the attention function every ``--flash`` mode shares."""
    return flash_attention if use_flash else full_attention
