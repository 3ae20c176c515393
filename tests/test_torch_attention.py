"""The port's attention (``ops/attention.py``, ``ops/flash_attention.py``)
held against the JAX package on the CPU, on the same numpy inputs.

The JAX Pallas kernels run in interpret mode, as the JAX package's own
tests run them; the port's wrappers run their plain PyTorch versions on
CPU tensors (the CUDA kernel is checked against them on the card by
``chip_smoke.py``).  Tolerances are ``tests/test_flash.py``'s gates:
forward values and logsumexp rtol 1e-5, atol 1e-6; gradients rtol 1e-4,
atol 1e-5.  At head_dim 8 the two packages' ``1/sqrt(d)`` may differ in the
last ulp (JAX's flash wrapper rounds a double, ``block_update`` divides in
float32), which the same gates cover.  The raw state's accumulator ``o``
is an unnormalized sum over up to t keys, so its absolute gate is 1e-6
times its largest magnitude (``_assert_state_close``).  The 3xTF32 split
the kernel's products use is modelled in numpy (``_fold_tf32``: operands
rounded to TF32, accumulation in numpy's f32, not the tensor cores') and
held to the forward gate: this fixes why the kernel splits, while the
kernel itself is checked only on the card, by ``chip_smoke.py``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu.ops import attention as jatt
from pytorch_mnist_ddp_tpu.ops import pallas_attention as pa
from pytorch_mnist_ddp_tpu_torch.ops import _build
from pytorch_mnist_ddp_tpu_torch.ops import attention as att
from pytorch_mnist_ddp_tpu_torch.ops import flash_attention as fa

SHAPES = [
    (2, 16, 4, 16),   # the ViT's own geometry (16 tokens)
    (1, 300, 2, 64),  # long, t not a multiple of any tile
    (2, 128, 2, 32),  # exactly one 128-row block
    (1, 257, 1, 8),   # several q and k blocks with a 1-row tail
]
IDS = ["x".join(map(str, s)) for s in SHAPES]
FWD_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _assert_state_close(got, want):
    """(m, l, o) states: m and l at the forward gate, o at rtol 1e-5 and an
    absolute 1e-6 of its own scale."""
    for name, a, w in zip("mlo", got, want):
        a, w = np.asarray(a), np.asarray(w)
        atol = 1e-6 * max(1.0, float(np.abs(w).max())) if name == "o" else 1e-6
        np.testing.assert_allclose(a, w, rtol=1e-5, atol=atol, err_msg=name)


def _qkv(shape, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(*shape).astype(np.float32) for _ in range(3))


def _t(*arrays, grad=False):
    return tuple(torch.tensor(a, requires_grad=grad) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _mask(b, t, seed):
    """Random keep-mask with batch row 0 fully masked (l == 0 rows)."""
    mask = np.random.RandomState(seed).rand(b, t) > 0.3
    mask[0] = False
    return mask


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_block_update_and_full_attention_match_jax(shape, masked):
    q, k, v = _qkv(shape, 1)
    b, t, h, d = shape
    mask = _mask(b, t, 2) if masked else None
    rng = np.random.RandomState(3)
    # A state that has already seen a block: finite m, positive l.
    m0 = rng.randn(b, h, t).astype(np.float32)
    l0 = (rng.rand(b, h, t) + 0.5).astype(np.float32)
    o0 = rng.randn(b, h, t, d).astype(np.float32)
    got = att.block_update(att.BlockAcc(*_t(m0, l0, o0)), *_t(q, k, v),
                           None if mask is None else torch.tensor(mask))
    want = jatt.block_update(jatt.BlockAcc(*_j(m0, l0, o0)), *_j(q, k, v),
                             None if mask is None else jnp.asarray(mask))
    _assert_state_close(got, want)
    out = att.full_attention(*_t(q, k, v), None if mask is None else torch.tensor(mask))
    ref = jatt.full_attention(*_j(q, k, v), None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD_TOL)
    if masked:  # every key of batch row 0 masked: 0, not NaN
        assert torch.equal(out[0], torch.zeros_like(out[0]))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_flash_forward_and_lse_match_jax_kernel(shape):
    """The port's flash_attention and its (out, lse) against the JAX
    Pallas kernel in interpret mode."""
    q, k, v = _qkv(shape, 4)
    b, t, h, d = shape
    out, lse = fa.flash_fwd(*_t(q, k, v))
    jout, jlse = pa._flash_fwd_res(*_j(q, k, v))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy().reshape(b * h, t), np.asarray(jlse), **FWD_TOL)
    got = fa.flash_attention(*_t(q, k, v))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(pa.flash_attention(*_j(q, k, v))),
                               **FWD_TOL)
    assert torch.equal(got, out)


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "dense"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_attention_gradients_match_jax(shape, flash):
    """Both port paths (the blockwise flash backward, autograd through the
    dense form) against jax.grad of the JAX flash_attention."""
    q, k, v = _qkv(shape, 5)
    cot = np.random.RandomState(9).randn(*shape).astype(np.float32)
    want = jax.grad(lambda q, k, v: (pa.flash_attention(q, k, v) * cot).sum(),
                    argnums=(0, 1, 2))(*_j(q, k, v))
    tq, tk, tv = _t(q, k, v, grad=True)
    fn = fa.flash_attention if flash else att.full_attention
    (fn(tq, tk, tv) * torch.tensor(cot)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **GRAD_TOL)


def _tf32(x: np.ndarray) -> np.ndarray:
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it (to nearest,
    ties away from zero, the low 13 bits cleared): the kernel's rounding."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _mm_tf32(a: np.ndarray, b: np.ndarray, passes: int) -> np.ndarray:
    """``a @ b`` on TF32 operands in f32: ``passes=3`` is 3xTF32 (x = hi +
    lo; the small terms lo.hi + hi.lo summed apart from hi.hi, as the
    kernel sums them), ``passes=1`` a single TF32 pass (hi.hi)."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def _fold_tf32(q, k, v, passes: int, tile: int = 64):
    """The kernel's fold modelled in numpy f32: key tiles of ``tile`` rows,
    both products on TF32 operands, each tile's P.V added to the rescaled
    accumulator.  Returns ``(out [b, t, h, d], lse [b*h, t])``."""
    b, t, h, d = q.shape
    q3, k3, v3 = (x.transpose(0, 2, 1, 3).reshape(b * h, -1, d) for x in (q, k, v))
    scale = np.float32(fa._scale(d))
    m = np.full((b * h, t), -1e30, np.float32)
    l = np.zeros((b * h, t), np.float32)
    acc = np.zeros((b * h, t, d), np.float32)
    for k0 in range(0, k3.shape[1], tile):
        s = _mm_tf32(q3, k3[:, k0:k0 + tile].transpose(0, 2, 1), passes) * scale
        m_new = np.maximum(m, s.max(axis=-1))
        p = np.exp(s - m_new[..., None])
        corr = np.exp(m - m_new)
        l = l * corr + p.sum(axis=-1)
        acc = acc * corr[..., None] + _mm_tf32(p, v3[:, k0:k0 + tile], passes)
        m = m_new
    out = (acc / l[..., None]).reshape(b, h, t, d).transpose(0, 2, 1, 3)
    return out, m + np.log(l)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    half = np.float32(2.0 ** -11)  # half a TF32 ulp at 1
    x = np.array([1 + half, -(1 + half), 1 + half - np.float32(2.0 ** -23), 3.0, 0.0],
                 np.float32)
    np.testing.assert_array_equal(
        _tf32(x), np.array([1 + 2 * half, -(1 + 2 * half), 1.0, 3.0, 0.0], np.float32))
    y = np.random.RandomState(17).randn(4096).astype(np.float32)
    hi = _tf32(y)
    assert not (hi.view(np.uint32) & 0x1FFF).any()
    lo = _tf32(y - hi)
    assert np.abs(y - hi).max() <= np.abs(y).max() * 2.0 ** -11
    np.testing.assert_allclose(hi.astype(np.float64) + lo, y, rtol=2.0 ** -21, atol=0)


TF32_SHAPES = SHAPES + [(1, 1024, 2, 64)]


@pytest.mark.parametrize("shape", TF32_SHAPES, ids=["x".join(map(str, s)) for s in TF32_SHAPES])
def test_3xtf32_fold_matches_jax_kernel(shape):
    """The fold with its products split into TF32 halves (a model of the
    split, not of the kernel) against the JAX Pallas kernel in interpret
    mode at the forward gate; and why the kernel splits: one TF32 pass
    lands at least 50x further off at t >= 1024."""
    q, k, v = _qkv(shape, 16)
    b, t, h, d = shape
    jout, jlse = (np.asarray(x) for x in pa._flash_fwd_res(*_j(q, k, v)))
    out, lse = _fold_tf32(q, k, v, passes=3)
    np.testing.assert_allclose(out, jout, **FWD_TOL)
    np.testing.assert_allclose(lse, jlse, **FWD_TOL)
    if t >= 1024:
        one, _ = _fold_tf32(q, k, v, passes=1)
        err3, err1 = np.abs(out - jout).max(), np.abs(one - jout).max()
        assert err1 >= 50 * err3, (err1, err3)


def _jax_state(m, l, a, t_pad, d_pad):
    """[b, h, t] / [b, h, t, d] state -> the Pallas kernel's padded
    lane-broadcast layout ``[b*h, t_pad, 128]`` / ``[b*h, t_pad, d_pad]``."""
    b, h, t, d = a.shape
    ml = [np.pad(np.broadcast_to(x.reshape(b * h, t, 1), (b * h, t, 128)),
                 ((0, 0), (0, t_pad - t), (0, 0))) for x in (m, l)]
    a3 = np.pad(a.reshape(b * h, t, d), ((0, 0), (0, t_pad - t), (0, d_pad - d)))
    return tuple(jnp.asarray(x.astype(np.float32)) for x in (*ml, a3))


def _from_jax_state(state, b, h, t, d):
    m, l, a = (np.asarray(x) for x in state)
    return (m[:, :t, 0].reshape(b, h, t), l[:, :t, 0].reshape(b, h, t),
            a[:, :t, :d].reshape(b, h, t, d))


def _random_state(b, h, t, d, seed):
    rng = np.random.RandomState(seed)
    return ((2 * rng.randn(b, h, t)).astype(np.float32),
            (rng.rand(b, h, t) * 3 + 0.1).astype(np.float32),
            rng.randn(b, h, t, d).astype(np.float32))


PARTIAL_SHAPES = [(2, 16, 4, 16), (1, 40, 2, 8), (1, 300, 2, 64)]


@pytest.mark.parametrize("start", ["empty", "random"])
@pytest.mark.parametrize("shape", PARTIAL_SHAPES, ids=["x".join(map(str, s)) for s in PARTIAL_SHAPES])
def test_partial_update_matches_jax_kernel(shape, start):
    """The plain partial update (the port's flash_partial on CPU) against
    the JAX partial kernel run in interpret mode, from the empty state and
    from a random finite state with l > 0."""
    q, k, v = _qkv(shape, 6)
    b, t, h, d = shape
    if start == "empty":
        state = tuple(x.numpy() for x in fa.flash_ring_state(b, h, t, d))
    else:
        state = _random_state(b, h, t, d, 7)
    tp, dp = pa.flash_pad_len(t), pa.flash_lane_pad(d)
    jq, jk, jv = (pa.flash_fold_pad(x, tp) for x in _j(q, k, v))
    scale = 1.0 / float(d) ** 0.5
    want = pa._flash_partial(*_jax_state(*state, tp, dp), jq, jk, jv, t, scale, interpret=True)
    got = fa.flash_partial(*_t(*state), *_t(q, k, v))
    _assert_state_close(got, _from_jax_state(want, b, h, t, d))


def test_partial_inplace_aliases_the_state():
    b, t, h, d = 2, 16, 4, 16
    q, k, v = _t(*_qkv((b, t, h, d), 8))
    state = _t(*_random_state(b, h, t, d, 9))
    fresh = fa.flash_partial(*state, q, k, v)
    got = fa.flash_partial(*state, q, k, v, inplace=True)
    assert all(g is s for g, s in zip(got, state))
    assert all(torch.equal(g, f) for g, f in zip(got, fresh))
    with torch.no_grad():  # no autograd: the ring's hop aliases too
        again = fa.flash_block_update(*state, q, k, v)
    assert all(g is s for g, s in zip(again, state))


@pytest.mark.parametrize("shape", [(2, 16, 4, 16), (1, 40, 2, 8)], ids=["2x16x4x16", "1x40x2x8"])
def test_flash_block_update_vjp_matches_jax(shape):
    """The recompute backward of flash_block_update against jax.vjp of the
    JAX package's.  Cotangents sit on lane 0 of JAX's lane-broadcast m and
    l (the port's m and l are that lane) and on the real rows and columns."""
    q, k, v = _qkv(shape, 10)
    b, t, h, d = shape
    state = _random_state(b, h, t, d, 11)
    rng = np.random.RandomState(12)
    cots = [rng.randn(b, h, t).astype(np.float32), rng.randn(b, h, t).astype(np.float32),
            rng.randn(b, h, t, d).astype(np.float32)]
    tp, dp = pa.flash_pad_len(t), pa.flash_lane_pad(d)
    jstate = _jax_state(*state, tp, dp)
    jq, jk, jv = (pa.flash_fold_pad(x, tp) for x in _j(q, k, v))
    scale = 1.0 / float(d) ** 0.5
    _, vjp = jax.vjp(lambda m, l, a, q3, k3, v3: pa.flash_block_update(m, l, a, q3, k3, v3, t, scale),
                     *jstate, jq, jk, jv)
    jc = []
    for c in cots[:2]:
        lane0 = np.zeros((b * h, tp, 128), np.float32)
        lane0[:, :t, 0] = c.reshape(b * h, t)
        jc.append(jnp.asarray(lane0))
    jc.append(jnp.asarray(np.pad(cots[2].reshape(b * h, t, d), ((0, 0), (0, tp - t), (0, dp - d)))))
    jm, jl, ja, jgq, jgk, jgv = (np.asarray(g) for g in vjp(tuple(jc)))

    inputs = _t(*state, q, k, v, grad=True)
    out = fa.flash_block_update(*inputs)
    torch.autograd.backward(out, _t(*cots))
    want = [jm[:, :t, 0].reshape(b, h, t), jl[:, :t, 0].reshape(b, h, t),
            ja[:, :t, :d].reshape(b, h, t, d)]
    for g3 in (jgq, jgk, jgv):
        want.append(g3[:, :t, :d].reshape(b, h, t, d).transpose(0, 2, 1, 3))
    for x, w in zip(inputs, want):
        np.testing.assert_allclose(x.grad.numpy(), w, **GRAD_TOL)


def test_ring_finalize_gives_zero_for_empty_rows():
    b, t, h, d = 2, 16, 4, 16
    m, l, a = _random_state(b, h, t, d, 13)
    l[1, 2, :5] = 0.0  # rows that saw only masked keys
    a[1, 2, :5] = 0.0
    got = fa.flash_ring_finalize(*_t(m, l, a)).numpy()
    tp, dp = pa.flash_pad_len(t), pa.flash_lane_pad(d)
    want = pa.flash_ring_finalize(*_jax_state(m, l, a, tp, dp), b, h, t, d, jnp.float32)
    np.testing.assert_allclose(got, np.asarray(want), **FWD_TOL)
    assert np.isfinite(got).all() and not got[1, :5, 2].any()


def test_kv_mask_rejected():
    q, k, v = _t(*_qkv(SHAPES[0]))
    mask = torch.ones(q.shape[:2], dtype=torch.bool)
    with pytest.raises(ValueError, match="kv_mask"):
        fa.flash_attention(q, k, v, mask)
    assert fa.select_attention(True) is fa.flash_attention
    assert fa.select_attention(False) is att.full_attention


def test_cpu_wrappers_never_touch_the_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path must not build or load a kernel")

    for name in ("library", "nvcc_path"):
        monkeypatch.setattr(_build, name, refuse)
    before = dict(fa.LAUNCHES)
    q, k, v = _t(*_qkv(SHAPES[0], 14), grad=True)
    b, t, h, d = q.shape
    fa.flash_attention(q, k, v).sum().backward()
    fa.flash_block_update(*fa.flash_ring_state(b, h, t, d), q, k, v).o.sum().backward()
    assert fa.LAUNCHES == before  # the plain path is not a launch


def test_wrappers_check_their_inputs():
    q, k, v = _t(*_qkv(SHAPES[0], 15))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_fwd(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        fa.flash_fwd(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="share one dtype"):
        fa.flash_fwd(q, k.bfloat16(), v.bfloat16())
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_fwd(q, k[:, :, :2], v[:, :, :2])
    b, t, h, d = q.shape
    m, l, a = fa.flash_ring_state(b, h, t + 1, d)
    with pytest.raises(ValueError, match="must be"):
        fa.flash_partial(m, l, a, q, k, v)


# ------------------------------------- bf16, f16 and wide heads

# The 2-byte dtypes, each case run in both: (torch dtype, jax dtype).
HALF = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float16": (torch.float16, jnp.float16)}
# Outputs within one ulp of their type: 2^-7 relative for bf16 (2^-8
# absolute), 2^-10 for f16 (2^-11); the f32 quantities (lse, m, l) at the
# forward gate.
HALF_TOL = {"bfloat16": dict(rtol=2.0 ** -7, atol=2.0 ** -8),
            "float16": dict(rtol=2.0 ** -10, atol=2.0 ** -11)}
JAX_BF16_GATE = dict(rtol=2e-2, atol=2e-2)  # tests/test_flash.py, against the f32 oracle
# bf16 gradients: one bf16 ulp relative, and 1e-3 absolute for the
# gradient elements that sum a few terms of either sign (measured: at most
# 0.66 of this gate, max |diff| 2^-8, at t = 300 where the two forwards'
# bf16 outputs differ; 0.002 of it at t = 16).  f16 gradients: one f16 ulp
# relative and the same 1e-3 absolute (measured on the CPU: at most 0.10 of
# the bf16 gate, max |diff| 2^-11).
BF16_GRAD_TOL = dict(rtol=2.0 ** -7, atol=1e-3)
HALF_GRAD_TOL = {"bfloat16": BF16_GRAD_TOL, "float16": dict(rtol=2.0 ** -10, atol=1e-3)}
WIDE_SHAPES = [(2, 16, 4, 160), (1, 40, 2, 256)]  # head_dim past 128: the kernel's slab loop
BF16_SHAPES = SHAPES + WIDE_SHAPES
BF16_IDS = ["x".join(map(str, s)) for s in BF16_SHAPES]
half_dtypes = pytest.mark.parametrize("dt", list(HALF))


def _half(dt, *arrays):
    """f32 arrays rounded to ``dt``'s values (to nearest even), kept as f32."""
    return tuple(np.asarray(jnp.asarray(a).astype(HALF[dt][1]).astype(jnp.float32))
                 for a in arrays)


def _th(dt, *arrays, grad=False):
    return tuple(torch.tensor(a).to(HALF[dt][0]).requires_grad_(grad) for a in arrays)


def _jh(dt, *arrays):
    return tuple(jnp.asarray(a).astype(HALF[dt][1]) for a in arrays)


@half_dtypes
@pytest.mark.parametrize("shape", BF16_SHAPES, ids=BF16_IDS)
def test_half_flash_forward_and_lse_match_jax_kernel(shape, dt):
    """bf16 or f16 q/k/v: the port's (out, lse) against the Pallas kernel
    in interpret mode, and the output within JAX's bf16 gate of the f32
    oracle on the unrounded inputs."""
    q32, k32, v32 = _qkv(shape, 4)
    q, k, v = _half(dt, q32, k32, v32)
    b, t, h, d = shape
    out, lse = fa.flash_fwd(*_th(dt, q, k, v))
    assert out.dtype == HALF[dt][0] and lse.dtype == torch.float32
    jout, jlse = pa._flash_fwd_res(*_jh(dt, q, k, v))
    assert jout.dtype == HALF[dt][1] and jlse.dtype == jnp.float32
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jout, np.float32), **HALF_TOL[dt])
    np.testing.assert_allclose(lse.numpy().reshape(b * h, t), np.asarray(jlse), **FWD_TOL)
    oracle = np.asarray(jatt.full_attention(*_j(q32, k32, v32)))
    np.testing.assert_allclose(out.float().numpy(), oracle, **JAX_BF16_GATE)
    assert torch.equal(fa.flash_attention(*_th(dt, q, k, v)), out)


@pytest.mark.parametrize("shape", WIDE_SHAPES, ids=["x".join(map(str, s)) for s in WIDE_SHAPES])
def test_wide_head_flash_matches_jax_kernel(shape):
    """f32 at head_dim past 128 (the Pallas kernel lane-pads any d): the
    port's forward, partial update and gradients against JAX's."""
    q, k, v = _qkv(shape, 17)
    b, t, h, d = shape
    out, lse = fa.flash_fwd(*_t(q, k, v))
    jout, jlse = pa._flash_fwd_res(*_j(q, k, v))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **FWD_TOL)
    np.testing.assert_allclose(lse.numpy().reshape(b * h, t), np.asarray(jlse), **FWD_TOL)
    state = _random_state(b, h, t, d, 18)
    tp, dp = pa.flash_pad_len(t), pa.flash_lane_pad(d)
    jq, jk, jv = (pa.flash_fold_pad(x, tp) for x in _j(q, k, v))
    want = pa._flash_partial(*_jax_state(*state, tp, dp), jq, jk, jv, t, 1.0 / float(d) ** 0.5,
                             interpret=True)
    _assert_state_close(fa.flash_partial(*_t(*state), *_t(q, k, v)),
                        _from_jax_state(want, b, h, t, d))
    cot = np.random.RandomState(19).randn(*shape).astype(np.float32)
    jgrads = jax.grad(lambda q, k, v: (pa.flash_attention(q, k, v) * cot).sum(),
                      argnums=(0, 1, 2))(*_j(q, k, v))
    tq, tk, tv = _t(q, k, v, grad=True)
    (fa.flash_attention(tq, tk, tv) * torch.tensor(cot)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **GRAD_TOL)


BF16_PARTIAL_SHAPES = PARTIAL_SHAPES + [(1, 40, 2, 256)]


@half_dtypes
@pytest.mark.parametrize("start", ["empty", "random"])
@pytest.mark.parametrize("shape", BF16_PARTIAL_SHAPES,
                         ids=["x".join(map(str, s)) for s in BF16_PARTIAL_SHAPES])
def test_half_partial_update_matches_jax_kernel(shape, start, dt):
    """bf16 or f16 q/k/v folded into the f32 state, in place, against the
    JAX partial kernel in interpret mode: m and l at the forward gate, a / l
    (the output the ring finalizes to) at the gate of the inputs' dtype."""
    q, k, v = _half(dt, *_qkv(shape, 6))
    b, t, h, d = shape
    if start == "empty":
        state = tuple(x.numpy() for x in fa.flash_ring_state(b, h, t, d))
    else:
        state = _random_state(b, h, t, d, 7)
    tp, dp = pa.flash_pad_len(t), pa.flash_lane_pad(d)
    jq, jk, jv = (pa.flash_fold_pad(x, tp) for x in _jh(dt, q, k, v))
    want = pa._flash_partial(*_jax_state(*state, tp, dp), jq, jk, jv, t, 1.0 / float(d) ** 0.5,
                             interpret=True)
    assert all(x.dtype == jnp.float32 for x in want)
    wm, wl, wa = _from_jax_state(want, b, h, t, d)
    tstate = _t(*state)
    got = fa.flash_partial(*tstate, *_th(dt, q, k, v), inplace=True)
    assert all(g is s for g, s in zip(got, tstate))
    assert all(x.dtype == torch.float32 for x in got)
    np.testing.assert_allclose(got.m.numpy(), wm, **FWD_TOL)
    np.testing.assert_allclose(got.l.numpy(), wl, **FWD_TOL)
    np.testing.assert_allclose((got.o / got.l[..., None]).numpy(), wa / wl[..., None],
                               **HALF_TOL[dt])


@half_dtypes
@pytest.mark.parametrize("shape", [(2, 16, 4, 16), (1, 300, 2, 64), (2, 16, 4, 160)],
                         ids=["2x16x4x16", "1x300x2x64", "2x16x4x160"])
def test_half_attention_gradients_match_jax(shape, dt):
    """bf16 or f16 gradients of flash_attention against jax.grad of JAX's
    (both backwards run in f32 from the upcast inputs and the 2-byte
    output, and return the inputs' dtype)."""
    q, k, v = _half(dt, *_qkv(shape, 5))
    cot = _half(dt, np.random.RandomState(9).randn(*shape).astype(np.float32))[0]
    want = jax.grad(lambda q, k, v: (pa.flash_attention(q, k, v).astype(jnp.float32) * cot).sum(),
                    argnums=(0, 1, 2))(*_jh(dt, q, k, v))
    tq, tk, tv = _th(dt, q, k, v, grad=True)
    (fa.flash_attention(tq, tk, tv).float() * torch.tensor(cot)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert got.dtype == HALF[dt][0] and w.dtype == HALF[dt][1]
        np.testing.assert_allclose(got.float().numpy(), np.asarray(w, np.float32),
                                   **HALF_GRAD_TOL[dt])


@half_dtypes
@pytest.mark.parametrize("shape", [(2, 16, 4, 16), (1, 40, 2, 8)], ids=["2x16x4x16", "1x40x2x8"])
def test_half_flash_block_update_vjp_matches_jax(shape, dt):
    """flash_block_update's recompute backward on bf16 or f16 q/k/v
    (through the port of JAX's _partial_ref: f32 from the upcast inputs, p
    unrounded) against jax.vjp of the JAX package's; q/k/v cotangents come
    back in the inputs' dtype."""
    q, k, v = _half(dt, *_qkv(shape, 10))
    b, t, h, d = shape
    state = _random_state(b, h, t, d, 11)
    rng = np.random.RandomState(12)
    cots = [rng.randn(b, h, t).astype(np.float32), rng.randn(b, h, t).astype(np.float32),
            rng.randn(b, h, t, d).astype(np.float32)]
    tp, dp = pa.flash_pad_len(t), pa.flash_lane_pad(d)
    jq, jk, jv = (pa.flash_fold_pad(x, tp) for x in _jh(dt, q, k, v))
    scale = 1.0 / float(d) ** 0.5
    _, vjp = jax.vjp(lambda m, l, a, q3, k3, v3: pa.flash_block_update(m, l, a, q3, k3, v3, t, scale),
                     *_jax_state(*state, tp, dp), jq, jk, jv)
    jc = []
    for c in cots[:2]:
        lane0 = np.zeros((b * h, tp, 128), np.float32)
        lane0[:, :t, 0] = c.reshape(b * h, t)
        jc.append(jnp.asarray(lane0))
    jc.append(jnp.asarray(np.pad(cots[2].reshape(b * h, t, d), ((0, 0), (0, tp - t), (0, dp - d)))))
    jm, jl, ja, jgq, jgk, jgv = vjp(tuple(jc))
    assert jgq.dtype == HALF[dt][1]
    inputs = _t(*state, grad=True) + _th(dt, q, k, v, grad=True)
    torch.autograd.backward(fa.flash_block_update(*inputs), _t(*cots))
    want = [np.asarray(jm)[:, :t, 0].reshape(b, h, t), np.asarray(jl)[:, :t, 0].reshape(b, h, t),
            np.asarray(ja)[:, :t, :d].reshape(b, h, t, d)]
    for x, w in zip(inputs[:3], want):
        assert x.grad.dtype == torch.float32
        np.testing.assert_allclose(x.grad.numpy(), w, **GRAD_TOL)
    for x, g3 in zip(inputs[3:], (jgq, jgk, jgv)):
        assert x.grad.dtype == HALF[dt][0]
        w = np.asarray(g3, np.float32)[:, :t, :d].reshape(b, h, t, d).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(x.grad.float().numpy(), w, **HALF_GRAD_TOL[dt])


@half_dtypes
def test_half_kernel_contract_rounds_p_and_sums_l_unrounded(dt):
    """In bf16 and f16 the kernel's plain version is _fold_block's
    contract, held to a numpy model of it: scores in f32 from the 2-byte
    inputs, l summed from the unrounded p, p rounded to the inputs' dtype
    only for P.V, the output rounded to it.  It is not the plain
    attention's (block_update rounds the scores to the inputs' dtype and
    never p): the two must not be merged by mistake."""
    shape = (2, 16, 4, 16)
    q, k, v = _half(dt, *_qkv(shape, 21))
    b, t, h, d = shape
    scale = np.float32(fa._scale(d))
    s = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), k.astype(np.float64))
    s = s.astype(np.float32) * scale  # products of 2-byte values are exact in f32
    m = s.max(axis=-1)
    p = np.exp(s - m[..., None])
    l_unrounded = p.sum(axis=-1)
    p16 = _half(dt, p)[0]
    out_model = np.einsum("bhqk,bkhd->bhqd", p16, v) / l_unrounded[..., None]
    out_model = _half(dt, out_model.transpose(0, 2, 1, 3).astype(np.float32))[0]

    state = fa.flash_partial(*fa.flash_ring_state(b, h, t, d), *_th(dt, q, k, v))
    np.testing.assert_allclose(state.l.numpy(), l_unrounded, **FWD_TOL)
    l_rounded = p16.sum(axis=-1)
    assert (np.abs(state.l.numpy() - l_rounded) > 1e-5 * l_rounded).any()  # l is not sum(dt(p))
    out, lse = fa.flash_fwd(*_th(dt, q, k, v))
    np.testing.assert_allclose(out.float().numpy(), out_model, **HALF_TOL[dt])
    np.testing.assert_allclose(lse.numpy(), m + np.log(l_unrounded), **FWD_TOL)
    # Without rounding p the model lands elsewhere, and so does block_update.
    out_unrounded = np.einsum("bhqk,bkhd->bhqd", p, v) / l_unrounded[..., None]
    out_unrounded = _half(dt, out_unrounded.transpose(0, 2, 1, 3).astype(np.float32))[0]
    assert (out_unrounded != out_model).any()
    dense = att.full_attention(*_th(dt, q, k, v)).float().numpy()
    assert (dense != out.float().numpy()).any()
