"""The port's Adadelta (plain, and the two kernel rows on their plain CPU
versions) held against the JAX package on the same numpy inputs.

Tolerances:
- plain against plain: ``square_avg`` bit-equal; p, ``acc_delta`` and
  delta within rtol 1e-6, atol 1e-6 (both sides round every op
  separately; XLA may still fuse one step differently, a 1-ulp effect);
- kernel rows against the JAX kernels in interpret mode: rtol 1e-5,
  atol 1e-6, the tolerance the JAX package's own kernel tests use.
The kernel itself (``csrc/adadelta.cu``) runs only on the card, where
``chip_smoke.py`` holds it against these plain versions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu.models.net import init_params
from pytorch_mnist_ddp_tpu.ops import pallas_adadelta as jpa
from pytorch_mnist_ddp_tpu.ops.adadelta import AdadeltaState as JaxState
from pytorch_mnist_ddp_tpu.ops.adadelta import adadelta_delta as jax_delta
from pytorch_mnist_ddp_tpu.ops.adadelta import adadelta_init as jax_init
from pytorch_mnist_ddp_tpu.ops.adadelta import adadelta_update as jax_update
from pytorch_mnist_ddp_tpu_torch.ops import _build
from pytorch_mnist_ddp_tpu_torch.ops import adadelta_flat as af
from pytorch_mnist_ddp_tpu_torch.ops.adadelta import (
    AdadeltaState,
    adadelta_delta,
    adadelta_init,
    adadelta_update,
)
from pytorch_mnist_ddp_tpu_torch.utils.convert import torch_state_from_jax

RHO, EPS = 0.9, 1e-6
KERNEL_TOL = dict(rtol=1e-5, atol=1e-6)
EDGE_N = [1, 37, 1024, 32768, 33000, 300_000]
MODEL_N = 1_199_882


def _inputs(n: int, seed: int):
    """p, g signed; square_avg, acc_delta non-negative (as they stay)."""
    rng = np.random.RandomState(seed)
    p, g = (rng.randn(n).astype(np.float32) for _ in range(2))
    sq, ac = (np.abs(rng.randn(n)).astype(np.float32) for _ in range(2))
    return p, g, sq, ac


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("lr", [1.0, 0.7])
@pytest.mark.parametrize("n", [1, 37, 1024, 32768, 33000, 300_000, MODEL_N])
def test_plain_update_matches_jax(n, lr):
    p, g, sq, ac = _inputs(n, n)
    want_p, want = jax_update(jnp.asarray(p), jnp.asarray(g),
                              JaxState(jnp.asarray(sq), jnp.asarray(ac)), lr)
    want_delta, _, _ = jax_delta(jnp.asarray(g), jnp.asarray(sq), jnp.asarray(ac), RHO, EPS)
    tp, tg, tsq, tac = _t(p, g, sq, ac)
    delta, _, _ = adadelta_delta(tg, tsq, tac, RHO, EPS)
    params, state = adadelta_update({"w": tp}, {"w": tg},
                                    AdadeltaState({"w": tsq}, {"w": tac}), lr)
    assert params["w"] is tp and state.square_avg["w"] is tsq  # in place
    assert np.array_equal(_np(tsq), _np(want.square_avg))
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(tp), _np(want_p), **tol)
    np.testing.assert_allclose(_np(tac), _np(want.acc_delta), **tol)
    np.testing.assert_allclose(_np(delta), _np(want_delta), **tol)


@pytest.mark.parametrize("n", EDGE_N)
def test_fused_row_matches_jax_kernel(n):
    p, g, sq, ac = _inputs(n, n + 1)
    want = jpa.fused_adadelta_flat(*map(jnp.asarray, (p, g, sq, ac)), 0.7, interpret=True)
    got = af.fused_adadelta_flat(*_t(p, g, sq, ac), 0.7)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(_np(a), _np(b), **KERNEL_TOL)


def _padded(v: np.ndarray) -> jax.Array:
    rows, _ = jpa._pad_rows(v.shape[0])
    return jnp.pad(jnp.asarray(v), (0, rows * 128 - v.shape[0])).reshape(rows, 128)


@pytest.mark.parametrize("n", EDGE_N)
def test_delta_row_matches_jax_kernel(n):
    p, g, sq, ac = _inputs(n, n + 2)
    state = jpa.FlatAdadeltaState(_padded(sq), _padded(ac))
    want_p, want = jpa.adadelta_update_flat(
        {"w": jnp.asarray(p)}, {"w": jnp.asarray(g)}, state, 0.7, interpret=True)
    tp, tg, tsq, tac = _t(p, g, sq, ac)
    delta, new_sq, new_ac = af.adadelta_delta_flat(tg, tsq, tac)
    assert delta is tg and new_sq is tsq and new_ac is tac  # delta over g's buffer
    new_p = tp - delta.mul(0.7)
    np.testing.assert_allclose(_np(new_p), _np(want_p["w"]), **KERNEL_TOL)
    for got, padded in ((new_sq, want.square_avg), (new_ac, want.acc_delta)):
        np.testing.assert_allclose(_np(got), _np(padded).reshape(-1)[:n], **KERNEL_TOL)


@pytest.fixture(scope="module")
def model_tree():
    params = jax.device_get(init_params(jax.random.PRNGKey(0)))
    grads = jax.tree.map(
        lambda p: (np.random.RandomState(1).randn(*p.shape) * 0.01).astype(np.float32),
        params,
    )
    return params, grads


def _assert_tree_close(got: dict, want_tree, **tol):
    want = torch_state_from_jax(jax.device_get(want_tree))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), err_msg=k, **tol)


def test_three_flat_steps_on_model_params_match_jax_kernel(model_tree):
    params, grads = model_tree
    jp, jstate = params, jpa.adadelta_init_flat(params)
    tp, tg = torch_state_from_jax(params), torch_state_from_jax(grads)
    tstate = af.adadelta_init_flat(tp)
    assert af.is_flat_state(tstate) and tstate.square_avg.numel() == MODEL_N
    for _ in range(3):
        jp, jstate = jpa.adadelta_update_flat(jp, grads, jstate, 0.7, interpret=True)
        af.adadelta_update_flat(tp, tg, tstate, 0.7)
    _assert_tree_close(tp, jp, **KERNEL_TOL)


def test_three_fused_steps_on_model_params_match_jax_kernel(model_tree):
    params, grads = model_tree
    jp, jstate = params, jax_init(params)
    tp, tg = torch_state_from_jax(params), torch_state_from_jax(grads)
    tstate = adadelta_init(tp)
    for _ in range(3):
        jp, jstate = jpa.adadelta_update_pallas(jp, grads, jstate, 0.7, interpret=True)
        af.adadelta_update_pallas(tp, tg, tstate, 0.7)
    _assert_tree_close(tp, jp, **KERNEL_TOL)
    _assert_tree_close(tstate.square_avg, jstate.square_avg, **KERNEL_TOL)
    _assert_tree_close(tstate.acc_delta, jstate.acc_delta, **KERNEL_TOL)


@pytest.mark.parametrize("row", ["fused", "delta"])
def test_zero_state_first_step(row):
    """The sqrt(0 + eps) corner: torch-style zero accumulators."""
    g = np.linspace(-1, 1, 500, dtype=np.float32)
    z = np.zeros(500, np.float32)
    want_p, _ = jax_update(jnp.zeros(500), jnp.asarray(g), JaxState(jnp.asarray(z), jnp.asarray(z)), 1.0)
    want_k, _, _ = jpa.fused_adadelta_flat(jnp.zeros(500), jnp.asarray(g), jnp.asarray(z),
                                           jnp.asarray(z), 1.0, interpret=True)
    tp, tg, tsq, tac = _t(z, g, z, z)
    if row == "fused":
        af.fused_adadelta_flat(tp, tg, tsq, tac, 1.0)
    else:
        delta, _, _ = af.adadelta_delta_flat(tg, tsq, tac)
        tp = tp - delta.mul(1.0)
    assert np.isfinite(_np(tp)).all()
    np.testing.assert_allclose(_np(tp), _np(want_p), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_np(tp), _np(want_k), rtol=1e-5, atol=1e-7)


def test_lr_change_between_calls_gives_fresh_results():
    p, g, sq, ac = _inputs(2048, 7)
    for lr in (1.0, 0.7, 1.0):
        got_p, _, _ = af.fused_adadelta_flat(*_t(p, g, sq, ac), lr)
        want_p, _ = jax_update(jnp.asarray(p), jnp.asarray(g),
                               JaxState(jnp.asarray(sq), jnp.asarray(ac)), lr)
        np.testing.assert_allclose(_np(got_p), _np(want_p), **KERNEL_TOL)


def _route(module, names, monkeypatch) -> list[str]:
    taken: list[str] = []
    for name in names:
        real = getattr(module, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            taken.append(_name)
            return _real(*args, **kwargs)

        monkeypatch.setattr(module, name, spy)
    return taken


@pytest.mark.parametrize("case", ["flat", "per_param_pallas", "per_param_plain"])
def test_best_dispatches_as_jax(case, monkeypatch):
    """Flat state -> the delta kernel; per-parameter state with use_pallas
    -> the fused kernel; otherwise plain.  JAX reaches its kernels on the
    CPU only through its interpret hook, set here."""
    monkeypatch.setenv("TPU_MNIST_PALLAS_INTERPRET", "1")
    names = ["adadelta_update_flat", "adadelta_update_pallas", "adadelta_update"]
    jax_taken = _route(jpa, names, monkeypatch)
    port_taken = _route(af, names, monkeypatch)
    p = np.random.RandomState(5).randn(64).astype(np.float32)
    use_pallas = case != "per_param_plain"
    jparams, tparams = {"w": jnp.asarray(p)}, {"w": torch.tensor(p)}
    if case == "flat":
        jstate, tstate = jpa.adadelta_init_flat(jparams), af.adadelta_init_flat(tparams)
    else:
        jstate, tstate = jax_init(jparams), adadelta_init(tparams)
    jpa.adadelta_update_best(jparams, {"w": jnp.asarray(p)}, jstate, 1.0, use_pallas=use_pallas)
    af.adadelta_update_best(tparams, {"w": torch.tensor(p)}, tstate, 1.0, use_pallas=use_pallas)
    assert port_taken == jax_taken and len(port_taken) == 1


def _four(n=8):
    return [torch.rand(n) for _ in range(4)]


@pytest.mark.parametrize(
    "bad",
    ["device", "dtype", "contiguity", "length", "rank"],
)
def test_wrappers_refuse_bad_input(bad):
    p, g, sq, ac = _four()
    if bad == "device":
        g = g.to("meta")
        p, sq, ac = (t.to("meta") for t in (p, sq, ac))
    elif bad == "dtype":
        sq = sq.double()
    elif bad == "contiguity":
        g = torch.rand(16)[::2]
    elif bad == "length":
        ac = torch.rand(9)
    else:
        g = g.reshape(2, 4)
    with pytest.raises(ValueError):
        af.fused_adadelta_flat(p, g, sq, ac, 1.0)
    with pytest.raises(ValueError):
        af.adadelta_delta_flat(g, sq, ac)


def test_cpu_path_never_touches_the_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path must not build or load a kernel")

    for name in ("library", "nvcc_path"):
        monkeypatch.setattr(_build, name, refuse)
    before = dict(af.LAUNCHES)
    p, g, sq, ac = _four(100)
    af.fused_adadelta_flat(p, g, sq, ac, 1.0)
    af.adadelta_delta_flat(g, sq, ac)
    tparams = {"a": torch.rand(3, 4), "b": torch.rand(5)}
    af.adadelta_update_flat(tparams, {k: torch.rand_like(v) for k, v in tparams.items()},
                            af.adadelta_init_flat(tparams), 1.0)
    assert af.LAUNCHES == before  # the plain path is not a launch
