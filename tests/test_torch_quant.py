"""The port's int8 variant held against the JAX reference, CPU on both sides.

- Quantized codes and scales: bit-equal after the layout map.
- The plain int8 head against JAX ``_int8_dense`` -> relu -> ``_int8_dense``
  on the same features: bit-equal (same integer arithmetic, same f32
  epilogue order).
- The plain head against the JAX Pallas kernel in interpret mode: 1e-6
  (the kernel's f32 tail may fuse a mul+add; ~3e-8 observed).
- Full ``int8_forward_fused`` against JAX's: 1e-5 with identical argmax on
  small batches.  On a 64-row batch the two frameworks' f32 convolutions
  (which differ in the last ulp on ~60% of features) flip a few int8 codes
  of fc1's input.  On the CPU the largest difference measured there is
  3.4e-4, on one row of the 64 (the other rows agree within 1e-5), so
  that case is held to 5e-4 with identical argmax; the reason is the
  conv, not the head (the head's own equality is pinned above).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu.models import quant as jq
from pytorch_mnist_ddp_tpu.models.net import INPUT_SHAPE, init_params
from pytorch_mnist_ddp_tpu.ops.pallas_infer import fused_int8_head as jax_fused_head
from pytorch_mnist_ddp_tpu.utils.rng import root_key, split_streams
from pytorch_mnist_ddp_tpu_torch.models import quant as tq
from pytorch_mnist_ddp_tpu_torch.ops.int8_head import (
    _int8_dense_reference,
    fused_int8_head,
    int8_head_reference,
)
from pytorch_mnist_ddp_tpu_torch.utils.convert import (
    nchw_to_nhwc_feature_perm,
    torch_state_from_jax,
)

PERM = nchw_to_nhwc_feature_perm()


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(init_params(split_streams(root_key(1))["init"]))


@pytest.fixture(scope="module")
def jax_q(jax_params):
    return jq.quantize_params(jax_params)


@pytest.fixture(scope="module")
def port_q(jax_params):
    return tq.quantize_params(torch_state_from_jax(jax_params))


def _to_torch_layout(layer: str, kernel_q: np.ndarray) -> np.ndarray:
    if kernel_q.ndim == 4:
        return kernel_q.transpose(3, 2, 0, 1)
    out = kernel_q.T
    return out[:, PERM] if layer == "fc1" else out


def _features(n: int, seed: int) -> np.ndarray:
    """Post-relu/maxpool-like features (non-negative) in JAX (NHWC) order."""
    return np.abs(np.random.RandomState(seed).randn(n, 9216)).astype(np.float32)


def _jax_head(jax_q, x: np.ndarray) -> np.ndarray:
    h = jax.nn.relu(jq._int8_dense(x, jax_q["fc1"]))
    return np.asarray(jq._int8_dense(h, jax_q["fc2"]))


def _port_head(port_q, x_jax_order: np.ndarray) -> np.ndarray:
    x = torch.from_numpy(np.ascontiguousarray(x_jax_order[:, PERM]))
    return int8_head_reference(port_q["fc1"], port_q["fc2"], x).numpy()


@pytest.mark.parametrize("layer", ["conv1", "conv2", "fc1", "fc2"])
def test_codes_and_scales_bit_equal(jax_q, port_q, layer):
    want_codes = _to_torch_layout(layer, np.asarray(jax_q[layer]["kernel_q"]))
    got = port_q[layer]
    assert got["weight_q"].dtype == torch.int8
    assert np.array_equal(got["weight_q"].numpy(), want_codes)
    assert got["scale"].numpy().tobytes() == np.asarray(jax_q[layer]["scale"]).tobytes()
    assert got["bias"].numpy().tobytes() == np.asarray(jax_q[layer]["bias"]).tobytes()


def test_zero_channel_gets_unit_scale():
    w = torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
    w[1] = 0.0
    q, scale = tq.quantize_tensor(w)
    assert float(scale[1]) == 1.0 and not q[1].any()
    assert int(q.abs().max()) == 127


@pytest.mark.parametrize("n", [1, 3, 8, 130])
def test_plain_head_bit_equal_to_jax_int8_dense(jax_q, port_q, n):
    x = _features(n, seed=n)
    got, want = _port_head(port_q, x), _jax_head(jax_q, x)
    assert got.shape == (n, 10)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("n", [1, 3, 8, 130])
def test_plain_head_matches_pallas_interpret(jax_q, port_q, n):
    x = _features(n, seed=100 + n)
    want = np.asarray(jax_fused_head(jax_q["fc1"], jax_q["fc2"], x, interpret=True))
    np.testing.assert_allclose(_port_head(port_q, x), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["zero_row", "ties", "negative_ties"])
def test_head_edge_cases_match_jax(jax_q, port_q, case):
    x = _features(4, seed=7)
    if case == "zero_row":
        x[1] = 0.0
    else:
        # a_max = 127 makes a_scale exactly 1.0, so x / a_scale lands on
        # exact .5 ties that must round half to even.
        sign = -1.0 if case == "negative_ties" else 1.0
        x[:, 0] = 127.0
        x[:, 1:] = sign * (np.arange(9215) % 100 + 0.5).astype(np.float32)
    got, want = _port_head(port_q, x), _jax_head(jax_q, x)
    assert got.tobytes() == want.tobytes()


def test_ties_round_half_to_even():
    """An identity layer (unit scales, zero bias) returns the codes times
    a_scale, and a_scale is exactly 1.0 when the row's max is 127."""
    layer = {
        "weight_q": torch.eye(8, dtype=torch.int8),
        "scale": torch.ones(8),
        "bias": torch.zeros(8),
    }
    x = torch.tensor([[127.0, 2.5, 3.5, -2.5, -3.5, 0.5, 1.5, -0.5]])
    got = _int8_dense_reference(x, layer)
    assert got.tolist() == [[127.0, 2.0, 4.0, -2.0, -4.0, 0.0, 2.0, -0.0]]


@pytest.mark.parametrize("n", [1, 3, 8])
def test_int8_forward_fused_matches_jax(jax_q, port_q, n):
    x = np.random.RandomState(200 + n).randn(n, *INPUT_SHAPE).astype(np.float32)
    want = np.asarray(jq.int8_forward_fused(jax_q, x))  # Pallas, interpret mode
    with torch.inference_mode():
        got = tq.int8_forward_fused(port_q, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert (got.argmax(1) == want.argmax(1)).all()


def test_int8_forward_larger_batch_within_conv_flip_bound(jax_q, port_q):
    x = np.random.RandomState(264).randn(64, *INPUT_SHAPE).astype(np.float32)
    want = np.asarray(jq.int8_forward(jax_q, x))
    with torch.inference_mode():
        got = tq.int8_forward(port_q, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)  # measured 3.4e-4
    assert (got.argmax(1) == want.argmax(1)).all()


@pytest.mark.parametrize("n", [1, 8])
def test_conv_stack_matches_jax(jax_q, port_q, n):
    x = np.random.RandomState(300 + n).randn(n, *INPUT_SHAPE).astype(np.float32)
    want = np.asarray(jq._conv_stack(jax_q, x))[:, PERM]
    with torch.inference_mode():
        got = tq.conv_stack(port_q, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_cpu_fused_head_is_the_plain_version(port_q):
    x = torch.from_numpy(_features(5, seed=9)[:, PERM].copy())
    got = fused_int8_head(port_q["fc1"], port_q["fc2"], x)
    assert torch.equal(got, int8_head_reference(port_q["fc1"], port_q["fc2"], x))
