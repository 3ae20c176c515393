"""The port's f32 CNN, weight conversion and checkpoint loading, held
against the JAX reference on the same inputs (CPU on both sides).

Inputs come from numpy seeds; JAX seed-1 weights are carried across with
``torch_state_from_jax``.  Tolerances: f32 logits 1e-5 (the two
frameworks' convolutions sum in different orders, ~5e-7 observed) with
identical argmax; loading paths are exact.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu.data.transforms import normalize as jax_normalize
from pytorch_mnist_ddp_tpu.models.net import Net as JaxNet
from pytorch_mnist_ddp_tpu.models.net import init_params, init_variables
from pytorch_mnist_ddp_tpu.parallel.ddp import make_train_state
from pytorch_mnist_ddp_tpu.utils.checkpoint import (
    model_state_dict,
    save_state_dict,
    save_train_state,
)
from pytorch_mnist_ddp_tpu.utils.rng import root_key, split_streams
from pytorch_mnist_ddp_tpu_torch.data.transforms import normalize
from pytorch_mnist_ddp_tpu_torch.models.net import INPUT_SHAPE, NUM_CLASSES, Net
from pytorch_mnist_ddp_tpu_torch.models.quant import quantize_params
from pytorch_mnist_ddp_tpu_torch.serving.buckets import segment_ids
from pytorch_mnist_ddp_tpu_torch.serving.engine import InferenceEngine
from pytorch_mnist_ddp_tpu_torch.serving.predict import (
    make_int8_predict_step,
    make_packed_int8_predict_step,
    make_packed_predict_step,
    make_predict_step,
)
from pytorch_mnist_ddp_tpu_torch.utils.checkpoint import load_inference_state
from pytorch_mnist_ddp_tpu_torch.utils.convert import (
    nchw_to_nhwc_feature_perm,
    torch_state_from_jax,
)

F32_TOL = 1e-5


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(init_params(split_streams(root_key(1))["init"]))


@pytest.fixture(scope="module")
def port_net(jax_params):
    net = Net()
    net.load_state_dict(torch_state_from_jax(jax_params))
    return net.eval()


def _forward(net, x: np.ndarray) -> np.ndarray:
    with torch.inference_mode():
        return net(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("n", [1, 8, 64])
def test_f32_logits_match_jax(jax_params, port_net, n):
    x = np.random.RandomState(n).randn(n, *INPUT_SHAPE).astype(np.float32)
    want = np.asarray(JaxNet().apply({"params": jax_params}, x))
    got = _forward(port_net, x)
    assert got.shape == (n, NUM_CLASSES) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)
    assert (got.argmax(1) == want.argmax(1)).all()


def test_normalize_is_the_reference_affine():
    raw = np.random.RandomState(0).randint(0, 256, (5, 28, 28)).astype(np.uint8)
    assert np.array_equal(normalize(raw), jax_normalize(raw))


def test_fc1_permutation_maps_nhwc_to_nchw_flatten():
    act = np.random.RandomState(1).randn(3, 12, 12, 64).astype(np.float32)
    nhwc_flat = act.reshape(3, -1)
    nchw_flat = act.transpose(0, 3, 1, 2).reshape(3, -1)
    assert np.array_equal(nchw_flat, nhwc_flat[:, nchw_to_nhwc_feature_perm()])


def test_converted_state_matches_net_layout(jax_params):
    state = torch_state_from_jax(jax_params)
    want = {k: tuple(v.shape) for k, v in Net().state_dict().items()}
    assert {k: tuple(v.shape) for k, v in state.items()} == want
    assert all(v.dtype == torch.float32 and v.is_contiguous() for v in state.values())


def test_net_init_uses_only_its_generator():
    torch.manual_seed(0)
    rng_before = torch.get_rng_state()
    a = Net(torch.Generator().manual_seed(5)).state_dict()
    assert torch.equal(torch.get_rng_state(), rng_before)
    b = Net(torch.Generator().manual_seed(5)).state_dict()
    c = Net(torch.Generator().manual_seed(6)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["fc1.weight"], c["fc1.weight"])
    for layer, fan_in in (("conv1", 9), ("conv2", 288), ("fc1", 9216), ("fc2", 128)):
        bound = 1.0 / np.sqrt(fan_in)
        for leaf in ("weight", "bias"):
            assert float(a[f"{layer}.{leaf}"].abs().max()) <= bound


def test_dropout_is_inert_in_eval(port_net):
    x = np.random.RandomState(2).randn(4, *INPUT_SHAPE).astype(np.float32)
    assert np.array_equal(_forward(port_net, x), _forward(port_net, x))


def _write(kind: str, jax_params, path) -> str:
    if kind == "state":
        save_train_state(make_train_state(jax_params), str(path))
    else:
        fmt, ddp = {"torch": ("torch", False), "torch_ddp": ("torch", True),
                    "npz": ("npz", False), "npz_ddp": ("npz", True)}[kind]
        save_state_dict(model_state_dict(jax_params, ddp_prefix=ddp), str(path), format=fmt)
    return str(path)


@pytest.mark.parametrize("kind", ["torch", "torch_ddp", "npz", "npz_ddp", "state"])
def test_checkpoints_written_by_jax_package_load(jax_params, port_net, tmp_path, kind):
    path = _write(kind, jax_params, tmp_path / f"ckpt_{kind}")
    state = load_inference_state(path)
    want = torch_state_from_jax(jax_params)
    assert sorted(state) == sorted(want)
    assert all(torch.equal(state[k], want[k]) for k in want)
    net = Net()
    net.load_state_dict(state)
    x = np.random.RandomState(3).randn(6, *INPUT_SHAPE).astype(np.float32)
    assert np.array_equal(_forward(net.eval(), x), _forward(port_net, x))


def test_jax_pt_loads_with_plain_torch_load(jax_params, port_net, tmp_path):
    path = _write("torch", jax_params, tmp_path / "mnist_cnn.pt")
    net = Net()
    net.load_state_dict(torch.load(path, weights_only=True))
    x = np.random.RandomState(4).randn(2, *INPUT_SHAPE).astype(np.float32)
    assert np.array_equal(_forward(net.eval(), x), _forward(port_net, x))


def test_bn_checkpoint_is_refused(tmp_path):
    variables = jax.device_get(init_variables(jax.random.PRNGKey(0), use_bn=True))
    path = str(tmp_path / "bn.npz")
    save_state_dict(
        model_state_dict(variables["params"], batch_stats=variables["batch_stats"]),
        path, format="npz",
    )
    # Served at f32 and bf16 since the BatchNorm forward was ported; the
    # int8 variant refuses it with the JAX engine's text.
    state = load_inference_state(path)
    assert "bn1.running_var" in state
    with pytest.raises(ValueError, match="int8 variant does not support BatchNorm"):
        InferenceEngine(state, device="cpu", buckets=(1,), dtypes=("int8",))


@pytest.mark.parametrize("variant", ["f32", "int8"])
def test_packed_predict_zeroes_padding_and_keeps_live_rows(port_net, variant):
    if variant == "f32":
        params, plain, packed = port_net, make_predict_step(), make_packed_predict_step()
    else:
        params = quantize_params(port_net.state_dict())
        plain, packed = make_int8_predict_step(), make_packed_int8_predict_step()
    x = torch.from_numpy(np.random.RandomState(5).randn(8, *INPUT_SHAPE).astype(np.float32))
    x[5:] = 0.0  # padding rows, as staging leaves them
    seg = torch.from_numpy(segment_ids([2, 3], 8))
    with torch.inference_mode():
        want = plain(params, x)
        got = packed(params, x, seg)
    assert torch.equal(got[5:], torch.zeros(3, NUM_CLASSES))
    assert torch.equal(got[:5], want[:5])
