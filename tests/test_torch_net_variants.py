"""``--conv-impl`` and ``--bf16`` of the port's CNN held against the JAX
package's ``Net(conv_impl=..., compute_dtype=...)`` on the CPU, on the
same numpy inputs and weights.

Tolerances, each beside its reading on the CPU:
- f32, every ``conv_impl``: log-probs within 1e-5 with the same argmax
  (read 4.8e-7); 8 steps at lr 1.0, dropout off, within
  ``test_torch_train.py``'s trajectory gates, losses rtol 2e-4 / atol
  2e-5 and parameters atol 5e-3 (read 1.2e-6 relative and 1.5e-4 for the
  im2col variants: the matmul sums the patch in another order).
- bf16: log-probs within 8e-3 (2^-7, one bf16 ulp of a logit between 1
  and 2) with the same argmax, on weights scaled so that the logits are
  confident (read 3.7e-3 to 7.7e-3 over seeds 0-3; JAX's own bf16 and f32
  forwards differ by 1.7e-2 to 4.6e-2 there).  A logit that rounds to
  the neighbouring bf16 value in one package moves by one ulp.
- bf16, 8 steps: losses atol 5e-3 and parameters atol 1e-2 (read 2.5e-3
  and 4.7e-3; JAX's bf16 and f32 runs end 1.0e-2 and 1.4e-2 apart), and
  the port's parameters closer to JAX's bf16 run than JAX's f32 run is.
"""

from __future__ import annotations

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu.data import mnist as jax_mnist
from pytorch_mnist_ddp_tpu.data.transforms import normalize as jax_normalize
from pytorch_mnist_ddp_tpu.models.net import CONV_IMPLS as JAX_CONV_IMPLS
from pytorch_mnist_ddp_tpu.models.net import Net as JaxNet
from pytorch_mnist_ddp_tpu.models.net import init_params
from pytorch_mnist_ddp_tpu.parallel import ddp as jax_ddp
from pytorch_mnist_ddp_tpu.parallel.mesh import make_mesh
from pytorch_mnist_ddp_tpu_torch.mnist import build_parser
from pytorch_mnist_ddp_tpu_torch.models.net import CONV_IMPLS, Net
from pytorch_mnist_ddp_tpu_torch.ops import adadelta_flat
from pytorch_mnist_ddp_tpu_torch.parallel.ddp import (
    make_eval_step,
    make_train_state,
    make_train_step,
)
from pytorch_mnist_ddp_tpu_torch.trainer import fit
from pytorch_mnist_ddp_tpu_torch.utils.convert import torch_state_from_jax

STEPS, BATCH = 8, 64
W = np.ones(BATCH, np.float32)


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(init_params(jax.random.PRNGKey(7)))


@pytest.fixture(scope="module")
def batches():
    images, labels = jax_mnist.synthetic_mnist("train", STEPS * BATCH)
    xs = jax_normalize(images).reshape(STEPS, BATCH, 28, 28, 1)
    ys = labels.astype(np.int64).reshape(STEPS, BATCH)
    return xs, ys


def _confident_params(seed: int) -> dict:
    """Initial weights with fc1 scaled 2x and fc2 8x: logits far enough
    apart that bf16 rounding shows in the log-probs."""
    params = {layer: dict(v) for layer, v in
              jax.device_get(init_params(jax.random.PRNGKey(seed))).items()}
    params["fc1"]["kernel"] = params["fc1"]["kernel"] * 2
    params["fc2"]["kernel"] = params["fc2"]["kernel"] * 8
    return params


def _port_net(params) -> Net:
    net = Net()
    net.load_state_dict(torch_state_from_jax(params))
    return net


def test_conv_impls_are_jax_conv_impls():
    assert CONV_IMPLS == JAX_CONV_IMPLS
    assert build_parser().get_default("conv_impl") == "conv"
    parser_choices = next(a.choices for a in build_parser()._actions if a.dest == "conv_impl")
    assert tuple(parser_choices) == CONV_IMPLS


@pytest.mark.parametrize("conv_impl", CONV_IMPLS)
def test_f32_forward_matches_jax(jax_params, conv_impl):
    x = jax_normalize(jax_mnist.synthetic_mnist("test", 128)[0])
    want = np.asarray(JaxNet(conv_impl=conv_impl).apply({"params": jax_params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_net(jax_params).eval()(torch.tensor(x), None, conv_impl).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.array_equal(got.argmax(1), want.argmax(1))


@pytest.mark.parametrize("conv_impl", CONV_IMPLS)
def test_bf16_forward_matches_jax(conv_impl):
    params = _confident_params(0)
    x = jax_normalize(jax_mnist.synthetic_mnist("train", 256)[0])
    net = JaxNet(compute_dtype=jnp.bfloat16, conv_impl=conv_impl)
    want = np.asarray(net.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = _port_net(params).eval()(torch.tensor(x), None, conv_impl, torch.bfloat16)
    assert got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=8e-3)
    assert np.array_equal(got.argmax(1), want.argmax(1))
    # the bf16 path is really narrower than f32
    f32 = np.asarray(JaxNet(conv_impl=conv_impl).apply({"params": params}, jnp.asarray(x)))
    assert np.abs(f32 - want).max() > 1e-2


def _jax_run(params, xs, ys, compute_dtype, conv_impl, use_pallas):
    mesh = make_mesh(num_data=1, devices=jax.devices()[:1])
    step = jax_ddp.make_train_step(mesh, compute_dtype=compute_dtype, dropout=False,
                                   use_pallas=use_pallas, conv_impl=conv_impl)
    state = jax_ddp.replicate_params(
        jax_ddp.make_train_state(params, use_pallas=use_pallas), mesh)
    losses = []
    for x, y in zip(xs, ys):
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y, jnp.int32), jnp.asarray(W),
                           jax.random.PRNGKey(0), jnp.float32(1.0))
        losses.append(float(loss[0]))
    return losses, torch_state_from_jax(jax.device_get(state.params))


def _port_run(params, xs, ys, compute_dtype, conv_impl, use_pallas):
    net = _port_net(params)
    state = make_train_state(net, use_pallas=use_pallas)
    step = make_train_step(dropout=False, use_pallas=use_pallas,
                           compute_dtype=compute_dtype, conv_impl=conv_impl)
    losses = [float(step(net, state, torch.tensor(x), torch.tensor(y), torch.tensor(W), 1.0))
              for x, y in zip(xs, ys)]
    assert state.step == STEPS
    assert adadelta_flat.is_flat_state(state.opt) == use_pallas
    return losses, net.state_dict()


@pytest.mark.parametrize("conv_impl", ["im2col_c1", "im2col"])
def test_f32_trajectory_matches_jax(jax_params, batches, conv_impl):
    want_losses, want = _jax_run(jax_params, *batches, jnp.float32, conv_impl, False)
    losses, got = _port_run(jax_params, *batches, torch.float32, conv_impl, False)
    np.testing.assert_allclose(losses, want_losses, rtol=2e-4, atol=2e-5)
    assert losses[-1] < losses[0]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=5e-3,
                                   err_msg=k)


@pytest.mark.parametrize("conv_impl,pallas_opt", [
    ("conv", False), ("conv", True), ("im2col", False),
], ids=["conv", "conv_pallas_opt", "im2col"])
def test_bf16_trajectory_matches_jax(jax_params, batches, monkeypatch, conv_impl, pallas_opt):
    if pallas_opt:
        monkeypatch.setenv("TPU_MNIST_PALLAS_INTERPRET", "1")
    want_losses, want = _jax_run(jax_params, *batches, jnp.bfloat16, conv_impl, pallas_opt)
    losses, got = _port_run(jax_params, *batches, torch.bfloat16, conv_impl, pallas_opt)
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=5e-3)
    for k in want:
        assert got[k].dtype == torch.float32  # parameters stay f32
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-2,
                                   err_msg=k)
    _, f32 = _jax_run(jax_params, *batches, jnp.float32, conv_impl, pallas_opt)

    def dist(a, b):
        return sum(float((a[k] - b[k]).square().sum()) for k in a) ** 0.5

    assert dist(got, want) < dist(f32, want)


def test_im2col_matches_conv_within_f32(jax_params, batches):
    """Same parameters, same math, another summation order: log-probs and
    gradients of the three lowerings agree within 1e-5."""
    x, y = (torch.tensor(a[0]) for a in batches)
    out = {}
    for impl in CONV_IMPLS:
        net = _port_net(jax_params)
        loss = torch.nn.functional.nll_loss(net(x, None, impl), y)
        loss.backward()
        out[impl] = (net(x, None, impl).detach(),
                     {k: p.grad for k, p in net.named_parameters()})
    for impl in CONV_IMPLS[1:]:
        assert torch.allclose(out[impl][0], out["conv"][0], rtol=0, atol=1e-5)
        for k, g in out["conv"][1].items():
            assert torch.allclose(out[impl][1][k], g, rtol=1e-4, atol=1e-6), (impl, k)


def test_bf16_keeps_parameters_state_and_tail_f32(jax_params, batches):
    xs, ys = batches
    net = _port_net(jax_params)
    state = make_train_state(net, use_pallas=True)
    step = make_train_step(dropout=True, use_pallas=True, compute_dtype=torch.bfloat16)
    loss = step(net, state, torch.tensor(xs[0]), torch.tensor(ys[0]), torch.tensor(W), 1.0)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert all(p.dtype == torch.float32 for p in net.parameters())
    assert all(t.dtype == torch.float32 for t in state.opt)
    loss_sum, correct = make_eval_step(torch.bfloat16)(net, torch.tensor(xs[1]),
                                                       torch.tensor(ys[1]), torch.tensor(W))
    assert loss_sum.dtype == torch.float32 and 0 <= float(correct) <= BATCH
    f32_sum, _ = make_eval_step()(net, torch.tensor(xs[1]), torch.tensor(ys[1]),
                                  torch.tensor(W))
    assert float(loss_sum) != float(f32_sum)


def test_unknown_conv_impl_is_refused():
    with pytest.raises(ValueError, match="conv_impl 'winograd' not in"):
        Net()(torch.zeros(1, 28, 28, 1), None, "winograd")
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--conv-impl", "winograd"])


@pytest.mark.parametrize("flags", [
    ["--conv-impl", "im2col_c1"], ["--conv-impl", "im2col"], ["--bf16", "--pallas-opt"],
    ["--bf16", "--conv-impl", "im2col"],
], ids=["im2col_c1", "im2col", "bf16_pallas_opt", "bf16_im2col"])
def test_variant_cli_runs_on_the_cpu(tmp_path, monkeypatch, flags):
    monkeypatch.delenv("MNIST_DATA_DIR", raising=False)
    args = build_parser().parse_args(["--dry-run", "--epochs", "1", "--train-limit", "128",
                                      "--data-root", str(tmp_path), *flags])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        model, state = fit(args, "cpu")
    assert state.step == 1
    assert "Train Epoch: 1 [0/128 (0%)]" in out.getvalue()
    assert "Test set: Average loss:" in out.getvalue()
    assert all(torch.isfinite(p).all() for p in model.parameters())
