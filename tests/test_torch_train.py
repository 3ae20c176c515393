"""The port's single-device training path held against the JAX package on
the CPU, on the same numpy inputs.

Exact: the synthetic set, IDX parsing, sampler indices, batch labels, pad
weights and order, the lr schedule, the printed lines, and the eval's
correct count.  Within tolerances:
- batch inputs x within 1e-6 (the JAX loader may normalize with its native
  C++ gather, which can contract the affine into an FMA);
- the NLL within rtol 1e-6 (summation order);
- eval loss sums within rtol 1e-5 (convolutions sum in another order);
- the 8-step trajectory, dropout off, within the f32 bounds
  ``tests/test_trajectory.py`` uses against torch: losses rtol 2e-4,
  atol 2e-5, final parameters atol 5e-3.  The two frameworks' conv
  backwards differ in the last ulp and Adadelta amplifies that step by
  step.  Measured on this CPU, both legs: loss rel 2.1e-7 at worst over
  the 8 steps, final parameters 6.0e-8 abs at worst (2.313 -> 2.278).
Dropout masks cannot equal JAX's (different generators), so the
cross-package runs have dropout off and dropout is tested on its own.
"""

from __future__ import annotations

import gzip
import os
import pathlib
import re
import struct
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu.data import mnist as jax_mnist
from pytorch_mnist_ddp_tpu.data.loader import DataLoader as JaxLoader
from pytorch_mnist_ddp_tpu.data.transforms import normalize as jax_normalize
from pytorch_mnist_ddp_tpu.models.net import init_params
from pytorch_mnist_ddp_tpu.ops.loss import nll_loss as jax_nll
from pytorch_mnist_ddp_tpu.ops.schedule import step_lr as jax_step_lr
from pytorch_mnist_ddp_tpu.parallel import ddp as jax_ddp
from pytorch_mnist_ddp_tpu.parallel.mesh import make_mesh
from pytorch_mnist_ddp_tpu.parallel.sampler import epoch_indices as jax_epoch_indices
from pytorch_mnist_ddp_tpu.utils import logging as jax_logging
from pytorch_mnist_ddp_tpu.utils.checkpoint import load_state_dict, params_from_state_dict
from pytorch_mnist_ddp_tpu_torch.data import mnist as port_mnist
from pytorch_mnist_ddp_tpu_torch.data.loader import DataLoader
from pytorch_mnist_ddp_tpu_torch.models.net import Net, dropout
from pytorch_mnist_ddp_tpu_torch.ops import adadelta_flat
from pytorch_mnist_ddp_tpu_torch.ops.loss import nll_loss
from pytorch_mnist_ddp_tpu_torch.ops.schedule import step_lr
from pytorch_mnist_ddp_tpu_torch.parallel.ddp import (
    make_eval_step,
    make_train_state,
    make_train_step,
)
from pytorch_mnist_ddp_tpu_torch.parallel.sampler import epoch_indices
from pytorch_mnist_ddp_tpu_torch.utils import logging as port_logging
from pytorch_mnist_ddp_tpu_torch.utils import checkpoint as port_checkpoint
from pytorch_mnist_ddp_tpu_torch.utils.checkpoint import load_inference_state
from pytorch_mnist_ddp_tpu_torch.utils.convert import torch_state_from_jax
from pytorch_mnist_ddp_tpu_torch.utils.rng import fold_step, split_streams

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS, BATCH = 8, 64


@pytest.mark.parametrize("split", ["train", "test"])
def test_synthetic_set_is_byte_equal(split):
    got = port_mnist.synthetic_mnist(split, 300)
    want = jax_mnist.synthetic_mnist(split, 300)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _idx(kind: str, arr: np.ndarray) -> bytes:
    if kind == "images":
        return struct.pack(">iiii", 2051, *arr.shape) + arr.tobytes()
    return struct.pack(">ii", 2049, len(arr)) + arr.tobytes()


def test_parse_idx_matches_jax():
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    labels = rng.randint(0, 10, 5).astype(np.uint8)
    for kind, arr in (("images", images), ("labels", labels)):
        raw = _idx(kind, arr)
        got = port_mnist.parse_idx(raw)
        assert np.array_equal(got, jax_mnist.parse_idx(raw))
        assert np.array_equal(got, arr)
        for bad in (raw[:6], raw[:-1], b"\0\0\0\1" + raw[4:]):
            with pytest.raises(ValueError):
                port_mnist.parse_idx(bad)


def test_local_idx_files_take_precedence(tmp_path, monkeypatch):
    """Gzip files in $MNIST_DATA_DIR load as they are; no notice."""
    rng = np.random.RandomState(1)
    arrays = {"images": rng.randint(0, 256, (7, 28, 28)).astype(np.uint8),
              "labels": rng.randint(0, 10, 7).astype(np.uint8)}
    for kind, name in (("images", "t10k-images-idx3-ubyte"), ("labels", "t10k-labels-idx1-ubyte")):
        with gzip.open(tmp_path / (name + ".gz"), "wb") as f:
            f.write(_idx(kind, arrays[kind]))
    monkeypatch.setenv("MNIST_DATA_DIR", str(tmp_path))
    ds = port_mnist.MNIST(root="/nonexistent", train=False)
    assert ds.source == "idx" and len(ds) == 7
    assert np.array_equal(ds.images, arrays["images"])
    assert np.array_equal(ds.labels, arrays["labels"])


def test_epoch_indices_match_jax_over_a_grid():
    for n in (1, 7, 200, 1001):
        for world in (1, 2, 3, 8):
            for rank in range(world):
                for epoch in (0, 1, 5):
                    for seed in (0, 1, 42):
                        for shuffle in (True, False):
                            args = (n, world, rank, epoch, seed, shuffle)
                            got = epoch_indices(*args, return_valid=True)
                            want = jax_epoch_indices(*args, return_valid=True)
                            for a, b in zip(got, want, strict=True):
                                assert np.array_equal(a, b), args


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("epoch", [1, 2])
def test_loader_batches_match_jax(shuffle, epoch):
    images, labels = jax_mnist.synthetic_mnist("train", 200)
    port = DataLoader(images, labels, BATCH, torch.device("cpu"), shuffle=shuffle, seed=3)
    ref = JaxLoader(images, labels, BATCH, mesh=None, shuffle=shuffle, seed=3)
    assert len(port) == len(ref) == 4 and port.dataset_len == 200
    got = list(port.epoch(epoch))
    want = list(ref._host_batches(epoch))
    assert len(got) == len(want)
    for (x, y, w), (jx, jy, jw) in zip(got, want):
        assert x.dtype == torch.float32 and tuple(x.shape) == (BATCH, 28, 28, 1)
        np.testing.assert_allclose(x.numpy(), jx, rtol=0, atol=1e-6)
        assert np.array_equal(y.numpy(), jy) and np.array_equal(w.numpy(), jw)
    assert got[-1][2].sum() == 200 - 3 * BATCH  # 8 real rows, 56 padded


def test_step_lr_matches_jax():
    for base, gamma, size in ((1.0, 0.7, 1), (0.5, 0.9, 2), (2.0, 0.1, 3)):
        got, want = step_lr(base, gamma, size), jax_step_lr(base, gamma, size)
        assert [got(e) for e in range(1, 15)] == [want(e) for e in range(1, 15)]


def test_log_lines_are_byte_equal_to_jax():
    for loss in (0.0, 1e-7, 0.123456789, 2.302585, 123.4567891):
        for epoch, batch_idx, num_batches in ((1, 0, 938), (3, 930, 938), (14, 10, 11)):
            args = (epoch, batch_idx * 64, 60000, batch_idx, num_batches, loss)
            assert port_logging.train_log_line(*args) == jax_logging.train_log_line(*args)
        for correct, n in ((0, 10000), (9771, 10000), (256, 256), (1, 3)):
            assert (port_logging.test_summary_lines(loss, correct, n)
                    == jax_logging.test_summary_lines(loss, correct, n))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("weighted", [True, False])
def test_nll_loss_matches_jax(reduction, weighted):
    rng = np.random.RandomState(4)
    logits = rng.randn(64, 10).astype(np.float32)
    log_probs = logits - np.log(np.exp(logits).sum(1, keepdims=True))
    y = rng.randint(0, 10, 64)
    w = np.r_[np.ones(40), np.zeros(24)].astype(np.float32) if weighted else None
    got = nll_loss(torch.tensor(log_probs), torch.tensor(y),
                   None if w is None else torch.tensor(w), reduction)
    want = jax_nll(jnp.asarray(log_probs), jnp.asarray(y, jnp.int32),
                   None if w is None else jnp.asarray(w), reduction)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    if weighted:
        zero = nll_loss(torch.tensor(log_probs), torch.tensor(y), torch.zeros(64), "mean")
        assert float(zero) == 0.0  # max(w.sum(), 1): an all-pad batch is no NaN


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(init_params(jax.random.PRNGKey(7)))


@pytest.fixture(scope="module")
def batches():
    images, labels = jax_mnist.synthetic_mnist("train", STEPS * BATCH)
    xs = jax_normalize(images).reshape(STEPS, BATCH, 28, 28, 1)
    ys = labels.astype(np.int64).reshape(STEPS, BATCH)
    return xs, ys


def _port_net(params) -> Net:
    net = Net()
    net.load_state_dict(torch_state_from_jax(params))
    return net


@pytest.mark.parametrize("pallas_opt", [False, True], ids=["plain", "pallas_opt"])
def test_trajectory_matches_jax(jax_params, batches, pallas_opt, monkeypatch):
    """8 steps at lr 1.0 from the same weights on the same batches, dropout
    off.  The pallas_opt leg runs the JAX kernel in interpret mode (its
    flat state) against the port's flat delta path."""
    xs, ys = batches
    if pallas_opt:
        monkeypatch.setenv("TPU_MNIST_PALLAS_INTERPRET", "1")
    mesh = make_mesh(num_data=1, devices=jax.devices()[:1])
    jstep = jax_ddp.make_train_step(mesh, dropout=False, use_pallas=pallas_opt)
    jstate = jax_ddp.replicate_params(
        jax_ddp.make_train_state(jax_params, use_pallas=pallas_opt), mesh)
    w = np.ones(BATCH, np.float32)
    jlosses = []
    for x, y in zip(xs, ys):
        jstate, losses = jstep(jstate, jnp.asarray(x), jnp.asarray(y, jnp.int32),
                               jnp.asarray(w), jax.random.PRNGKey(0), jnp.float32(1.0))
        jlosses.append(float(losses[0]))

    net = _port_net(jax_params)
    state = make_train_state(net, use_pallas=pallas_opt)
    assert adadelta_flat.is_flat_state(state.opt) == pallas_opt
    step = make_train_step(dropout=False, use_pallas=pallas_opt)
    losses = [float(step(net, state, torch.tensor(x), torch.tensor(y), torch.tensor(w), 1.0))
              for x, y in zip(xs, ys)]
    assert state.step == STEPS

    np.testing.assert_allclose(losses, jlosses, rtol=2e-4, atol=2e-5)
    assert losses[-1] < losses[0]
    want = torch_state_from_jax(jax.device_get(jstate.params))
    got = net.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=5e-3,
                                   err_msg=k)


def test_eval_totals_match_jax(jax_params):
    images, labels = jax_mnist.synthetic_mnist("test", 64)
    x = jax_normalize(images)
    y = labels.astype(np.int64)
    w = np.r_[np.ones(50), np.zeros(14)].astype(np.float32)
    mesh = make_mesh(num_data=1, devices=jax.devices()[:1])
    want = np.asarray(jax_ddp.make_eval_step(mesh)(
        jax_params, jnp.asarray(x), jnp.asarray(y, jnp.int32), jnp.asarray(w)))
    loss_sum, correct = make_eval_step()(_port_net(jax_params), torch.tensor(x),
                                         torch.tensor(y), torch.tensor(w))
    np.testing.assert_allclose(float(loss_sum), want[0], rtol=1e-5)
    assert float(correct) == want[1]


def _drop_gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(fold_step(split_streams(seed)["dropout"], 0))


def test_dropout_masks_repeat_from_the_seed():
    net = _port_net(jax.device_get(init_params(jax.random.PRNGKey(1)))).train()
    x = torch.tensor(np.random.RandomState(6).randn(8, 28, 28, 1).astype(np.float32))
    a, b, c = (net(x, _drop_gen(s)) for s in (1, 1, 2))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not torch.equal(a, net(x))  # no generator: no dropout
    assert split_streams(1) == split_streams(1) != split_streams(2)
    assert fold_step(5, 0) != fold_step(5, 1)


@pytest.mark.parametrize("rate", [0.25, 0.5])
def test_dropout_keeps_the_expected_fraction_scaled(rate):
    n = 200_000
    keep_prob = 1.0 - rate
    x = torch.tensor(np.random.RandomState(7).rand(n).astype(np.float32) + 0.5)
    out = dropout(x, rate, torch.Generator().manual_seed(3))
    kept = out != 0
    frac = float(kept.float().mean())
    sigma = (keep_prob * rate / n) ** 0.5
    assert abs(frac - keep_prob) < 5 * sigma
    want = x.numpy()[kept.numpy()] / np.float32(keep_prob)
    assert np.array_equal(out[kept].numpy(), want)


def test_eval_mode_is_the_identity():
    net = _port_net(jax.device_get(init_params(jax.random.PRNGKey(1)))).eval()
    x = torch.tensor(np.random.RandomState(8).randn(4, 28, 28, 1).astype(np.float32))
    assert torch.equal(net(x, _drop_gen(1)), net(x))


def test_cli_runs_end_to_end_on_the_cpu(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "MNIST_DATA_DIR"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.mnist", "--no-cuda",
         "--dry-run", "--epochs", "2", "--train-limit", "256", "--save-model"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout

    # Rebuild the expected stdout from the JAX package's own helpers and
    # the numbers the port printed: byte-equal means the format is JAX's.
    train = re.findall(r"^Train Epoch: (\d+) \[(\d+)/(\d+) \(\d+%\)\]\tLoss: (\S+)$", out, re.M)
    tests = re.findall(r"^Test set: Average loss: (\S+), Accuracy: (\d+)/(\d+) ", out, re.M)
    assert len(train) == len(tests) == 2
    # The JAX package's notice, as data/mnist.py:306-308 prints it.
    want = ("MNIST IDX files unavailable (no local copy, download failed); "
            "using deterministic synthetic MNIST-like data\n")
    for (epoch, seen, n, loss), (avg, correct, n_test) in zip(train, tests):
        assert (seen, n, n_test) == ("0", "256", "256")
        want += jax_logging.train_log_line(int(epoch), 0, 256, 0, 4, float(loss)) + "\n"
        want += jax_logging.test_summary_lines(float(avg), int(correct), 256) + "\n"
    assert out == want
    assert all(np.isfinite(float(t[3])) for t in train)

    path = str(tmp_path / "mnist_cnn.pt")
    port_state = load_inference_state(path)
    jax_state = torch_state_from_jax(params_from_state_dict(load_state_dict(path)))
    raw = torch.load(path, weights_only=True)
    assert list(raw) == list(Net().state_dict())  # no module. prefix
    assert sorted(port_state) == sorted(jax_state) == sorted(raw)
    for k in raw:
        assert torch.equal(port_state[k], jax_state[k]) and torch.equal(port_state[k], raw[k])


def test_save_model_is_atomic(tmp_path, monkeypatch):
    """A write that fails midway leaves the previous file whole and no
    temporary file behind."""
    path = tmp_path / "mnist_cnn.pt"
    first = port_checkpoint.model_state_dict(Net(torch.Generator().manual_seed(1)))
    port_checkpoint.save_state_dict(first, str(path))
    before = path.read_bytes()

    def torn(obj, f):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(port_checkpoint.torch, "save", torn)
    with pytest.raises(OSError, match="disk full"):
        port_checkpoint.save_state_dict(
            port_checkpoint.model_state_dict(Net(torch.Generator().manual_seed(2))), str(path))
    assert path.read_bytes() == before
    assert [p.name for p in tmp_path.iterdir()] == ["mnist_cnn.pt"]
    loaded = torch.load(path, weights_only=True)
    assert all(torch.equal(loaded[k], first[k]) for k in first)
