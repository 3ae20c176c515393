"""``--syncbn``: the port's SyncBatchNorm, its data-parallel trajectory and
its checkpoints, held against the JAX package on the CPU.

- The BatchNorm layer on a gloo world of 2 ranks against the JAX
  ``SyncBatchNorm`` on a 2-device mesh, one shard holding padding rows
  (mask 0): the output, the gradients of the input, scale and bias of
  ``sum(y * c)``, and the running averages within 1e-5; the same without
  a process group against one device, and in eval mode.
- 8 data-parallel ``--syncbn`` steps, dropout off, plain and
  ``--pallas-opt``, within ``test_torch_train.py``'s trajectory gates
  (losses rtol 2e-4, atol 2e-5; parameters and running averages atol
  5e-3), the ranks' models ``torch.equal`` after every step; the eval
  step's totals as ``test_torch_ddp.py`` holds them.
- BN checkpoints cross both ways: ``--save-model`` files (torch and npz,
  with ``module.`` keys and ``num_batches_tracked``) and ``--save-state``
  archives (``batch_stats``, flat accumulators in JAX's ``ravel_pytree``
  order); the refusals use the JAX trainer's text.
"""

from __future__ import annotations

import contextlib
import io
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pytorch_mnist_ddp_tpu.data import mnist as jax_mnist
from pytorch_mnist_ddp_tpu.data.transforms import normalize as jax_normalize
from pytorch_mnist_ddp_tpu.models.net import SyncBatchNorm as JaxBN
from pytorch_mnist_ddp_tpu.models.net import init_variables
from pytorch_mnist_ddp_tpu.ops import pallas_adadelta as jax_pa
from pytorch_mnist_ddp_tpu.ops.adadelta import AdadeltaState as JaxAdadeltaState
from pytorch_mnist_ddp_tpu.parallel import ddp as jax_ddp
from pytorch_mnist_ddp_tpu.parallel.mesh import DATA_AXIS, make_mesh
from pytorch_mnist_ddp_tpu.utils import checkpoint as jax_ckpt
from pytorch_mnist_ddp_tpu.utils.jax_compat import shard_map
from pytorch_mnist_ddp_tpu_torch.mnist import build_parser as mnist_parser
from pytorch_mnist_ddp_tpu_torch.mnist_ddp import build_parser as ddp_parser
from pytorch_mnist_ddp_tpu_torch.models.net import Net, SyncBatchNorm
from pytorch_mnist_ddp_tpu_torch.ops.adadelta import AdadeltaState
from pytorch_mnist_ddp_tpu_torch.ops.adadelta_flat import FlatAdadeltaState
from pytorch_mnist_ddp_tpu_torch.serving.engine import InferenceEngine
from pytorch_mnist_ddp_tpu_torch.trainer import fit
from pytorch_mnist_ddp_tpu_torch.utils import checkpoint as ckpt
from pytorch_mnist_ddp_tpu_torch.utils.convert import (
    jax_flat_from_torch,
    jax_state_from_torch,
    torch_flat_from_jax,
    torch_shapes,
    torch_state_from_jax,
)
from test_torch_launch import bn_ranks, run_world, train_ranks
from test_torch_resume import assert_jax_text

STEPS, B, PAD = 8, 16, 4
C, H = 8, 5  # the layer tests' channels and spatial size
TOL = 1e-5
LIMIT = 160


def _rng_bn(seed: int):
    """x [2*b, C, H, H], a mask with 3 padding rows on rank 1, a cotangent
    and BN state (numpy, torch names)."""
    rng = np.random.RandomState(seed)
    b = 6
    x = (rng.randn(2 * b, C, H, H) * 2 + 0.5).astype(np.float32)
    mask = np.ones(2 * b, np.float32)
    mask[-3:] = 0.0
    x[-3:] = 0.0  # padding rows are zeros, as the loader leaves them
    cot = rng.randn(2 * b, C, H, H).astype(np.float32)
    params = {"weight": rng.rand(C).astype(np.float32) + 0.5,
              "bias": rng.randn(C).astype(np.float32),
              "running_mean": rng.randn(C).astype(np.float32),
              "running_var": rng.rand(C).astype(np.float32) + 0.5}
    return x, mask, cot, params


def _jax_bn(x, mask, cot, params, n_devices: int):
    """JAX's SyncBatchNorm over ``n_devices`` mesh devices (one without an
    axis): y, dx, dscale, dbias per device, and the new running averages."""
    bn = JaxBN(axis_name=DATA_AXIS if n_devices > 1 else None)
    variables = {"params": {"scale": params["weight"], "bias": params["bias"]},
                 "batch_stats": {"mean": params["running_mean"], "var": params["running_var"]}}
    nhwc = lambda a: np.ascontiguousarray(a.transpose(0, 2, 3, 1))  # noqa: E731

    def local(p, stats, xs, m, c):
        def loss(p, xs):
            y, upd = bn.apply({"params": p, "batch_stats": stats}, xs, train=True, mask=m,
                              mutable=["batch_stats"])
            return (y * c).sum(), (y, upd["batch_stats"])

        (_, (y, upd)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(p, xs)
        return y, upd, jax.tree.map(lambda a: a[None], gp), gx

    mesh = make_mesh(num_data=n_devices, devices=jax.devices()[:n_devices])
    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(), P(), P(DATA_AXIS), P(DATA_AXIS), P(DATA_AXIS)),
                   out_specs=(P(DATA_AXIS), P(), P(DATA_AXIS), P(DATA_AXIS)), check_vma=False)
    y, upd, gp, gx = jax.device_get(fn(variables["params"], variables["batch_stats"],
                                       nhwc(x), mask, nhwc(cot)))
    nchw = lambda a: a.transpose(0, 3, 1, 2)  # noqa: E731
    return {"y": nchw(y), "dx": nchw(gx), "dweight": gp["scale"], "dbias": gp["bias"],
            "running_mean": upd["mean"], "running_var": upd["var"]}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL,
                               err_msg=what)


def test_syncbn_layer_on_two_ranks_matches_jax_mesh(tmp_path):
    x, mask, cot, params = _rng_bn(0)
    want = _jax_bn(x, mask, cot, params, 2)
    ranks = run_world(bn_ranks, 2, tmp_path, x, mask, cot, params)
    b = len(x) // 2
    for rank, got in enumerate(ranks):
        rows = slice(rank * b, (rank + 1) * b)
        for key in ("y", "dx"):
            _close(got[key].numpy(), want[key][rows], f"{key} rank {rank}")
        for key in ("dweight", "dbias"):
            _close(got[key].numpy(), want[key][rank], f"{key} rank {rank}")
        for key in ("running_mean", "running_var"):
            _close(got[key].numpy(), want[key], f"{key} rank {rank}")
            assert torch.equal(got[key], ranks[0][key])  # the stats are global
    # The synced statistics differ from either rank's own.
    alone = [_jax_bn(x[r * b:(r + 1) * b], mask[r * b:(r + 1) * b], cot[r * b:(r + 1) * b],
                     params, 1) for r in range(2)]
    assert not np.allclose(alone[0]["running_mean"], want["running_mean"], atol=1e-3)


def test_syncbn_layer_without_sync_keeps_its_rank_statistics_in_a_group(tmp_path):
    """A live process group alone syncs nothing: the step decides."""
    x, mask, cot, params = _rng_bn(0)
    ranks = run_world(bn_ranks, 2, tmp_path, x, mask, cot, params, False)
    b = len(x) // 2
    for rank, got in enumerate(ranks):
        rows = slice(rank * b, (rank + 1) * b)
        want = _jax_bn(x[rows], mask[rows], cot[rows], params, 1)
        for key in ("y", "dx"):
            _close(got[key].numpy(), want[key], f"{key} rank {rank}")
        for key in ("dweight", "dbias"):
            _close(got[key].numpy(), want[key][0], f"{key} rank {rank}")
        for key in ("running_mean", "running_var"):
            _close(got[key].numpy(), want[key], f"{key} rank {rank}")


@pytest.mark.parametrize("masked", [True, False])
def test_syncbn_layer_without_a_group_matches_one_device(masked):
    x, mask, cot, params = _rng_bn(1)
    if not masked:
        mask = np.ones_like(mask)
    want = _jax_bn(x, mask, cot, params, 1)
    bn = SyncBatchNorm(C)
    bn.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt, torch.from_numpy(mask) if masked else None)
    (y * torch.from_numpy(cot)).sum().backward()
    got = {"y": y.detach(), "dx": xt.grad, "dweight": bn.weight.grad[None],
           "dbias": bn.bias.grad[None], "running_mean": bn.running_mean,
           "running_var": bn.running_var}
    for key, value in got.items():
        _close(value.numpy(), want[key], key)


def test_syncbn_eval_normalizes_with_the_running_averages():
    x, _, _, params = _rng_bn(2)
    bn = JaxBN()
    want = bn.apply({"params": {"scale": params["weight"], "bias": params["bias"]},
                     "batch_stats": {"mean": params["running_mean"],
                                     "var": params["running_var"]}},
                    x.transpose(0, 2, 3, 1), train=False)
    port = SyncBatchNorm(C).eval()
    port.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    got = port(torch.from_numpy(x))
    _close(got.detach().numpy(), np.asarray(want).transpose(0, 3, 1, 2), "eval y")
    assert torch.equal(port(torch.from_numpy(x[:1])), got[:1])  # no batch statistics


def test_bn_net_parameters_and_init():
    net = Net(torch.Generator().manual_seed(3), use_bn=True)
    plain = Net(torch.Generator().manual_seed(3))
    assert list(dict(net.named_parameters())) == list(torch_shapes(True))
    assert {k: tuple(v.shape) for k, v in net.named_parameters()} == torch_shapes(True)
    for k, v in plain.state_dict().items():  # BN draws nothing from the generator
        assert torch.equal(net.state_dict()[k], v)
    assert torch.equal(net.bn1.weight, torch.ones(32)) and torch.equal(net.bn2.bias,
                                                                         torch.zeros(64))
    assert [k for k in net.state_dict() if k.startswith("bn1")] == [
        "bn1.weight", "bn1.bias", "bn1.running_mean", "bn1.running_var"]


# -- the --syncbn trajectory ------------------------------------------------

def _global_batches():
    images, labels = jax_mnist.synthetic_mnist("train", STEPS * 2 * B)
    xs = jax_normalize(images).reshape(STEPS, 2 * B, 28, 28, 1)
    ys = labels.astype(np.int64).reshape(STEPS, 2 * B)
    ws = np.ones((STEPS, 2, B), np.float32)
    ws[-1, :, B - PAD:] = 0.0
    xs[-1].reshape(2, B, 28, 28, 1)[:, B - PAD:] = 0.0
    return xs, ys, ws.reshape(STEPS, 2 * B)


def _eval_batch():
    images, labels = jax_mnist.synthetic_mnist("test", 50)
    w = np.ones(50, np.float32)
    w[-3:] = 0.0
    return jax_normalize(images), labels.astype(np.int64), w


@pytest.fixture(scope="module")
def jax_variables():
    return jax.device_get(init_variables(jax.random.PRNGKey(5), use_bn=True))


def _port_state(variables) -> dict:
    state = torch_state_from_jax(variables["params"])
    state.update(ckpt._torch_stats(variables["batch_stats"]))
    return state


@pytest.fixture(scope="module")
def syncbn_runs(jax_variables, tmp_path_factory):
    state = {k: v.numpy() for k, v in _port_state(jax_variables).items()}
    runs = (("plain", False, True), ("pallas_opt", True, True))
    return run_world(train_ranks, 2, tmp_path_factory.mktemp("syncbn"), state,
                     _global_batches(), runs, (*_eval_batch(), True))


@pytest.mark.parametrize("run", ["plain", "pallas_opt"])
def test_syncbn_trajectory_matches_jax_mesh(jax_variables, syncbn_runs, run, monkeypatch):
    pallas_opt = run == "pallas_opt"
    if pallas_opt:
        monkeypatch.setenv("TPU_MNIST_PALLAS_INTERPRET", "1")
    mesh = make_mesh(num_data=2, devices=jax.devices()[:2])
    step = jax_ddp.make_train_step(mesh, dropout=False, use_pallas=pallas_opt, use_bn=True)
    jstate = jax_ddp.replicate_params(jax_ddp.make_train_state(
        jax_variables["params"], jax_variables["batch_stats"], use_pallas=pallas_opt), mesh)
    jlosses = []
    for x, y, w in zip(*_global_batches()):
        jstate, per_shard = step(jstate, jnp.asarray(x), jnp.asarray(y, jnp.int32),
                                 jnp.asarray(w), jax.random.PRNGKey(0), jnp.float32(1.0))
        jlosses.append(np.asarray(per_shard))
    jlosses = np.stack(jlosses)
    ranks = [r[run] for r in syncbn_runs]
    for rank, got in enumerate(ranks):
        np.testing.assert_allclose(got["losses"], jlosses[:, rank], rtol=2e-4, atol=2e-5,
                                   err_msg=f"rank {rank}")
    assert all(r["digests"] == ranks[0]["digests"] for r in ranks)
    want = _port_state(jax.device_get({"params": jstate.params,
                                       "batch_stats": jstate.batch_stats}))
    for k, v in want.items():
        np.testing.assert_allclose(ranks[0]["state"][k].numpy(), v.numpy(), rtol=0, atol=5e-3,
                                   err_msg=k)
    assert not np.allclose(want["bn1.running_var"].numpy(), 1.0)  # the stats moved


def test_syncbn_eval_totals_match_jax(jax_variables, syncbn_runs):
    x, y, w = _eval_batch()
    mesh = make_mesh(num_data=2, devices=jax.devices()[:2])
    want = np.asarray(jax_ddp.make_eval_step(mesh, use_bn=True)(
        jax_variables, jnp.asarray(x), jnp.asarray(y, jnp.int32), jnp.asarray(w)))
    totals = [r["eval"] for r in syncbn_runs]
    assert totals[0] == totals[1]
    np.testing.assert_allclose(totals[0][0], want[0], rtol=1e-5)
    assert totals[0][1] == want[1]


# -- checkpoints --------------------------------------------------------------

def _random_bn_variables(seed: int):
    """JAX-layout BN variables of random values."""
    rng = np.random.RandomState(seed)
    v = jax.device_get(init_variables(jax.random.PRNGKey(seed), use_bn=True))
    return jax.tree.map(lambda a: (rng.randn(*a.shape) * 0.1 + a).astype(np.float32), v)


@pytest.mark.parametrize("fmt", ["torch", "npz"])
def test_jax_bn_model_file_loads_for_syncbn_resume(tmp_path, fmt):
    v = _random_bn_variables(1)
    path = str(tmp_path / ("m.pt" if fmt == "torch" else "m.npz"))
    jax_ckpt.save_state_dict(jax_ckpt.model_state_dict(
        v["params"], ddp_prefix=True, batch_stats=v["batch_stats"], num_batches=7), path,
        format=fmt)
    state, step = ckpt.load_resume_state(path, syncbn=True)
    want = _port_state(v)
    assert sorted(state) == sorted(want) and step == 7
    for k in want:
        assert torch.equal(state[k], want[k]), k
    Net(use_bn=True).load_state_dict(state)  # every key, no extra


def test_port_bn_model_file_loads_in_jax(tmp_path):
    net = Net(torch.Generator().manual_seed(4), use_bn=True)
    with torch.no_grad():
        for t in (net.bn1.weight, net.bn2.bias, net.bn1.running_mean, net.bn2.running_var):
            t.add_(torch.rand(t.shape, generator=torch.Generator().manual_seed(5)))
    path = str(tmp_path / "mnist_cnn.pt")
    ckpt.save_state_dict(ckpt.model_state_dict(net, ddp_prefix=True, num_batches=9), path)
    raw = torch.load(path, weights_only=True)
    assert raw["module.bn2.num_batches_tracked"].dtype == torch.int64
    assert int(raw["module.bn1.num_batches_tracked"]) == 9
    loaded = jax_ckpt.load_variables(path)
    assert set(loaded["batch_stats"]) == {"bn1", "bn2"}
    got = _port_state(loaded)
    for k, v in net.state_dict().items():
        assert torch.equal(got[k], v), k


def test_serving_still_refuses_bn_checkpoints(tmp_path):
    path = str(tmp_path / "mnist_cnn.pt")
    ckpt.save_state_dict(ckpt.model_state_dict(Net(use_bn=True), num_batches=1), path)
    # The f32 and bf16 forwards serve it since the BatchNorm forward was
    # ported; the int8 variant still refuses it, with the JAX engine's text.
    state = ckpt.load_inference_state(path)
    assert torch.equal(state["bn2.running_var"], torch.ones(64))
    with pytest.raises(ValueError, match="serve BN checkpoints at f32 or bf16"):
        InferenceEngine(state, device="cpu", buckets=(1,), dtypes=("int8",))


def _jax_flat_bn(tree: dict) -> np.ndarray:
    """JAX's own per-leaf -> padded-flat conversion of a BN param tree."""
    flat = jax_pa.ensure_opt_layout(JaxAdadeltaState(square_avg=tree, acc_delta=tree), tree,
                                    True)
    return np.asarray(flat.square_avg)


def test_bn_flat_accumulators_cross_in_ravel_pytree_order(monkeypatch):
    monkeypatch.setenv("TPU_MNIST_PALLAS_INTERPRET", "1")
    tree = _random_bn_variables(2)["params"]
    flat = _jax_flat_bn(tree)
    port = torch_flat_from_jax(flat, use_bn=True)
    state = torch_state_from_jax(tree)
    assert torch.equal(port, torch.cat([state[k].reshape(-1) for k in torch_shapes(True)]))
    assert np.array_equal(jax_flat_from_torch(port, use_bn=True), flat)


@pytest.mark.parametrize("layout", ["flat", "per_leaf"])
def test_bn_archives_cross_both_ways(tmp_path, layout, monkeypatch):
    monkeypatch.setenv("TPU_MNIST_PALLAS_INTERPRET", "1")
    v = _random_bn_variables(3)
    acc = _random_bn_variables(4)["params"]
    opt = JaxAdadeltaState(square_avg=acc, acc_delta=acc)
    if layout == "flat":
        opt = jax_pa.ensure_opt_layout(opt, v["params"], True)
    jax_path = str(tmp_path / "jax.npz")
    jax_ckpt.save_train_state(jax_ddp.TrainState(params=v["params"], opt=opt,
                                                 step=jnp.int32(12),
                                                 batch_stats=v["batch_stats"]),
                              jax_path, epoch=2)
    archive, epoch, extras = ckpt.load_train_state_full(jax_path, syncbn=True)
    assert (archive.step, epoch, extras) == (12, 2, {})
    want = _port_state(v)
    for k, t in {**archive.params, **archive.batch_stats}.items():
        assert torch.equal(t, want[k]), k
    acc_state = torch_state_from_jax(acc)
    if layout == "flat":
        assert isinstance(archive.opt, FlatAdadeltaState)
        assert torch.equal(archive.opt.square_avg,
                           torch.cat([acc_state[k].reshape(-1) for k in torch_shapes(True)]))
    else:
        assert isinstance(archive.opt, AdadeltaState)
        for k, t in archive.opt.acc_delta.items():
            assert torch.equal(t, acc_state[k]), k
    # ... and back: the port's archive reads in JAX as the original.
    port_path = str(tmp_path / "port.npz")
    ckpt.save_train_state(archive.params, archive.opt, archive.step, port_path, epoch=2,
                          batch_stats=archive.batch_stats)
    state, epoch = jax_ckpt.load_train_state(port_path)
    assert epoch == 2 and int(state.step) == 12
    for a, b in zip(jax.tree.leaves((state.params, state.batch_stats, state.opt)),
                    jax.tree.leaves((v["params"], v["batch_stats"], opt)), strict=True):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    with np.load(port_path) as port_npz, np.load(jax_path) as jax_npz:
        assert list(port_npz.files) == list(jax_npz.files)


# -- the trainer's --syncbn surface ------------------------------------------------

@pytest.fixture
def idx_dir(tmp_path_factory, monkeypatch):
    root = tmp_path_factory.mktemp("idx")
    for split, prefix in (("train", "train"), ("test", "t10k")):
        images, labels = jax_mnist.synthetic_mnist(split, LIMIT)
        (root / f"{prefix}-images-idx3-ubyte").write_bytes(
            struct.pack(">iiii", 2051, *images.shape) + images.tobytes())
        (root / f"{prefix}-labels-idx1-ubyte").write_bytes(
            struct.pack(">ii", 2049, len(labels)) + labels.tobytes())
    monkeypatch.setenv("MNIST_DATA_DIR", str(root))


def _fit(*flags, parser=ddp_parser, save_path=None):
    args = parser().parse_args(["--train-limit", str(LIMIT), "--batch-size", "32", *flags])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        model, state = fit(args, "cpu", save_path=save_path)
    return model, state, out.getvalue()


def test_syncbn_fit_saves_and_resumes_its_checkpoints(idx_dir, tmp_path):
    """A world of one with --syncbn: --save-model writes BN keys and
    num_batches_tracked = steps; --resume of it continues the step count;
    --save-state then --resume-state ends on the two-epoch run's bits."""
    model_path, state_path = str(tmp_path / "m.pt"), str(tmp_path / "s.npz")
    full, full_state, _ = _fit("--syncbn", "--epochs", "2", "--pallas-opt")
    model, state, _ = _fit("--syncbn", "--epochs", "1", "--pallas-opt", "--save-model",
                           "--save-state", state_path, save_path=model_path)
    raw = torch.load(model_path, weights_only=True)
    assert int(raw["bn2.num_batches_tracked"]) == state.step == 5
    resumed, resumed_state, out = _fit("--syncbn", "--epochs", "0", "--resume", model_path)
    assert resumed_state.step == 5
    for k, v in model.state_dict().items():
        assert torch.equal(resumed.state_dict()[k], v), k
    again, again_state, out = _fit("--syncbn", "--epochs", "1", "--pallas-opt",
                                   "--resume-state", state_path)
    assert "Train Epoch: 2 " in out and again_state.step == full_state.step == 10
    for k, v in full.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def test_syncbn_refusals_use_the_jax_text(idx_dir, tmp_path):
    plain_model, plain_archive = str(tmp_path / "p.pt"), str(tmp_path / "p.npz")
    _fit("--epochs", "0", "--save-model", "--save-state", plain_archive,
         parser=mnist_parser, save_path=plain_model)
    with pytest.raises(ValueError, match="has no BatchNorm parameters; drop --syncbn") as err:
        _fit("--syncbn", "--epochs", "1", "--resume", plain_model)
    assert_jax_text(str(err.value))
    with pytest.raises(ValueError, match="saved without BatchNorm state; drop --syncbn") as err:
        _fit("--syncbn", "--epochs", "1", "--resume-state", plain_archive)
    assert_jax_text(str(err.value))
    bn_model = str(tmp_path / "bn.pt")
    ckpt.save_state_dict(ckpt.model_state_dict(Net(use_bn=True), num_batches=1), bn_model)
    with pytest.raises(ValueError, match="carries BatchNorm parameters; add --syncbn") as err:
        _fit("--epochs", "1", "--resume", bn_model)
    assert_jax_text(str(err.value))


def test_jax_state_from_torch_keeps_jax_key_order():
    tree = jax_state_from_torch(Net(use_bn=True).state_dict())
    assert list(tree) == ["bn1", "bn2", "conv1", "conv2", "fc1", "fc2"]
    assert list(tree["bn1"]) == ["bias", "scale"] and list(tree["fc1"]) == ["bias", "kernel"]
