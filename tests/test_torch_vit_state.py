"""The ViT's ``--save-state``/``--resume-state`` (``vit_mnist.py``) held
against the JAX package on the CPU.

- Archives cross both ways.  A state after K steps of the single-device
  step (the JAX CLI's, vit_mnist.py:570-582; the port's
  ``make_forward_train_step``) is saved by one package and continued for
  K more steps by the other, while the saving package takes the same K
  steps from memory: losses and parameters within the CNN archives' gates
  (``tests/test_torch_resume.py``: losses rtol 2e-4 / atol 2e-5,
  parameters atol 5e-3), ``step`` 2K, and the archive's tree the JAX
  package's own.
- The port's own continuation is exact (``torch.equal`` on params,
  accumulators and step): one epoch with ``--save-state``, then one with
  ``--resume-state``, equals two epochs, plain, ``--flash``, ``--sp 1
  --allow-degree-1`` and ``--zero`` (a world of one); a ``--zero`` archive
  resumes in a plain run, and the reverse, on the same bits.
- Refusals are the JAX CLI's texts, read from its source.
"""

from __future__ import annotations

import contextlib
import io
import pathlib
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu.data import mnist as jax_mnist
from pytorch_mnist_ddp_tpu.data.transforms import normalize as jax_normalize
from pytorch_mnist_ddp_tpu.models import vit as jvit
from pytorch_mnist_ddp_tpu.ops.adadelta import adadelta_init as jax_adadelta_init
from pytorch_mnist_ddp_tpu.ops.adadelta import adadelta_update as jax_adadelta_update
from pytorch_mnist_ddp_tpu.ops.loss import nll_loss as jax_nll
from pytorch_mnist_ddp_tpu.parallel import ddp as jax_ddp
from pytorch_mnist_ddp_tpu.utils import checkpoint as jax_ckpt
from pytorch_mnist_ddp_tpu_torch import vit_mnist
from pytorch_mnist_ddp_tpu_torch.models.vit import ViT, ViTConfig
from pytorch_mnist_ddp_tpu_torch.ops.adadelta import AdadeltaState, adadelta_init
from pytorch_mnist_ddp_tpu_torch.parallel.ddp import TrainState, make_forward_train_step
from pytorch_mnist_ddp_tpu_torch.parallel.zero import is_zero_state
from pytorch_mnist_ddp_tpu_torch.utils import checkpoint as ckpt
from pytorch_mnist_ddp_tpu_torch.utils.convert import (
    jax_vit_tree_from_torch,
    torch_vit_state_from_jax,
)
from test_torch_resume import _jax_patterns

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_VIT_MESSAGES = _jax_patterns(ROOT / "vit_mnist.py")[0]
K, BATCH = 3, 32
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_ATOL = 5e-3
LIMIT = 192  # 3 batches of 64 an epoch


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread in this module: the suite runs several workers
    at once, and their threads would otherwise contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches():
    images, labels = jax_mnist.synthetic_mnist("train", 2 * K * BATCH)
    xs = jax_normalize(images).reshape(2 * K, BATCH, 28, 28, 1)
    return xs, labels.astype(np.int64).reshape(2 * K, BATCH)


def _jax_step():
    cfg = jvit.ViTConfig()

    @jax.jit
    def step(state, x, y):
        def loss_fn(p):
            return jax_nll(jvit.vit_forward(p, x, cfg), y, jnp.ones(BATCH), reduction="mean")

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        params, opt = jax_adadelta_update(state.params, grads, state.opt, 1.0, 0.9, 1e-6)
        return state._replace(params=params, opt=opt, step=state.step + 1), loss

    return step


def _jax_steps(state, xs, ys):
    step, losses = _jax_step(), []
    for x, y in zip(xs, ys):
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y, jnp.int32))
        losses.append(float(loss))
    return state, np.asarray(losses)


def _port_steps(model, state, xs, ys):
    step = make_forward_train_step(lambda m, x: m(x))
    losses = [float(step(model, state, torch.from_numpy(x), torch.from_numpy(y),
                         torch.ones(BATCH), 1.0)) for x, y in zip(xs, ys)]
    return np.asarray(losses)


def _jax_state0():
    params = jax.device_get(jvit.init_vit_params(jax.random.PRNGKey(4), jvit.ViTConfig()))
    return jax_ddp.TrainState(params=params, opt=jax_adadelta_init(params), step=jnp.int32(0),
                              batch_stats=())


def _restored(path):
    """The archive through vit_mnist's restore: a model and its state."""
    archive, epoch = ckpt.load_vit_train_state(path)
    model = ViT(ViTConfig())
    opt = vit_mnist._restore(model, archive, path)
    return model, TrainState(opt=opt, step=archive.step), epoch


def test_jax_archive_continues_in_the_port(tmp_path):
    xs, ys = _batches()
    saved, _ = _jax_steps(_jax_state0(), xs[:K], ys[:K])
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_train_state(jax.device_get(saved), path, epoch=1)
    want_state, want_losses = _jax_steps(saved, xs[K:], ys[K:])
    model, state, epoch = _restored(path)
    assert (epoch, state.step) == (1, K)
    losses = _port_steps(model, state, xs[K:], ys[K:])
    assert state.step == 2 * K == int(want_state.step)
    np.testing.assert_allclose(losses, want_losses, **LOSS_TOL)
    for k, v in torch_vit_state_from_jax(jax.device_get(want_state.params)).items():
        np.testing.assert_allclose(model.state_dict()[k].numpy(), v.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def test_port_archive_continues_in_jax(tmp_path):
    xs, ys = _batches()
    model = ViT(ViTConfig())
    model.load_state_dict(torch_vit_state_from_jax(_jax_state0().params))
    state = TrainState(opt=adadelta_init(dict(model.named_parameters())))
    _port_steps(model, state, xs[:K], ys[:K])
    path = str(tmp_path / "port.npz")
    ckpt.save_vit_train_state(dict(model.named_parameters()), state.opt, state.step, path,
                              epoch=1)
    want_losses = _port_steps(model, state, xs[K:], ys[K:])
    loaded, epoch = jax_ckpt.load_train_state(path)
    assert (epoch, int(loaded.step)) == (1, K)
    ref = _jax_state0()
    assert jax.tree.structure(loaded.params) == jax.tree.structure(ref.params)
    assert jax.tree.structure(loaded.opt) == jax.tree.structure(ref.opt)
    jstate, losses = _jax_steps(loaded._replace(step=jnp.int32(loaded.step), batch_stats=()),
                                xs[K:], ys[K:])
    assert int(jstate.step) == 2 * K == state.step
    np.testing.assert_allclose(losses, want_losses, **LOSS_TOL)
    for k, v in torch_vit_state_from_jax(jax.device_get(jstate.params)).items():
        np.testing.assert_allclose(v.numpy(), model.state_dict()[k].numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def test_archive_round_trips_the_accumulators(tmp_path):
    model = ViT(ViTConfig(), generator=torch.Generator().manual_seed(1))
    params = dict(model.named_parameters())
    rng = np.random.RandomState(2)
    opt = AdadeltaState(*({k: torch.from_numpy(rng.rand(*p.shape).astype(np.float32))
                           for k, p in params.items()} for _ in range(2)))
    path = str(tmp_path / "s.npz")
    ckpt.save_vit_train_state(params, opt, 7, path, epoch=3)
    back, opt2, epoch = _restored(path)
    assert (epoch, opt2.step) == (3, 7)
    assert all(torch.equal(p, params[k]) for k, p in back.named_parameters())
    for got, want in zip(opt2.opt, opt):
        assert list(got) == list(params)  # named_parameters order
        assert all(torch.equal(got[k], want[k]) for k in want)
    with np.load(path) as f:  # the JAX layout: kernels [in, out], LayerNorm scale
        assert f["params.blocks.0.qkv.kernel"].shape == (64, 192)
        assert "opt.acc_delta.blocks.1.ln2.scale" in f.files and f["step"].dtype == np.int32


# -- the port's own continuation -----------------------------------------------


@pytest.fixture(scope="module")
def idx_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("idx")
    for split, prefix in (("train", "train"), ("test", "t10k")):
        images, labels = jax_mnist.synthetic_mnist(split, LIMIT)
        (root / f"{prefix}-images-idx3-ubyte").write_bytes(
            struct.pack(">iiii", 2051, *images.shape) + images.tobytes())
        (root / f"{prefix}-labels-idx1-ubyte").write_bytes(
            struct.pack(">ii", 2049, len(labels)) + labels.tobytes())
    return root


def _fit(idx_root, *flags):
    args = vit_mnist.build_parser().parse_args(["--data-root", str(idx_root), "--log-interval",
                                                "1", *flags])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        model, state = vit_mnist.fit(args, vit_mnist.resolve_mode_flags(args), "cpu")
    return model, state, out.getvalue()


def _assert_same(a, b):
    (ma, sa), (mb, sb) = a[:2], b[:2]
    assert sa.step == sb.step
    for (ka, pa), (kb, pb) in zip(ma.named_parameters(), mb.named_parameters(), strict=True):
        assert ka == kb and torch.equal(pa, pb), ka
    assert is_zero_state(sa.opt) == is_zero_state(sb.opt)
    for ta, tb in zip(sa.opt, sb.opt):
        if isinstance(ta, dict):
            assert all(torch.equal(ta[k], tb[k]) for k in ta)
        else:
            assert torch.equal(ta, tb)


MODES = {"plain": [], "flash": ["--flash"], "sp1": ["--sp", "1", "--allow-degree-1"],
         "zero": ["--zero"]}


@pytest.mark.parametrize("mode", list(MODES))
def test_save_state_then_resume_state_equals_the_uninterrupted_run(tmp_path, idx_root, mode):
    flags = MODES[mode]
    path = str(tmp_path / "s.npz")
    full = _fit(idx_root, "--epochs", "2", *flags)
    _fit(idx_root, "--epochs", "1", "--save-state", path, *flags)
    resumed = _fit(idx_root, "--epochs", "1", "--resume-state", path, *flags)
    assert "Train Epoch: 2 " in resumed[2] and "Train Epoch: 1 " not in resumed[2]
    assert resumed[2].count("Test set:") == 1
    _assert_same(full, resumed)
    assert resumed[1].step == 2 * LIMIT // 64
    # the resumed run's lines are the uninterrupted run's epoch 2
    assert resumed[2] in full[2]


@pytest.mark.parametrize("saved,resumed", [(["--zero"], []), ([], ["--zero"])],
                         ids=["zero_to_plain", "plain_to_zero"])
def test_zero_and_plain_archives_cross(tmp_path, idx_root, saved, resumed):
    """Archives are per leaf under --zero too: resumed in the other mode
    they end on the bits of the same mode's own continuation."""
    path, own = str(tmp_path / "s.npz"), str(tmp_path / "own.npz")
    _fit(idx_root, "--epochs", "1", "--save-state", path, *saved)
    _fit(idx_root, "--epochs", "1", "--save-state", own, *resumed)
    with np.load(path) as a, np.load(own) as b:  # per leaf: the same files
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)
    other = _fit(idx_root, "--epochs", "1", "--resume-state", path, *resumed)
    same = _fit(idx_root, "--epochs", "1", "--resume-state", own, *resumed)
    _assert_same(same, other)


# -- refusals -------------------------------------------------------------------


def _refusal(idx_root, *flags) -> str:
    with pytest.raises(SystemExit) as err:
        _fit(idx_root, *flags)
    message = str(err.value)
    assert any(p.fullmatch(message) for p in JAX_VIT_MESSAGES), message
    return message


@pytest.mark.parametrize("flags", [
    ["--tp", "2", "--save-state", "s.npz"], ["--pp", "--resume-state", "s.npz"],
    ["--experts", "8", "--save-state", "s.npz"], ["--save-state", "s.npz", "--dry-run"],
    ["--resume", "m.npz", "--resume-state", "s.npz"],
], ids=["tp", "pp", "experts", "dry_run", "with_resume"])
def test_flag_refusals_are_the_jax_texts(idx_root, flags):
    _refusal(idx_root, *flags)


def test_cnn_archive_holds_a_different_tree(tmp_path, idx_root):
    from pytorch_mnist_ddp_tpu_torch.models.net import Net

    net = Net(torch.Generator().manual_seed(0))
    params = dict(net.named_parameters())
    path = str(tmp_path / "cnn.npz")
    ckpt.save_train_state(params, AdadeltaState(*(dict(params) for _ in range(2))), 4, path)
    message = _refusal(idx_root, "--resume-state", path)
    assert "holds a different model's parameter tree" in message


def test_another_width_is_the_jax_shape_text(tmp_path, idx_root):
    model = ViT(ViTConfig())
    params = dict(model.named_parameters())
    path = str(tmp_path / "s.npz")
    ckpt.save_vit_train_state(params, adadelta_init(params), 0, path)
    message = _refusal(idx_root, "--resume-state", path, "--dim", "32")
    assert message.startswith("--resume-state param shape")
    # and jax_vit_tree_from_torch is what the JAX CLI's tree holds
    assert jax.tree.structure(jax_vit_tree_from_torch(model.state_dict())) == jax.tree.structure(
        jax.device_get(jvit.init_vit_params(jax.random.PRNGKey(0), jvit.ViTConfig())))
