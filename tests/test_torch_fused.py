"""The port's fused path (``parallel/fused.py``, ``--fused``) held against
the JAX package's ``parallel/fused.py`` and against the port's own
per-batch run, on the CPU.

- The fused epoch, given JAX's permutation (``jax.random.permutation(
  jax.random.fold_in(shuffle_key, epoch), n)``) and dropout off, against
  ``make_fused_train_epoch`` (plain and ``--pallas-opt``, the delta
  kernel's plain version against JAX's kernel in interpret mode) and
  against ``make_fused_run(zero=True)`` (``--zero``), on one device and
  on two gloo ranks against JAX's two-device mesh, within the trajectory
  gates of ``tests/test_torch_ddp.py::test_dp_trajectory_matches_jax_mesh``
  (losses rtol 2e-4 / atol 2e-5, parameters atol 5e-3).  112 rows at
  batch 32 leave a wrap-filled final batch.
- The fused eval's totals against ``make_fused_eval``: ``correct`` equal,
  ``loss_sum`` within 1e-5 relative.
- ``fit(--fused)`` in a world of one ``torch.equal`` to the per-batch
  ``fit()`` (parameters, accumulators, step) with the same printed lines,
  on a set that does not divide into batches and on one that does, with
  ``--pregather``, ``--zero``, a ``--resume-state`` continuation.
- The JAX trainer's three refusals, in its words.

One intra-op thread: the gloo ranks and the xdist workers share the box.
"""

from __future__ import annotations

import contextlib
import functools
import io
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu.data import mnist as jax_mnist
from pytorch_mnist_ddp_tpu.data.transforms import normalize as jax_normalize
from pytorch_mnist_ddp_tpu.models.net import init_params
from pytorch_mnist_ddp_tpu.parallel import ddp as jax_ddp
from pytorch_mnist_ddp_tpu.parallel import fused as jax_fused
from pytorch_mnist_ddp_tpu.parallel.mesh import make_mesh
from pytorch_mnist_ddp_tpu.parallel.zero import make_zero_train_state
from pytorch_mnist_ddp_tpu_torch.data.loader import DataLoader
from pytorch_mnist_ddp_tpu_torch.mnist_ddp import build_parser
from pytorch_mnist_ddp_tpu_torch.models.net import Net
from pytorch_mnist_ddp_tpu_torch.ops import adadelta_flat
from pytorch_mnist_ddp_tpu_torch.parallel import fused
from pytorch_mnist_ddp_tpu_torch.parallel.ddp import make_train_state
from pytorch_mnist_ddp_tpu_torch.trainer import fit
from pytorch_mnist_ddp_tpu_torch.utils import checkpoint as ckpt
from pytorch_mnist_ddp_tpu_torch.utils.convert import torch_state_from_jax
from test_torch_family_ranks import fused_epoch_ranks
from test_torch_launch import run_world
from test_torch_resume import assert_jax_text

N, N_TEST, BATCH, EPOCH = 112, 100, 32, 3  # 4 steps, the last with 16 real rows
SHUFFLE = jax.random.PRNGKey(5)
LOSS_RTOL, LOSS_ATOL, PARAM_ATOL = 2e-4, 2e-5, 5e-3
LIMIT = 136  # fit(): 5 steps of 32, a wrap-filled last one
RUNS = (("plain", False, False), ("pallas_opt", True, False), ("zero", False, True))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data():
    tr = jax_mnist.synthetic_mnist("train", N)
    te = jax_mnist.synthetic_mnist("test", N_TEST)
    return tr, te


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(init_params(jax.random.PRNGKey(11)))


def _perm(n: int = N, epoch: int = EPOCH) -> np.ndarray:
    return np.asarray(jax.random.permutation(jax.random.fold_in(SHUFFLE, epoch), n))


def _port_model(jax_params) -> Net:
    model = Net()
    model.load_state_dict(torch_state_from_jax(jax_params))
    return model


def _jax_epoch(params, data, run: str, devices: int):
    """JAX's fused epoch (``make_fused_run`` for ``--zero``) from
    ``params``: the losses [steps, devices] and the parameters in torch's
    layout."""
    (images, labels), (te_images, te_labels) = data
    mesh = make_mesh(num_data=devices, devices=jax.devices()[:devices])
    x, y = jax_fused.device_put_dataset(images, labels, mesh)
    if run == "zero":
        ex, ey = jax_fused.device_put_dataset(te_images, te_labels, mesh)
        run_fn, _ = jax_fused.make_fused_run(mesh, N, N_TEST, BATCH * devices, BATCH, 1,
                                             dropout=False, zero=True, start_epoch=EPOCH)
        state, losses, _ = run_fn(make_zero_train_state(params, mesh), x, y, ex, ey, SHUFFLE,
                                  jax.random.PRNGKey(6), jnp.asarray([1.0], jnp.float32))
        losses = losses[0]
    else:
        pallas = run == "pallas_opt"
        epoch_fn, _ = jax_fused.make_fused_train_epoch(mesh, N, BATCH * devices, dropout=False,
                                                       use_pallas=pallas)
        state = jax_ddp.replicate_params(jax_ddp.make_train_state(params, use_pallas=pallas),
                                         mesh)
        state, losses = epoch_fn(state, x, y, jnp.int32(EPOCH), SHUFFLE, jax.random.PRNGKey(6),
                                 jnp.float32(1.0))
    return np.asarray(losses), torch_state_from_jax(jax.device_get(state.params))


def _hold(losses: np.ndarray, params: dict, want_losses: np.ndarray, want_params: dict):
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    for k, want in want_params.items():
        np.testing.assert_allclose(np.asarray(params[k]), want.numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


# -- the device-side input ---------------------------------------------------

def test_normalize_dev_is_the_host_normalize_bit_for_bit():
    images = np.random.RandomState(0).randint(0, 256, (64, 28, 28)).astype(np.uint8)
    images[0] = np.arange(256).repeat(4)[:784].reshape(28, 28)  # every value
    got = fused.normalize_dev(torch.from_numpy(images))
    loader_x = next(iter(DataLoader(images, np.zeros(64), 64, "cpu", shuffle=False).epoch(0)))[0]
    assert got.dtype == torch.float32 and tuple(got.shape) == (64, 28, 28, 1)
    assert np.array_equal(got.numpy(), jax_normalize(images))
    assert got.stride() == loader_x.stride()  # the convolutions' order follows the layout


@pytest.mark.parametrize("world_size,shard,mask", [(1, None, False), (3, None, False),
                                                   (3, None, True), (1, 1, False)],
                         ids=["one", "rank_strided", "masked_padding", "shards"])
def test_index_table_lays_out_the_loaders_batches(world_size, shard, mask):
    """Each row of ``index_table`` is the batch ``epoch()`` yields (the
    rank's sampler rows, or a shard's slice of the global batches), and
    the wrap-filled rows of the last batch weigh 0."""
    images, labels = jax_mnist.synthetic_mnist("train", 203)
    kw = ({"rank": world_size - 1, "world_size": world_size} if shard is None
          else {"shard": shard, "num_shards": 2})
    loader = DataLoader(images, labels, 24, "cpu", seed=4, mask_padding=mask, **kw)
    idx, w = loader.index_table(2)
    batches = list(loader.epoch(2))
    assert idx.shape == w.shape == (len(batches), 24)
    for (x, y, wb), row, wrow in zip(batches, idx, w):
        real = wb.numpy() > 0
        assert np.array_equal(wrow, wb.numpy())
        assert np.array_equal(x.numpy()[real], jax_normalize(images[row[real]]))
        assert np.array_equal(y.numpy()[real], labels[row[real]])
    assert (w[-1] == 0).any()


def test_perm_table_is_jax_fused_layout():
    """JAX's ``_epoch_scan_builder``: step b, shard s takes rows
    ``b * global_batch + s * shard_batch`` onward of the wrapped permutation."""
    perm = _perm()
    for shard in (0, 1):
        idx, w = fused.perm_table(perm, BATCH, shard, 2)
        assert idx.shape == (2, BATCH)
        pos = np.arange(2)[:, None] * 2 * BATCH + shard * BATCH + np.arange(BATCH)
        assert np.array_equal(idx, perm[pos % N]) and np.array_equal(w, pos < N)


# -- against JAX's fused epoch and eval --------------------------------------

@pytest.mark.parametrize("run", ["plain", "pallas_opt", "zero"])
def test_fused_epoch_matches_jax_on_its_permutation(jax_params, data, run, monkeypatch):
    monkeypatch.setenv("TPU_MNIST_PALLAS_INTERPRET", "1")
    want_losses, want_params = _jax_epoch(jax_params, data, run, 1)
    (images, labels), _ = data
    model = _port_model(jax_params)
    state = make_train_state(model, use_pallas=run == "pallas_opt", zero=run == "zero")
    epoch = fused.FusedEpoch(model, state, DataLoader(images, labels, BATCH, "cpu"),
                             dropout=False, use_pallas=run == "pallas_opt")
    before = dict(adadelta_flat.LAUNCHES)
    losses = epoch.epoch(EPOCH, 1.0, perm=_perm())
    assert adadelta_flat.LAUNCHES == before  # the CPU runs the plain version
    assert state.step == epoch.num_batches == 4 and epoch.eager_steps == 4
    assert epoch.graph is None and epoch.replays == 0
    _hold(losses.numpy(), {k: v.detach() for k, v in model.state_dict().items()},
          want_losses, want_params)
    assert losses[-1, 0] < losses[0, 0]


def test_fused_eval_totals_match_jax(jax_params, data):
    _, (images, labels) = data
    mesh = make_mesh(num_data=1, devices=jax.devices()[:1])
    ex, ey = jax_fused.device_put_dataset(images, labels, mesh)
    want = np.asarray(jax_fused.make_fused_eval(mesh, N_TEST, BATCH)(jax_params, ex, ey))
    loader = DataLoader(images, labels, BATCH, "cpu", shuffle=False, mask_padding=True)
    table = fused.FusedEval(loader)(_port_model(jax_params))
    assert tuple(table.shape) == (4, 2)
    loss_sum, correct = fused.eval_totals(table.numpy())
    assert correct == want[1]
    np.testing.assert_allclose(loss_sum, want[0], rtol=1e-5)


def test_two_gloo_ranks_match_jax_two_device_fused_epoch(jax_params, data, tmp_path,
                                                         monkeypatch):
    monkeypatch.setenv("TPU_MNIST_PALLAS_INTERPRET", "1")
    (images, labels), _ = data
    state = {k: v.numpy() for k, v in torch_state_from_jax(jax_params).items()}
    ranks = run_world(fused_epoch_ranks, 2, tmp_path, state, images, labels, _perm(), BATCH,
                      EPOCH, RUNS[:1])
    for name, _, _ in RUNS[:1]:
        want_losses, want_params = _jax_epoch(jax_params, data, name, 2)
        got = [r[name] for r in ranks]
        assert np.array_equal(got[0]["losses"], got[1]["losses"])  # gathered on every rank
        assert got[0]["losses"].shape == (2, 2) and got[0]["step"] == 2
        assert all(torch.equal(got[0]["state"][k], got[1]["state"][k]) for k in state)
        _hold(got[0]["losses"], got[0]["state"], want_losses, want_params)


# -- against the port's per-batch run ----------------------------------------

@pytest.fixture(scope="module")
def idx_root(tmp_path_factory):
    """The first LIMIT rows of the synthetic sets as IDX files."""
    root = tmp_path_factory.mktemp("idx")
    for split, prefix in (("train", "train"), ("test", "t10k")):
        images, labels = jax_mnist.synthetic_mnist(split, LIMIT)
        (root / f"{prefix}-images-idx3-ubyte").write_bytes(
            struct.pack(">iiii", 2051, *images.shape) + images.tobytes())
        (root / f"{prefix}-labels-idx1-ubyte").write_bytes(
            struct.pack(">ii", 2049, len(labels)) + labels.tobytes())
    return root


@pytest.fixture(autouse=True)
def _idx_dir(monkeypatch, idx_root):
    monkeypatch.setenv("MNIST_DATA_DIR", str(idx_root))


def _fit(*flags, timings: dict | None = None):
    args = build_parser().parse_args(["--batch-size", str(BATCH), "--test-batch-size", "64",
                                      "--log-interval", "2", "--epochs", "2", *flags])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        model, state = fit(args, "cpu", timings=timings)
    return model, state, out.getvalue()


@functools.cache
def _per_batch(*flags):
    """The per-batch run the fused runs are held to (not mutated after)."""
    return _fit(*flags)


def _assert_same(a, b) -> None:
    (ma, sa, out_a), (mb, sb, out_b) = a, b
    assert out_a == out_b and out_a.count("Test set:") == 2
    assert sa.step == sb.step
    for (ka, ta), (kb, tb) in zip(ma.state_dict().items(), mb.state_dict().items(), strict=True):
        assert ka == kb and torch.equal(ta, tb), ka
    assert type(sa.opt) is type(sb.opt)
    for x, y in zip(sa.opt, sb.opt):
        if isinstance(x, dict):
            assert all(torch.equal(x[k], y[k]) for k in x)
        else:
            assert torch.equal(x, y)


@pytest.mark.parametrize(
    "flags",
    [[], ["--pallas-opt"], ["--train-limit", "128"], ["--zero"], ["--syncbn"],
     ["--bf16", "--conv-impl", "im2col"]],
    ids=["plain_wrap_fill", "pallas_opt", "divisible", "zero", "syncbn", "bf16_im2col"],
)
def test_fused_fit_equals_per_batch_fit(flags):
    timings = {}
    got = _fit("--fused", *flags, timings=timings)
    _assert_same(got, _per_batch(*flags))
    steps = -(-int(flags[1] if "--train-limit" in flags else LIMIT) // BATCH)
    assert got[1].step == 2 * steps and timings["epoch_steps"] == [steps, steps]
    assert timings["host_syncs"] == 2 and timings["replays"] == 0


def test_pregather_equals_gather():
    _assert_same(_fit("--fused", "--pregather", "--pallas-opt"), _fit("--fused", "--pallas-opt"))


def test_fused_continues_a_resumed_run(tmp_path):
    """A final archive resumed under ``--fused`` ends on the uninterrupted
    per-batch run's bits, its lines those of that run's second epoch."""
    path = str(tmp_path / "s.npz")
    first = _fit("--pallas-opt", "--epochs", "1", "--save-state", path)
    resumed = _fit("--fused", "--pallas-opt", "--epochs", "1", "--resume-state", path)
    whole = _per_batch("--pallas-opt")
    assert first[2] + resumed[2] == whole[2]
    _assert_same(resumed[:2] + (whole[2],), whole)


def test_dry_run_stays_on_the_per_batch_loop():
    timings = {}
    _, state, out = _fit("--fused", "--dry-run", "--epochs", "1", timings=timings)
    assert state.step == 1 and "host_syncs" not in timings and "Test set:" in out


# -- the JAX trainer's refusals ----------------------------------------------

def _refusal(*flags) -> str:
    with pytest.raises(ValueError) as err:
        _fit(*flags)
    assert_jax_text(str(err.value))
    return str(err.value)


def test_fused_refuses_a_mid_epoch_archive(tmp_path):
    path = str(tmp_path / "mid.npz")
    model = Net()
    params = dict(model.named_parameters())
    ckpt.save_train_state(params, make_train_state(model).opt, 3, path,
                          extras={"epoch_in_progress": 1, "batch_cursor": 3, "seed": 1})
    assert "MID-EPOCH" in _refusal("--fused", "--resume-state", path)


@pytest.mark.parametrize("flags", [["--tp", "2"], ["--pp"]], ids=["tp", "pp"])
def test_fused_refuses_the_model_axis(flags):
    assert _refusal("--fused", *flags) == "--fused is data-parallel only; drop it for --tp/--pp"


def test_pregather_needs_fused():
    assert _refusal("--pregather") == "--pregather is the fused input path; add --fused"
