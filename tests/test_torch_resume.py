"""``--resume``, ``--save-state`` and ``--resume-state`` of the port held
against the JAX package on the CPU.

Layouts cross bit for bit: the parameter converters round-trip, the JAX
package's padded ``[rows, 128]`` ``--pallas-opt`` accumulators round-trip
through the port's unpadded flat buffer with their zero pad, per-leaf
accumulator trees round-trip, and the port's ``ensure_opt_layout`` gives
JAX's values in the port's order.

Archives cross both ways.  A state after k = 4 steps (function-level
steps on a one-device mesh, dropout off) is saved by one package and
continued for k more steps by the other, while the saving package takes
the same k steps from memory: losses and parameters agree within the
gates of ``test_torch_train.py::test_trajectory_matches_jax`` (losses
rtol 2e-4 / atol 2e-5, parameters atol 5e-3; the two frameworks' conv
backwards differ in the last ulp), and ``step`` is 2k.

The port's own continuation is exact (``torch.equal``): one epoch and
``--save-state``, then ``--resume-state`` and one more, equals two epochs
uninterrupted, dropout on, plain and ``--pallas-opt``; from a mid-epoch
archive too.  Refusals carry the JAX package's text, read from its source.
"""

from __future__ import annotations

import ast
import contextlib
import io
import pathlib
import re
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu.data import mnist as jax_mnist
from pytorch_mnist_ddp_tpu.data.transforms import normalize as jax_normalize
from pytorch_mnist_ddp_tpu.models.net import init_params
from pytorch_mnist_ddp_tpu.ops import pallas_adadelta as jax_pa
from pytorch_mnist_ddp_tpu.ops.adadelta import AdadeltaState as JaxAdadeltaState
from pytorch_mnist_ddp_tpu.parallel import ddp as jax_ddp
from pytorch_mnist_ddp_tpu.parallel.mesh import make_mesh
from pytorch_mnist_ddp_tpu.utils import checkpoint as jax_ckpt
from pytorch_mnist_ddp_tpu_torch.data.loader import DataLoader
from pytorch_mnist_ddp_tpu_torch.mnist import build_parser
from pytorch_mnist_ddp_tpu_torch.models.net import Net
from pytorch_mnist_ddp_tpu_torch.ops import adadelta_flat
from pytorch_mnist_ddp_tpu_torch.ops.adadelta import AdadeltaState
from pytorch_mnist_ddp_tpu_torch.ops.adadelta_flat import (
    FlatAdadeltaState,
    _ravel,
    ensure_opt_layout,
)
from pytorch_mnist_ddp_tpu_torch.ops.schedule import step_lr
from pytorch_mnist_ddp_tpu_torch.parallel.ddp import (
    TrainState,
    make_train_state,
    make_train_step,
)
from pytorch_mnist_ddp_tpu_torch.trainer import fit, make_loaders
from pytorch_mnist_ddp_tpu_torch.utils import checkpoint as ckpt
from pytorch_mnist_ddp_tpu_torch.utils.convert import (
    TORCH_SHAPES,
    jax_flat_from_torch,
    jax_state_from_torch,
    pad_rows,
    torch_flat_from_jax,
    torch_state_from_jax,
)
from pytorch_mnist_ddp_tpu_torch.utils.rng import split_streams

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_TRAINER = ROOT / "pytorch_mnist_ddp_tpu" / "trainer.py"
JAX_CHECKPOINT = ROOT / "pytorch_mnist_ddp_tpu" / "utils" / "checkpoint.py"
K, BATCH = 4, 64
N_PARAMS = 1_199_882
W = np.ones(BATCH, np.float32)


# -- the JAX package's messages, read from its source ----------------------

def _jax_patterns(path: pathlib.Path) -> tuple[list[re.Pattern], list[re.Pattern]]:
    """Every string literal of ``path`` (adjacent literals joined, as the
    parser joins them) as a regex, an f-string's fields matching any text;
    and each one's first sentence (up to the first ".  ")."""
    whole, heads = [], []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            values = [node]
        elif isinstance(node, ast.JoinedStr):
            values = node.values
        else:
            continue
        parts, head = [], None
        for v in values:
            if isinstance(v, ast.Constant):
                if head is None and ".  " in v.value:
                    head = "".join(parts) + re.escape(v.value.split(".  ")[0] + ".")
                parts.append(re.escape(v.value))
            else:
                parts.append(".+?")
        whole.append(re.compile("".join(parts), re.S))
        if head is not None:
            heads.append(re.compile(head, re.S))
    return whole, heads


JAX_MESSAGES, JAX_FIRST_SENTENCES = (
    a + b for a, b in zip(_jax_patterns(JAX_TRAINER), _jax_patterns(JAX_CHECKPOINT)))


def assert_jax_text(message: str, first_sentence: bool = False) -> None:
    """``message`` is one of the JAX trainer's or checkpoint module's
    messages with its fields filled in; with ``first_sentence``, its first
    sentence is the first sentence of one of them (the port goes on in its
    own words)."""
    if first_sentence:
        head = message.split(".  ")[0] + "."
        ok = any(p.fullmatch(head) for p in JAX_FIRST_SENTENCES)
    else:
        ok = any(p.fullmatch(message) for p in JAX_MESSAGES)
    assert ok, f"not the JAX trainer's text: {message!r}"


# -- layouts ---------------------------------------------------------------

def _random_jax_tree(seed: int) -> dict:
    """A JAX-layout CNN tree of random float32 values."""
    rng = np.random.RandomState(seed)
    tree = jax.device_get(init_params(jax.random.PRNGKey(seed)))
    return {layer: {leaf: rng.randn(*v.shape).astype(np.float32) for leaf, v in leaves.items()}
            for layer, leaves in tree.items()}


def _jax_flat(tree: dict) -> np.ndarray:
    """JAX's own per-leaf -> padded-flat conversion of ``tree``."""
    per_leaf = JaxAdadeltaState(square_avg=tree, acc_delta=tree)
    params = jax.device_get(init_params(jax.random.PRNGKey(0)))
    flat = jax_pa.ensure_opt_layout(per_leaf, params, True)
    return np.asarray(flat.square_avg)


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's flat layout on the CPU (its kernel interpreted)."""
    monkeypatch.setenv("TPU_MNIST_PALLAS_INTERPRET", "1")


@pytest.mark.parametrize("seed", [0, 1])
def test_param_converters_are_inverse(seed):
    tree = _random_jax_tree(seed)
    back = jax_state_from_torch(torch_state_from_jax(tree))
    assert sorted(back) == sorted(tree)
    for layer in tree:
        for leaf in ("kernel", "bias"):
            assert back[layer][leaf].dtype == np.float32
            assert back[layer][leaf].tobytes() == tree[layer][leaf].tobytes(), (layer, leaf)
    state = Net(torch.Generator().manual_seed(seed)).state_dict()
    again = torch_state_from_jax(jax_state_from_torch(state))
    assert list(again) == list(state)
    assert all(torch.equal(again[k], state[k]) for k in state)


def test_pad_rows_is_jax_pad_rows():
    for n in (1, 127, 128, 1000, 32768, 32769, 100_000, N_PARAMS):
        assert pad_rows(n) == jax_pa._pad_rows(n), n
    assert pad_rows(N_PARAMS) == (9472, 256)


def test_flat_buffer_round_trip_is_byte_equal(interpret):
    """JAX's flat buffer -> the port's -> JAX's again, pad included."""
    buf = _jax_flat(_random_jax_tree(2))
    assert buf.shape == (9472, 128) and buf.dtype == np.float32
    assert not buf.reshape(-1)[N_PARAMS:].any()  # JAX's pad holds zeros
    port = torch_flat_from_jax(buf)
    assert port.shape == (N_PARAMS,) and port.dtype == torch.float32
    assert jax_flat_from_torch(port).tobytes() == buf.tobytes()


def test_per_leaf_tree_round_trip_is_byte_equal():
    tree = _random_jax_tree(3)
    port = torch_state_from_jax(tree)
    assert list(port) == list(TORCH_SHAPES)
    assert {k: tuple(v.shape) for k, v in port.items()} == TORCH_SHAPES
    back = jax_state_from_torch(port)
    for layer in tree:
        for leaf in tree[layer]:
            assert back[layer][leaf].tobytes() == tree[layer][leaf].tobytes()


def test_flat_conversion_is_the_ravel_of_the_converted_tree(interpret):
    """One accumulator two ways: flat-converted, and per-leaf converted then
    raveled in ``named_parameters`` order.  An off-by-one-leaf split would
    still run and still learn; only this finds it."""
    tree = _random_jax_tree(4)
    got = torch_flat_from_jax(_jax_flat(tree))
    want = _ravel(torch_state_from_jax(tree))
    assert torch.equal(got, want)


def test_flat_converter_refuses_other_sizes():
    with pytest.raises(ValueError, match="pad to 9472"):
        torch_flat_from_jax(np.zeros((9471, 128), np.float32))
    with pytest.raises(ValueError, match="elements"):
        jax_flat_from_torch(torch.zeros(N_PARAMS - 1))


@pytest.mark.parametrize("to_flat", [True, False], ids=["to_flat", "to_per_leaf"])
def test_ensure_opt_layout_agrees_with_jax(interpret, to_flat):
    sq, ac = _random_jax_tree(5), _random_jax_tree(6)
    params = jax.device_get(init_params(jax.random.PRNGKey(0)))
    jax_per_leaf = JaxAdadeltaState(square_avg=sq, acc_delta=ac)
    jax_flat = jax_pa.ensure_opt_layout(jax_per_leaf, params, True)
    net_params = dict(Net().named_parameters())
    if to_flat:
        src = AdadeltaState(torch_state_from_jax(sq), torch_state_from_jax(ac))
        got = ensure_opt_layout(src, net_params, True)
        assert isinstance(got, FlatAdadeltaState)
        for mine, theirs in zip(got, jax_flat):
            assert torch.equal(mine, torch_flat_from_jax(np.asarray(theirs)))
    else:
        src = FlatAdadeltaState(*(torch_flat_from_jax(np.asarray(t)) for t in jax_flat))
        got = ensure_opt_layout(src, net_params, False)
        assert isinstance(got, AdadeltaState)
        back = jax_pa.ensure_opt_layout(jax.device_get(jax_flat), params, False)
        for mine, theirs in zip(got, back):
            want = torch_state_from_jax(jax.device_get(theirs))
            assert list(mine) == list(want)
            assert all(torch.equal(mine[k], want[k]) for k in want)
    assert ensure_opt_layout(got, net_params, to_flat) is got  # already in place


# -- archives across the packages -------------------------------------------

@pytest.fixture(scope="module")
def batches():
    images, labels = jax_mnist.synthetic_mnist("train", 2 * K * BATCH)
    xs = jax_normalize(images).reshape(2 * K, BATCH, 28, 28, 1)
    ys = labels.astype(np.int64).reshape(2 * K, BATCH)
    return xs, ys


def _jax_steps(step, state, xs, ys):
    losses = []
    for x, y in zip(xs, ys):
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y, jnp.int32), jnp.asarray(W),
                           jax.random.PRNGKey(0), jnp.float32(1.0))
        losses.append(float(loss[0]))
    return state, losses


def _port_steps(step, net, state, xs, ys):
    return [float(step(net, state, torch.tensor(x), torch.tensor(y), torch.tensor(W), 1.0))
            for x, y in zip(xs, ys)]


def _assert_close(losses, want_losses, net, want_params):
    np.testing.assert_allclose(losses, want_losses, rtol=2e-4, atol=2e-5)
    want = torch_state_from_jax(jax.device_get(want_params))
    got = net.state_dict()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=5e-3,
                                   err_msg=k)


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "per_leaf"])
def test_jax_archive_resumes_in_the_port(tmp_path, monkeypatch, batches, flat):
    if flat:
        monkeypatch.setenv("TPU_MNIST_PALLAS_INTERPRET", "1")
    xs, ys = batches
    mesh = make_mesh(num_data=1, devices=jax.devices()[:1])
    jstep = jax_ddp.make_train_step(mesh, dropout=False, use_pallas=flat)
    jstate = jax_ddp.replicate_params(
        jax_ddp.make_train_state(jax.device_get(init_params(jax.random.PRNGKey(7))),
                                 use_pallas=flat), mesh)
    jstate, _ = _jax_steps(jstep, jstate, xs[:K], ys[:K])
    path = str(tmp_path / "jax_state.npz")
    jax_ckpt.save_train_state(jax.device_get(jstate), path, epoch=1)
    jstate, jlosses = _jax_steps(jstep, jstate, xs[K:], ys[K:])

    archive, epoch, extras = ckpt.load_train_state_full(path)
    assert (epoch, extras, archive.step) == (1, {}, K)
    assert isinstance(archive.opt, FlatAdadeltaState if flat else AdadeltaState)
    net = Net()
    net.load_state_dict(archive.params)
    state = TrainState(opt=ensure_opt_layout(archive.opt, dict(net.named_parameters()), flat),
                       step=archive.step)
    losses = _port_steps(make_train_step(dropout=False, use_pallas=flat), net, state,
                         xs[K:], ys[K:])
    assert state.step == 2 * K == int(jstate.step)
    _assert_close(losses, jlosses, net, jstate.params)


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "per_leaf"])
def test_port_archive_resumes_in_jax(tmp_path, monkeypatch, batches, flat):
    if flat:
        monkeypatch.setenv("TPU_MNIST_PALLAS_INTERPRET", "1")
    xs, ys = batches
    net = Net()
    net.load_state_dict(torch_state_from_jax(
        jax.device_get(init_params(jax.random.PRNGKey(8)))))
    state = make_train_state(net, use_pallas=flat)
    step = make_train_step(dropout=False, use_pallas=flat)
    _port_steps(step, net, state, xs[:K], ys[:K])
    path = str(tmp_path / "port_state.npz")
    ckpt.save_train_state(dict(net.named_parameters()), state.opt, state.step, path, epoch=1)

    with np.load(path) as raw:  # the JAX package's keys and dtypes
        assert raw["step"].dtype == np.int32 and raw["epoch"].dtype == np.int64
        if flat:
            assert raw["opt_flat.square_avg"].shape == (9472, 128)
        else:
            assert raw["opt.acc_delta.fc1.kernel"].shape == (9216, 128)
    jstate, epoch, extras = jax_ckpt.load_train_state_full(path)
    assert (epoch, extras, int(jstate.step)) == (1, {}, K)
    assert jax_pa.is_flat_state(jstate.opt) == flat
    mesh = make_mesh(num_data=1, devices=jax.devices()[:1])
    jstate = jax_ddp.replicate_params(jstate._replace(
        opt=jax_pa.ensure_opt_layout(jstate.opt, jstate.params, flat)), mesh)
    jstep = jax_ddp.make_train_step(mesh, dropout=False, use_pallas=flat)
    jstate, jlosses = _jax_steps(jstep, jstate, xs[K:], ys[K:])

    losses = _port_steps(step, net, state, xs[K:], ys[K:])
    assert int(jstate.step) == 2 * K == state.step
    _assert_close(losses, jlosses, net, jstate.params)


# -- the port's own continuation ------------------------------------------

LIMIT = 320  # 5 batches of 64 an epoch


@pytest.fixture(scope="module")
def idx_root(tmp_path_factory):
    """The first LIMIT samples of the synthetic sets as IDX files, so each
    run reads them instead of building the 60k set."""
    root = tmp_path_factory.mktemp("idx")
    for split, prefix in (("train", "train"), ("test", "t10k")):
        images, labels = jax_mnist.synthetic_mnist(split, LIMIT)
        (root / f"{prefix}-images-idx3-ubyte").write_bytes(
            struct.pack(">iiii", 2051, *images.shape) + images.tobytes())
        (root / f"{prefix}-labels-idx1-ubyte").write_bytes(
            struct.pack(">ii", 2049, len(labels)) + labels.tobytes())
    return root


def _args(*flags):
    return build_parser().parse_args(["--train-limit", str(LIMIT), "--log-interval", "1",
                                      *flags])


def _fit(args):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        model, state = fit(args, "cpu")
    return model, state, out.getvalue()


def _assert_same_run(a, b):
    (ma, sa), (mb, sb) = a, b
    assert sa.step == sb.step
    for (ka, pa), (kb, pb) in zip(ma.named_parameters(), mb.named_parameters(), strict=True):
        assert ka == kb and torch.equal(pa, pb), ka
    assert type(sa.opt) is type(sb.opt)
    if isinstance(sa.opt, FlatAdadeltaState):
        assert all(torch.equal(x, y) for x, y in zip(sa.opt, sb.opt))
    else:
        for ta, tb in zip(sa.opt, sb.opt):
            assert all(torch.equal(ta[k], tb[k]) for k in ta)


@pytest.fixture(autouse=True)
def _idx_dir(monkeypatch, idx_root):
    monkeypatch.setenv("MNIST_DATA_DIR", str(idx_root))


@pytest.mark.parametrize("flags", [[], ["--pallas-opt"]], ids=["plain", "pallas_opt"])
def test_save_state_then_resume_state_equals_the_uninterrupted_run(tmp_path, flags):
    path = str(tmp_path / "s.npz")
    full = _fit(_args("--epochs", "2", *flags))
    _fit(_args("--epochs", "1", "--save-state", path, *flags))
    model, state, out = _fit(_args("--epochs", "1", "--resume-state", path, *flags))
    assert "Train Epoch: 2 " in out and "Train Epoch: 1 " not in out
    assert out.count("Test set:") == 1
    assert adadelta_flat.is_flat_state(state.opt) == bool(flags)
    _assert_same_run(full[:2], (model, state))
    # the resumed run's log lines are the uninterrupted run's epoch 2
    assert out.split("\n", 1)[1] in full[2]


@pytest.mark.parametrize("saved,resumed", [([], ["--pallas-opt"]), (["--pallas-opt"], [])],
                         ids=["per_leaf_to_flat", "flat_to_per_leaf"])
def test_archive_resumes_under_the_other_layout(tmp_path, saved, resumed):
    """An archive's layout follows the saving run's flag; the resumed run
    converts to its own (``ensure_opt_layout``) and ends on the same
    values as the saving layout's own continuation."""
    path = str(tmp_path / "s.npz")
    _fit(_args("--epochs", "1", "--save-state", path, *saved))
    same = _fit(_args("--epochs", "1", "--resume-state", path, *saved))
    other = _fit(_args("--epochs", "1", "--resume-state", path, *resumed))
    assert adadelta_flat.is_flat_state(other[1].opt) == bool(resumed)
    assert other[1].step == same[1].step == 10
    for (k, a), (_, b) in zip(same[0].named_parameters(), other[0].named_parameters()):
        assert torch.equal(a, b), k
    flat = ensure_opt_layout(other[1].opt, dict(other[0].named_parameters()), bool(saved))
    for x, y in zip(flat, same[1].opt):
        if isinstance(x, dict):
            assert all(torch.equal(x[k], y[k]) for k in x)
        else:
            assert torch.equal(x, y)


def _mid_epoch_archive(tmp_path, cursor: int, flags=(), writer: str = "port", **meta) -> str:
    """Epoch 1 by ``fit``, then ``cursor`` batches of epoch 2 by the same
    step, saved with the JAX package's mid-epoch extras by ``writer``'s
    ``save_train_state``."""
    final = str(tmp_path / "final.npz")
    args = _args("--epochs", "1", "--save-state", final, *flags)
    _fit(args)
    archive, epoch, _ = ckpt.load_train_state_full(final)
    assert epoch == 1
    net = Net()
    net.load_state_dict(archive.params)
    state = TrainState(opt=archive.opt, step=archive.step)
    step = make_train_step(use_pallas=bool(flags),
                           dropout_seed=split_streams(args.seed)["dropout"])
    train_loader, _ = make_loaders(args, torch.device("cpu"))
    lr = step_lr(args.lr, args.gamma, step_size=1)(2)
    for _, (x, y, w) in zip(range(cursor), train_loader.epoch(2)):
        step(net, state, x, y, w, lr)
    extras = {"epoch_in_progress": 2, "batch_cursor": cursor, "seed": args.seed,
              "global_batch": args.batch_size, "steps_total": state.step,
              "samples_total": state.step * args.batch_size, "world_size": 1}
    extras.update(meta)
    path = str(tmp_path / "mid.npz")
    if writer == "port":
        ckpt.save_train_state(dict(net.named_parameters()), state.opt, state.step, path,
                              epoch=1, extras=extras)
        return path
    if adadelta_flat.is_flat_state(state.opt):
        opt = jax_pa.FlatAdadeltaState(*(jax_flat_from_torch(t) for t in state.opt))
    else:
        opt = JaxAdadeltaState(*(jax_state_from_torch(t) for t in state.opt))
    jax_state = jax_ddp.TrainState(params=jax_state_from_torch(dict(net.named_parameters())),
                                   opt=opt, step=jnp.int32(state.step))
    jax_ckpt.save_train_state(jax_state, path, epoch=1, extras=extras)
    return path


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("flags", [[], ["--pallas-opt"]], ids=["plain", "pallas_opt"])
def test_mid_epoch_archive_resumes_to_the_same_bits(tmp_path, flags, writer):
    """A mid-epoch archive, written by either package, continues to the
    uninterrupted run's bits."""
    path = _mid_epoch_archive(tmp_path, 3, flags, writer)
    archive, epoch, extras = ckpt.load_train_state_full(path)
    assert epoch == 1 and extras["batch_cursor"] == 3 and archive.step == 8
    jax_state, jax_epoch, jax_extras = jax_ckpt.load_train_state_full(path)
    assert (jax_epoch, jax_extras, int(jax_state.step)) == (1, extras, 8)
    full = _fit(_args("--epochs", "2", *flags))
    model, state, out = _fit(_args("--epochs", "1", "--resume-state", path, *flags))
    assert state.step == 10
    _assert_same_run(full[:2], (model, state))
    # batch numbering goes on from the cursor
    train = re.findall(r"^Train Epoch: 2 \[(\d+)/320", out, re.M)
    assert train == ["192", "256"]


@pytest.mark.parametrize("meta,fragment", [
    ({"seed": 5}, "under --seed 5"),
    ({"global_batch": 32}, "at global batch 32"),
    ({"world_size": 2}, "at world size 2; this run's world size is 1"),
    ({"epoch_in_progress": 3}, "epoch_in_progress=3 but epochs_completed=1"),
], ids=["seed", "global_batch", "world_size", "epoch_in_progress"])
def test_mid_epoch_mismatch_raises_the_jax_message(tmp_path, meta, fragment):
    path = _mid_epoch_archive(tmp_path, 2, **meta)
    with pytest.raises(ValueError, match=re.escape(fragment)) as err:
        _fit(_args("--epochs", "1", "--resume-state", path))
    assert_jax_text(str(err.value), first_sentence="world_size" in meta)
    assert repr(path) in str(err.value)


def test_prev_rotation_is_read_only_for_a_missing_or_torn_file(tmp_path):
    path = str(tmp_path / "state.npz")
    prev = path + ckpt.PREV_SUFFIX
    net = Net(torch.Generator().manual_seed(1))
    params = dict(net.named_parameters())
    ckpt.save_train_state(params, make_train_state(net).opt, 3, prev, epoch=1)
    ckpt.save_train_state(params, make_train_state(net).opt, 7, path, epoch=2)
    _, epoch, _, used = ckpt.load_latest_train_state(path)
    assert (epoch, used) == (2, path)
    good = pathlib.Path(path).read_bytes()
    pathlib.Path(path).write_bytes(good[: len(good) // 2])  # torn
    with pytest.raises(ckpt.CorruptCheckpointError) as err:
        ckpt.load_train_state_full(path)
    assert_jax_text(str(err.value))
    archive, epoch, _, used = ckpt.load_latest_train_state(path)
    assert (archive.step, epoch, used) == (3, 1, prev)
    pathlib.Path(path).unlink()  # missing
    assert ckpt.load_latest_train_state(path)[3] == prev
    ckpt.save_state_dict(ckpt.model_state_dict(net), path)  # the wrong kind of file
    with pytest.raises(ValueError, match="save-state archive"):
        ckpt.load_latest_train_state(path)
    pathlib.Path(prev).unlink()
    pathlib.Path(path).unlink()
    with pytest.raises(FileNotFoundError):
        ckpt.load_latest_train_state(path)


# -- --resume and the refusals ---------------------------------------------

@pytest.mark.parametrize("fmt", ["pt", "npz"])
def test_resume_loads_the_checkpoint_with_a_fresh_optimizer(tmp_path, fmt):
    net = Net(torch.Generator().manual_seed(9))
    path = str(tmp_path / f"model.{fmt}")
    if fmt == "pt":
        ckpt.save_state_dict(ckpt.model_state_dict(net), path)
    else:  # the JAX package's model-only npz: torch names, JAX layouts
        tree = jax_state_from_torch(net.state_dict())
        jax_ckpt.save_state_dict(jax_ckpt.model_state_dict(tree), path, format="npz")
    model, state, _ = _fit(_args("--epochs", "0", "--resume", path))
    assert state.step == 0
    for k, v in net.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k
    assert all(not t.any() for t in state.opt.square_avg.values())
    model, state, out = _fit(_args("--epochs", "1", "--resume", path))
    assert state.step == 5 and "Train Epoch: 1 " in out
    assert not torch.equal(model.fc1.weight, net.fc1.weight)


def test_model_only_file_to_resume_state_is_refused(tmp_path):
    path = str(tmp_path / "mnist_cnn.pt")
    ckpt.save_state_dict(ckpt.model_state_dict(Net()), path)
    with pytest.raises(ValueError, match="save-state archive") as err:
        _fit(_args("--epochs", "1", "--resume-state", path))
    assert "resume via --resume instead" in str(err.value)
    assert_jax_text(str(err.value))


def _bn_tree():
    tree = jax.device_get(init_params(jax.random.PRNGKey(0)))
    tree = dict(tree)
    tree["bn1"] = {"scale": np.ones(32, np.float32), "bias": np.zeros(32, np.float32)}
    return tree


def test_batchnorm_checkpoint_to_resume_raises_the_syncbn_message(tmp_path):
    path = str(tmp_path / "bn.npz")
    sd = jax_ckpt.model_state_dict(_bn_tree())
    jax_ckpt.save_state_dict(sd, path, format="npz")
    with pytest.raises(ValueError, match="add --syncbn") as err:
        _fit(_args("--epochs", "1", "--resume", path))
    assert_jax_text(str(err.value))
    assert "not served" not in str(err.value)


def test_batchnorm_archive_to_resume_state_raises_the_jax_message(tmp_path):
    path = str(tmp_path / "bn_state.npz")
    params = _bn_tree()
    state = jax_ddp.make_train_state(params, batch_stats={
        "bn1": {"mean": np.zeros(32, np.float32), "var": np.ones(32, np.float32)}})
    jax_ckpt.save_train_state(jax.device_get(state), path, epoch=1)
    with pytest.raises(ValueError, match="saved with BatchNorm state") as err:
        _fit(_args("--epochs", "1", "--resume-state", path))
    # JAX builds this one from parts: "...saved with BatchNorm state; add --syncbn to match"
    assert str(err.value) == (f"--resume-state {path!r} was saved with BatchNorm state; "
                              "add --syncbn to match")
    src = JAX_TRAINER.read_text()
    assert '"BatchNorm state; "' in src and '" --syncbn to match"' in src


def test_resume_with_resume_state_is_refused(tmp_path):
    with pytest.raises(ValueError, match="mutually exclusive") as err:
        fit(_args("--resume", "a.pt", "--resume-state", "b.npz"), "cpu")
    assert_jax_text(str(err.value))


def test_loader_start_batch_skips_the_first_batches():
    from pytorch_mnist_ddp_tpu.data.loader import DataLoader as JaxLoader

    images, labels = jax_mnist.synthetic_mnist("train", 300)
    port = DataLoader(images, labels, BATCH, torch.device("cpu"), seed=3)
    ref = JaxLoader(images, labels, BATCH, mesh=None, seed=3)
    for start in (0, 2, 4, 5):
        got = list(port.epoch(2, start_batch=start))
        want = list(ref._host_batches(2, start))
        assert len(got) == len(want) == 5 - start
        whole = list(port.epoch(2))[start:]
        for (x, y, w), (jx, jy, jw), (fx, _, _) in zip(got, want, whole):
            assert torch.equal(x, fx)
            np.testing.assert_allclose(x.numpy(), jx, rtol=0, atol=1e-6)
            assert np.array_equal(y.numpy(), jy) and np.array_equal(w.numpy(), jw)


def test_fit_makes_cudnn_deterministic():
    """--resume-state's bit-identity needs deterministic cuDNN on the card
    (its own pick of a conv backward sums with atomics there); fit sets it
    process-wide, as it sets TF32 off."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = False
    try:
        _fit(_args("--epochs", "0"))
        assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.deterministic = before
