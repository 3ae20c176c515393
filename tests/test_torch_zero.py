"""The port's ZeRO-1 (``--zero`` of ``mnist_ddp`` and ``vit_mnist``) held
against the JAX package on the CPU, on the same numpy inputs and weights.

The port's ranks are processes of gloo worlds of 2 and 4
(``tests/test_torch_family_ranks.py`` holds their programs); JAX's are 2
and 4 of the conftest's 8 virtual CPU devices, fed the ranks' rows in rank
order.

Gates:
- the chunk geometry (``zero_chunk``, padded length, each rank's slice)
  equal to JAX's at N = 1, 2, 4 for the CNN (1,199,882 parameters) and
  the ViT (71,946);
- 8-step trajectories of the CNN (with and without ``--syncbn``, dropout
  off) and the ViT within the trajectory gates (losses rtol 2e-4, atol
  2e-5, each rank's against its shard's; parameters atol 5e-3) of
  ``make_zero_train_step``/``make_zero_vit_train_step``, the ranks equal
  bit for bit after every step; at N = 2 the CNN's ZeRO steps bit-equal
  to plain DP's (gloo's reduce-scatter sums what its all-reduce sums);
- the accumulators gathered per leaf against JAX's ``zero_opt_to_per_leaf``
  within 1e-3 of each leaf's largest entry, 2e-2 with ``--syncbn`` (they
  accumulate squared gradients over 8 steps, and the BatchNorm's sums run
  in another order in each package: up to 7.4e-3 measured on the CPU,
  torch 2.13.0+cpu, jax 0.9.0),
  plus 1e-10 for the conv biases before a BatchNorm, whose gradient is 0
  in exact arithmetic and whose accumulators hold rounding noise (~1e-13).
  A chunk laid out in the wrong place is off by O(1); the per-leaf round
  trip exact;
- archives: a port ``--zero --save-state`` archive read by the JAX
  package's ``load_train_state`` and equal to the plain run's, and a JAX
  archive resumed under ``--zero`` equal to its plain resumption;
- the refusal of ``--zero --pallas-opt``, with the JAX trainer's text.
"""

from __future__ import annotations

import pathlib
import re
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.flatten_util import ravel_pytree

from pytorch_mnist_ddp_tpu.data import mnist as jax_mnist
from pytorch_mnist_ddp_tpu.data.transforms import normalize as jax_normalize
from pytorch_mnist_ddp_tpu.models import vit as jvit
from pytorch_mnist_ddp_tpu.models.net import init_params, init_variables
from pytorch_mnist_ddp_tpu.parallel import ddp as jax_ddp
from pytorch_mnist_ddp_tpu.parallel import zero as jax_zero
from pytorch_mnist_ddp_tpu.parallel.mesh import make_mesh
from pytorch_mnist_ddp_tpu.utils import checkpoint as jax_checkpoint
from pytorch_mnist_ddp_tpu_torch.models.net import Net
from pytorch_mnist_ddp_tpu_torch.models.vit import ViT
from pytorch_mnist_ddp_tpu_torch.parallel.zero import zero_chunk
from pytorch_mnist_ddp_tpu_torch.trainer import _fit
from pytorch_mnist_ddp_tpu_torch.utils import checkpoint as port_ckpt
from pytorch_mnist_ddp_tpu_torch.utils.convert import (
    torch_state_from_jax,
    torch_vit_state_from_jax,
)
from test_torch_family_ranks import family_tasks
from test_torch_launch import run_world

STEPS, B, PAD = 8, 16, 4  # steps; CNN rows per rank a step; the last step's padding
VIT_B = 8
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_ATOL = 5e-3
LIMIT = 320  # the archive legs' IDX files: 320 training and test rows


def _batches(n: int, b: int):
    images, labels = jax_mnist.synthetic_mnist("train", STEPS * n * b)
    xs = jax_normalize(images).reshape(STEPS, n * b, 28, 28, 1)
    ys = labels.astype(np.int64).reshape(STEPS, n * b)
    ws = np.ones((STEPS, n, b), np.float32)
    ws[-1, :, b - PAD:] = 0.0
    xs[-1].reshape(n, b, 28, 28, 1)[:, b - PAD:] = 0.0
    return xs, ys, ws.reshape(STEPS, n * b)


def _cnn_variables():
    return jax.device_get(init_variables(jax.random.PRNGKey(5), use_bn=True))


def _cnn_state(variables, syncbn):
    state = torch_state_from_jax(variables["params"] if syncbn else
                                 {k: v for k, v in variables["params"].items()
                                  if not k.startswith("bn")})
    if syncbn:
        state.update(port_ckpt._torch_stats(variables["batch_stats"]))
    return {k: v.numpy() for k, v in state.items()}


def _vit_params():
    return jax.device_get(jvit.init_vit_params(jax.random.PRNGKey(7), jvit.ViTConfig()))


def _jax_archive(path: str) -> None:
    """A JAX archive of a run one step in: CNN params and per-leaf
    accumulators of plain DP, epoch 1."""
    mesh = make_mesh(num_data=1, devices=jax.devices()[:1])
    state = jax_ddp.replicate_params(jax_ddp.make_train_state(
        jax.device_get(init_params(jax.random.PRNGKey(3)))), mesh)
    step = jax_ddp.make_train_step(mesh, dropout=False)
    xs, ys, ws = _batches(1, 32)
    state, _ = step(state, jnp.asarray(xs[0]), jnp.asarray(ys[0], jnp.int32),
                    jnp.asarray(ws[0]), jax.random.PRNGKey(0), jnp.float32(1.0))
    jax_checkpoint.save_train_state(jax.device_get(state), path, epoch=1)


def _idx_root(root):
    for split, prefix in (("train", "train"), ("test", "t10k")):
        images, labels = jax_mnist.synthetic_mnist(split, LIMIT)
        (root / f"{prefix}-images-idx3-ubyte").write_bytes(
            struct.pack(">iiii", 2051, *images.shape) + images.tobytes())
        (root / f"{prefix}-labels-idx1-ubyte").write_bytes(
            struct.pack(">ii", 2049, len(labels)) + labels.tobytes())
    return str(root)


def _tasks(n: int, tmp):
    variables = _cnn_variables()
    cnn, vit = _batches(n, B), _batches(n, VIT_B)
    tasks = [(f"cnn_{'zero' if zero else 'plain'}{'_bn' if bn else ''}", "cnn_trajectory", [],
              dict(state=_cnn_state(variables, bn), batches=cnn, zero=zero, syncbn=bn))
             for zero in (True, False) for bn in (False, True) if zero or n == 2]
    tasks += [("vit", "vit_trajectory", [], dict(mode="zero", state={
        k: v.numpy() for k, v in torch_vit_state_from_jax(_vit_params()).items()},
        batches=vit, cfg={})),
        ("round_trip", "zero_round_trip", [], dict(shapes={
            k: tuple(p.shape) for k, p in Net().named_parameters()}))]
    if n == 2:
        root = _idx_root(tmp / "idx")
        _jax_archive(str(tmp / "jax.npz"))
        common = ["--epochs", "1", "--train-limit", str(LIMIT), "--log-interval", "1"]
        for name, flags in (("fit_zero", ["--zero", "--save-state", str(tmp / "zero.npz")]),
                            ("fit_plain", ["--save-state", str(tmp / "plain.npz")]),
                            ("resume_zero", ["--zero", "--resume-state", str(tmp / "jax.npz"),
                                             "--save-state", str(tmp / "rzero.npz")]),
                            ("resume_plain", ["--resume-state", str(tmp / "jax.npz"),
                                              "--save-state", str(tmp / "rplain.npz")])):
            tasks.append((name, "cnn_fit", [], dict(flags=[*common, *flags], data_dir=root)))
    return tasks


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for n in (2, 4):
        tmp = tmp_path_factory.mktemp(f"zero{n}")
        (tmp / "idx").mkdir()
        out[n] = run_world(family_tasks, n, tmp, _tasks(n, tmp))
        out[f"tmp{n}"] = tmp
    return out


def _mesh(n):
    return make_mesh(num_data=n, devices=jax.devices()[:n])


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("model", ["cnn", "vit"])
def test_chunk_geometry_matches_jax(n, model):
    params = (jax.device_get(init_params(jax.random.PRNGKey(0))) if model == "cnn"
              else _vit_params())
    port = Net() if model == "cnn" else ViT()
    total = sum(p.numel() for p in port.parameters())
    assert total == ravel_pytree(params)[0].size == (1199882 if model == "cnn" else 71946)
    opt = jax_zero.zero_init(params, _mesh(n))
    chunk = zero_chunk(total, n)
    assert chunk == jax_zero.zero_chunk(total, n)
    assert opt.square_avg.shape == (chunk * n,)
    assert {s.data.shape for s in opt.square_avg.addressable_shards} == {(chunk,)}


def _jax_cnn(n, syncbn):
    variables = _cnn_variables()
    params = variables["params"] if syncbn else {k: v for k, v in variables["params"].items()
                                                 if not k.startswith("bn")}
    mesh = _mesh(n)
    state = jax_zero.make_zero_train_state(params, mesh,
                                           batch_stats=variables["batch_stats"] if syncbn else ())
    step = jax_zero.make_zero_train_step(mesh, dropout=False, use_bn=syncbn)
    losses = []
    for x, y, w in zip(*_batches(n, B)):
        state, per_shard = step(state, jnp.asarray(x), jnp.asarray(y, jnp.int32),
                                jnp.asarray(w), jax.random.PRNGKey(0), jnp.float32(1.0))
        losses.append(np.asarray(per_shard))
    want = torch_state_from_jax(jax.device_get(state.params))
    if syncbn:
        want.update(port_ckpt._torch_stats(jax.device_get(state.batch_stats)))
    per_leaf = jax.device_get(jax_zero.zero_opt_to_per_leaf(state.opt, state.params, mesh))
    return np.stack(losses), want, per_leaf


def _check_ranks(ranks, key, jlosses, want, digests="digests"):
    for r in ranks:
        np.testing.assert_allclose(r[key]["losses"], jlosses[:, r["rank"]],
                                   err_msg=str(r["rank"]), **LOSS_TOL)
    first = ranks[0][key]
    assert all(r[key][digests] == first[digests] for r in ranks)
    assert len(set(first[digests])) == STEPS
    for k, v in want.items():
        np.testing.assert_allclose(first["state"][k], v.numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("syncbn", [False, True], ids=["plain", "syncbn"])
def test_cnn_zero_trajectory_matches_jax(worlds, n, syncbn):
    jlosses, want, per_leaf = _jax_cnn(n, syncbn)
    key = "cnn_zero" + ("_bn" if syncbn else "")
    _check_ranks(worlds[n], key, jlosses, want)
    got = worlds[n][0][key]
    assert got["chunk"] == zero_chunk(sum(v.size for k, v in got["state"].items()
                                          if not k.endswith(("running_mean", "running_var"))), n)
    for tree, ref in zip(got["opt"], (per_leaf.square_avg, per_leaf.acc_delta)):
        for k, v in torch_state_from_jax(ref).items():
            v = v.numpy()
            rel = 2e-2 if syncbn else 1e-3
            assert float(np.abs(tree[k] - v).max()) <= rel * float(np.abs(v).max()) + 1e-10, k


@pytest.mark.parametrize("syncbn", [False, True], ids=["plain", "syncbn"])
def test_cnn_zero_is_plain_dp_bit_for_bit_at_two_ranks(worlds, syncbn):
    suffix = "_bn" if syncbn else ""
    for r in worlds[2]:
        zero, plain = r["cnn_zero" + suffix], r["cnn_plain" + suffix]
        assert zero["digests"] == plain["digests"]
        assert np.array_equal(zero["losses"], plain["losses"])
        for a, b in zip(zero["opt"], plain["opt"]):
            assert all(np.array_equal(a[k], b[k]) for k in b)


@pytest.mark.parametrize("n", [2, 4])
def test_vit_zero_trajectory_matches_jax(worlds, n):
    mesh = _mesh(n)
    params = _vit_params()
    state = jax_zero.make_zero_train_state(params, mesh)
    step = jax_zero.make_zero_vit_train_step(mesh, jvit.ViTConfig())
    losses = []
    for x, y, w in zip(*_batches(n, VIT_B)):
        state, per_shard = step(state, jnp.asarray(x), jnp.asarray(y, jnp.int32),
                                jnp.asarray(w), jnp.float32(1.0))
        losses.append(np.asarray(per_shard))
    want = torch_vit_state_from_jax(jax.device_get(state.params))
    _check_ranks(worlds[n], "vit", np.stack(losses), want, digests="replicated")


@pytest.mark.parametrize("n", [2, 4])
def test_per_leaf_round_trip(worlds, n):
    assert all(r["round_trip"]["equal"] for r in worlds[n])
    assert {r["round_trip"]["chunk"] for r in worlds[n]} == {zero_chunk(1199882, n)}


def test_port_zero_archive_reads_in_jax_and_equals_the_plain_run(worlds):
    tmp = worlds["tmp2"]
    zero, plain = tmp / "zero.npz", tmp / "plain.npz"
    with np.load(zero) as a, np.load(plain) as b:
        assert sorted(a.keys()) == sorted(b.keys())
        assert all(np.array_equal(a[k], b[k]) for k in b.keys())
    state, epoch = jax_checkpoint.load_train_state(str(zero))
    assert epoch == 1
    fresh = jax_ddp.make_train_state(jax.device_get(init_params(jax.random.PRNGKey(0))))
    assert jax.tree.structure(state.opt) == jax.tree.structure(fresh.opt)  # per leaf
    archive = port_ckpt.load_latest_train_state(str(zero), False)[0]
    for tree, jtree in zip(archive.opt, state.opt):
        for k, v in torch_state_from_jax(jtree).items():
            assert np.array_equal(tree[k].numpy(), v.numpy()), k
    assert worlds[2][0]["fit_zero"] == worlds[2][0]["fit_plain"]  # rank 0's lines
    assert worlds[2][1]["fit_zero"] == ""  # only rank 0 prints


def test_jax_archive_resumes_under_zero_as_under_plain(worlds):
    tmp = worlds["tmp2"]
    with np.load(tmp / "rzero.npz") as a, np.load(tmp / "rplain.npz") as b:
        assert sorted(a.keys()) == sorted(b.keys())
        assert all(np.array_equal(a[k], b[k]) for k in b.keys())
        assert int(a["epoch"]) == 2
    lines = worlds[2][0]["resume_zero"]
    assert lines.startswith("Train Epoch: 2 ") and lines == worlds[2][0]["resume_plain"]


def test_zero_with_pallas_opt_is_refused_with_the_jax_text():
    """Refused before any data or device work, with the text of the JAX
    trainer's refusal (its source, two literals joined)."""
    from pytorch_mnist_ddp_tpu_torch.mnist_ddp import build_parser
    from pytorch_mnist_ddp_tpu_torch.parallel.distributed import DistState

    jax_src = (pathlib.Path(__file__).resolve().parents[1] / "pytorch_mnist_ddp_tpu"
               / "trainer.py").read_text()
    literals = re.search(r'raise ValueError\("(--zero and --pallas-opt[^"]*)"\s*"([^"]*)"\)',
                         jax_src)
    args = build_parser().parse_args(["--no-cuda", "--zero", "--pallas-opt"])
    with pytest.raises(ValueError) as err:
        _fit(args, "cpu", None, None, DistState())
    assert str(err.value) == literals.group(1) + literals.group(2)
