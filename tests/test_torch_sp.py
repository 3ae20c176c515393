"""The port's sequence parallelism (``--sp``, ring and Ulysses) held against
the JAX package on the CPU, on the same numpy inputs and weights.

The port's ranks are processes of gloo worlds (``tests/test_torch_vit_ranks.py``
holds their programs), one world per grid shape, (data, seq) = (1, 2),
(2, 2) and (1, 4); JAX's are the devices of the conftest's 8 virtual CPU
devices, meshes of the same shapes.  JAX's flash paths run as its own
tests run them off the TPU: the ring's partial update through its pure-JAX
twin, the whole-forward kernel under shard_map through its dense twin;
the port's through the kernels' plain versions (CPU tensors).

Gates:
- attention outputs and their q/k/v gradients: rtol 1e-5, atol 1e-6
  (gradients rtol 1e-4, atol 1e-5, ``tests/test_flash.py``'s gradient
  gate);
- f32 log-probs within 1e-5 (rtol and atol) with identical argmax;
- 8-step trajectories within ``tests/test_trajectory.py``'s torch gates:
  losses rtol 2e-4, atol 2e-5, each rank's against its data shard's;
  final parameters atol 5e-3; the bf16 leg at the bf16 gates of
  ``tests/test_torch_vit.py`` (losses atol 2e-3, parameters 5e-3);
- the ranks' replicated leaves bit-equal after every step;
- eval totals: the correct count exactly, the loss sum within rtol 1e-5;
- trap A, the head and a trunk leaf's gradient on their own, within 1e-5
  relative of JAX's.
"""

from __future__ import annotations

import os
import pathlib
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from pytorch_mnist_ddp_tpu.data import mnist as jax_mnist
from pytorch_mnist_ddp_tpu.data.transforms import normalize as jax_normalize
from pytorch_mnist_ddp_tpu.models import vit as jvit
from pytorch_mnist_ddp_tpu.ops.loss import nll_loss as jax_nll
from pytorch_mnist_ddp_tpu.parallel import ddp as jax_ddp
from pytorch_mnist_ddp_tpu.parallel import sp as jax_sp
from pytorch_mnist_ddp_tpu.utils import logging as jax_logging
from pytorch_mnist_ddp_tpu.utils.jax_compat import shard_map
from pytorch_mnist_ddp_tpu_torch.utils.convert import torch_vit_state_from_jax
from test_torch_launch import run_world
from test_torch_vit_ranks import grid_tasks

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS, B = 8, 8  # optimizer steps; rows per data shard a step
PAD = 2  # the last step's padding rows in every data shard
LOGP_TOL = dict(rtol=1e-5, atol=1e-5)
OUT_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_TOL = dict(rtol=2e-4, atol=2e-5)
PARAM_ATOL = 5e-3
BF16_LOSS_ATOL, BF16_PARAM_ATOL = 2e-3, 5e-3
LEGS = {"ring": ("ring", False), "ring_flash": ("ring", True), "ulysses": ("ulysses", False),
        "ulysses_flash": ("ulysses", True)}
GRID_LEGS = ("ring", "ring_flash", "ulysses")  # at every grid shape; the rest at (1, 2)
FNS = {"ring_attention": jax_sp.ring_attention, "ring_attention_flash": jax_sp.ring_attention_flash,
       "ulysses_attention": jax_sp.ulysses_attention}


def _params(seed=7):
    return jax.device_get(jvit.init_vit_params(jax.random.PRNGKey(seed), jvit.ViTConfig()))


def _state(params):
    return {k: v.numpy() for k, v in torch_vit_state_from_jax(params).items()}


def _batches(num_data: int):
    n = STEPS * num_data * B
    images, labels = jax_mnist.synthetic_mnist("train", n)
    xs = jax_normalize(images).reshape(STEPS, num_data * B, 28, 28, 1)
    ys = labels.astype(np.int64).reshape(STEPS, num_data * B)
    ws = np.ones((STEPS, num_data, B), np.float32)
    ws[-1, :, B - PAD:] = 0.0  # a final partial batch: padding rows in every shard
    xs[-1].reshape(num_data, B, 28, 28, 1)[:, B - PAD:] = 0.0
    return xs, ys, ws.reshape(STEPS, num_data * B)


def _eval_batch(num_data: int):
    images, labels = jax_mnist.synthetic_mnist("test", num_data * 12)
    w = np.ones((num_data, 12), np.float32)
    w[-1, -5:] = 0.0  # the last shard's padding
    return jax_normalize(images), labels.astype(np.int64), w.reshape(-1)


def _qkv(seed, b=2, t=16, h=4, d=8):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, t, h, d).astype(np.float32) for _ in range(3))


def _mesh(num_data, num_seq):
    return jax_sp.make_sp_mesh(num_data, num_seq, devices=jax.devices()[:num_data * num_seq])


SHAPES = {(1, 2): 2, (2, 2): 4, (1, 4): 4}


def _tasks(shape):
    num_data, num_seq = shape
    params = _params()
    state = _state(params)
    batches = _batches(num_data)
    tasks = [(f"traj_{leg}", "trajectory",
              dict(kind="sp", state=state, batches=batches, impl=impl, flash=flash))
             for leg, (impl, flash) in LEGS.items()
             if leg in GRID_LEGS or shape == (1, 2)]
    x, y, w = _eval_batch(num_data)
    tasks.append(("eval", "evaluate", dict(kind="sp", state=state, x=x, y=y, w=w)))
    if num_data == 1:
        tasks += [(f"attn_{fn}", "attention", dict(q=q, k=k, v=v, fn=fn))
                  for fn in FNS for q, k, v in [_qkv(num_seq)]]
    if shape == (1, 2):
        tasks += [
            ("forward", "forward", dict(kind="sp", state=state, x=x)),
            ("forward_ulysses_flash", "forward",
             dict(kind="sp", state=state, x=x, impl="ulysses", flash=True)),
            ("traj_bf16_ring_flash", "trajectory",
             dict(kind="sp", state=state, batches=batches, flash=True, bf16=True)),
            ("traj_remat_ring_flash", "trajectory",
             dict(kind="sp", state=state, batches=batches, flash=True, remat=True)),
        ]
    if shape == (2, 2):
        xs, ys, ws = batches
        tasks.append(("grads", "grads", dict(kind="sp", state=state, x=xs[-1], y=ys[-1],
                                             w=ws[-1])))
    return tasks


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every leg of each grid shape in one gloo world of D * S ranks."""
    return {shape: run_world(grid_tasks, n, tmp_path_factory.mktemp(f"sp{shape[0]}x{shape[1]}"),
                             [("seq", shape[1])], _tasks(shape))
            for shape, n in SHAPES.items()}


def _ranks(worlds, shape):
    """The ranks of ``shape``'s world, with their (d, s) coordinates checked."""
    ranks = worlds[shape]
    num_data, num_seq = shape
    assert [r["coords"] for r in ranks] == [(d, s, 0) for d in range(num_data)
                                            for s in range(num_seq)]
    return ranks


# -- the JAX references ----------------------------------------------------------


def _jax_trajectory(shape, impl, flash, bf16=False, remat=False):
    cfg = jvit.ViTConfig(bf16=bf16, remat=remat)
    mesh = _mesh(*shape)
    step = jax_sp.make_sp_train_step(mesh, cfg, use_flash=flash, impl=impl)
    state = jax_ddp.replicate_params(jax_ddp.make_train_state(_params()), mesh)
    losses = []
    for x, y, w in zip(*_batches(shape[0])):
        state, per_shard = step(state, jnp.asarray(x), jnp.asarray(y, jnp.int32),
                                jnp.asarray(w), jnp.float32(1.0))
        losses.append(np.asarray(per_shard))
    return np.stack(losses), torch_vit_state_from_jax(jax.device_get(state.params))


def _jax_attention(fn, num_seq, q, k, v):
    """JAX's function over a (1, S) mesh, token axis sharded, and the
    gradients of sum(out * k)."""
    mesh = _mesh(1, num_seq)
    spec = P(None, jax_sp.SEQ_AXIS)
    sharded = shard_map(lambda q, k, v: FNS[fn](q, k, v, jax_sp.SEQ_AXIS), mesh=mesh,
                        in_specs=(spec, spec, spec), out_specs=spec)

    @jax.jit
    def out_and_grads(q, k, v):
        out, vjp = jax.vjp(sharded, q, k, v)
        return out, vjp(k)

    out, grads = out_and_grads(*map(jnp.asarray, (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in grads]


# -- tests -----------------------------------------------------------------------


@pytest.mark.parametrize("num_seq", [2, 4])
@pytest.mark.parametrize("fn", list(FNS))
def test_attention_matches_jax(worlds, fn, num_seq):
    """The port's ring (plain folds), ring with the partial kernel's plain
    version, and Ulysses against JAX's, forward and backward; the blocks
    in seq order make up the whole sequence."""
    q, k, v = _qkv(num_seq)
    want, (dq, dk, dv) = _jax_attention(fn, num_seq, q, k, v)
    ranks = _ranks(worlds, (1, num_seq))
    got = {key: np.concatenate([r[f"attn_{fn}"][key] for r in ranks], axis=1)
           for key in ("out", "dq", "dk", "dv")}
    np.testing.assert_allclose(got["out"], want, **OUT_TOL)
    for name, ref in (("dq", dq), ("dk", dk), ("dv", dv)):
        np.testing.assert_allclose(got[name], ref, err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("leg", ["ring", "ulysses_flash"])
def test_sp_forward_logits_match_jax(worlds, leg):
    impl, flash = LEGS[leg]
    x, _, _ = _eval_batch(1)
    mesh = _mesh(1, 2)
    fwd = jax.jit(shard_map(
        lambda p, x: jax_sp._sp_vit_forward(p, x, jvit.ViTConfig(), use_flash=flash, impl=impl),
        mesh=mesh, in_specs=(P(), P("data")), out_specs=P("data")))
    want = np.asarray(fwd(_params(), jnp.asarray(x)))
    name = "forward" if leg == "ring" else f"forward_{leg}"
    for r in _ranks(worlds, (1, 2)):
        assert r[name].dtype == np.float32
        np.testing.assert_allclose(r[name], want, **LOGP_TOL)
        assert np.array_equal(r[name].argmax(1), want.argmax(1))


def _check_trajectory(ranks, key, jlosses, jstate, loss_tol, param_atol):
    for rank in ranks:
        got = rank[key]
        d = rank["coords"][0]
        assert got["step"] == STEPS
        np.testing.assert_allclose(got["losses"], jlosses[:, d], err_msg=str(rank["coords"]),
                                   **loss_tol)
    # Every rank holds the same model after every step, bit for bit.
    first = ranks[0][key]
    assert all(r[key]["local"] == first["local"] for r in ranks)
    assert len(set(first["local"])) == STEPS  # and every step moved it
    for k, want in jstate.items():
        np.testing.assert_allclose(first["state"][k], want.numpy(), rtol=0, atol=param_atol,
                                   err_msg=k)


@pytest.mark.parametrize("shape, leg", [(shape, leg) for shape in SHAPES for leg in GRID_LEGS]
                         + [((1, 2), "ulysses_flash")],
                         ids=lambda v: f"{v[0]}x{v[1]}" if isinstance(v, tuple) else v)
def test_sp_trajectory_matches_jax(worlds, shape, leg):
    """8 steps at lr 1.0 on the (data, seq) grid from the same weights on
    the same global batches as JAX's make_sp_train_step; the last step's
    shards carry padding rows."""
    impl, flash = LEGS[leg]
    jlosses, jstate = _jax_trajectory(shape, impl, flash)
    _check_trajectory(_ranks(worlds, shape), f"traj_{leg}", jlosses, jstate, LOSS_TOL,
                      PARAM_ATOL)


@pytest.mark.parametrize("leg", ["bf16_ring_flash", "remat_ring_flash"])
def test_sp_bf16_and_remat_trajectories_match_jax(worlds, leg):
    """--bf16 (the bf16 gates: JAX's ring twin leaves p unrounded, the
    port's plain partial rounds it as the kernel does) and --remat (the
    recompute replays the ring passes in backward) at (1, 2)."""
    bf16 = leg.startswith("bf16")
    jlosses, jstate = _jax_trajectory((1, 2), "ring", True, bf16=bf16, remat=not bf16)
    tol = (dict(rtol=0, atol=BF16_LOSS_ATOL), BF16_PARAM_ATOL) if bf16 else (LOSS_TOL,
                                                                            PARAM_ATOL)
    _check_trajectory(_ranks(worlds, (1, 2)), f"traj_{leg}", jlosses, jstate, *tol)
    if not bf16:  # recomputing changes no value
        ranks = _ranks(worlds, (1, 2))
        assert ranks[0]["traj_remat_ring_flash"]["local"] == ranks[0]["traj_ring_flash"]["local"]


@pytest.mark.parametrize("shape", list(SHAPES), ids=lambda s: f"{s[0]}x{s[1]}")
def test_sp_eval_totals_match_jax(worlds, shape):
    """Summed over the data group only: every rank holds the totals once."""
    x, y, w = _eval_batch(shape[0])
    want = np.asarray(jax_sp.make_sp_eval_step(_mesh(*shape), jvit.ViTConfig())(
        jax_ddp.replicate_params(_params(), _mesh(*shape)), jnp.asarray(x),
        jnp.asarray(y, jnp.int32), jnp.asarray(w)))
    for r in _ranks(worlds, shape):
        np.testing.assert_allclose(r["eval"][0], want[0], rtol=1e-5)
        assert r["eval"][1] == want[1]


@pytest.mark.parametrize("leaf", ["head.weight", "head.bias", "blocks.0.qkv.weight",
                                  "pos_embed"])
def test_head_and_trunk_gradients_match_jax_on_their_own(worlds, leaf):
    """Trap A: the head sits after the pool's sum over seq, the trunk
    before it.  A pool whose backward were the identity with the head
    counted on every member would make the head's gradient S times JAX's;
    an all-reduce backward would do that to the trunk's.  Each leaf on its
    own, on the (2, 2) grid, against the JAX step's gradient (its
    value_and_grad over the shard_map, divided by the data degree)."""
    cfg = jvit.ViTConfig()
    want = jax_grads(lambda p, x: jax_sp._sp_vit_forward(p, x, cfg), _mesh(2, 2), P(),
                     *(a[-1] for a in _batches(2)))
    for r in _ranks(worlds, (2, 2)):
        assert_grad_leaf(r["grads"][leaf], want[leaf], (r["coords"], leaf))


def jax_grads(forward, mesh, param_specs, x, y, w) -> dict:
    """JAX's step gradient on ``mesh``: the value_and_grad of each data
    shard's mean loss under shard_map, which VMA sums over the axes a leaf
    is replicated on, divided by the data degree, for the global batch
    ``(x, y, w)`` and the weights of :func:`_params` laid out by
    ``param_specs``; whole leaves in the port's layout."""
    num_data = mesh.shape["data"]

    def local(params, x, y, w):
        def loss_fn(p):
            return jax_nll(forward(p, x), y, w, reduction="mean")

        return jax.tree.map(lambda g: g / num_data, jax.grad(loss_fn)(params))

    grads = jax.jit(shard_map(local, mesh=mesh,
                              in_specs=(param_specs, P("data"), P("data"), P("data")),
                              out_specs=param_specs))(
        _params(), jnp.asarray(x), jnp.asarray(y, jnp.int32), jnp.asarray(w))
    return {k: v.numpy() for k, v in torch_vit_state_from_jax(jax.device_get(grads)).items()}


def assert_grad_leaf(got: np.ndarray, want: np.ndarray, where) -> None:
    """One leaf's gradient within 1e-5 of JAX's, relative to its largest
    entry."""
    assert got.shape == want.shape, where
    assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max()), where


# -- the CLI --------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launcher_sp2_prints_one_chief_the_jax_lines(tmp_path):
    """Two gloo ranks through the launcher: one chief's lines, the JAX
    CLI's, and one params tree."""
    drop = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "SLURM_PROCID", "MASTER_ADDR", "MASTER_PORT",
            "MNIST_DATA_DIR")
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.parallel.launch",
         "--nproc_per_node=2", f"--master_port={_free_port()}", "-m",
         "pytorch_mnist_ddp_tpu_torch.vit_mnist", "--no-cuda", "--dry-run", "--epochs", "1",
         "--sp", "2", "--flash", "--save-model"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    loss = re.search(r"^Train Epoch: .*Loss: (\S+)$", out, re.M).group(1)
    avg, correct = re.search(r"^Test set: Average loss: (\S+), Accuracy: (\d+)/", out,
                             re.M).groups()
    elapsed = re.search(r"^Total cost time:(\S+) ms$", out, re.M).group(1)
    want = ("MNIST IDX files unavailable (no local copy, download failed); "
            "using deterministic synthetic MNIST-like data\n")
    want += jax_logging.train_log_line(1, 0, 60000, 0, 938, float(loss)) + "\n"
    want += jax_logging.test_summary_lines(float(avg), int(correct), 10000) + "\n"
    want += jax_logging.total_time_line(float(elapsed)) + "\n"
    assert out == want
    assert sorted(p.name for p in tmp_path.iterdir()) == ["vit_mnist.npz"]


def test_chief_logs_the_global_sample_counter_of_the_data_shards(capsys):
    """Rows go by data coordinate: with 2 data shards of 64 the chief's
    lines count 2 x 64 samples a step over ceil(640 / 128) batches, as the
    JAX CLI counts its global batch; another rank prints nothing."""
    import torch

    from pytorch_mnist_ddp_tpu_torch.data.loader import DataLoader
    from pytorch_mnist_ddp_tpu_torch.parallel.distributed import DistState
    from pytorch_mnist_ddp_tpu_torch.trainer import train_one_epoch

    images, labels = jax_mnist.synthetic_mnist("train", 640)
    losses = iter(range(100))

    def step(model, state, x, y, w, lr):
        return torch.tensor(float(next(losses)))

    for rank in (0, 3):
        loader = DataLoader(images, labels, 64, torch.device("cpu"), shard=rank // 2,
                            num_shards=2)
        train_one_epoch(step, None, None, loader, 1, 1.0, log_interval=2,
                        dist=DistState(distributed=True, rank=rank, world_size=4))
    want = "".join(jax_logging.train_log_line(1, b * 128, 640, b, 5, float(i)) + "\n"
                   for i, b in ((0, 0), (2, 2), (4, 4)))
    assert capsys.readouterr().out == want
