"""The port's ViT training path (``models/vit.py``, ``parallel/sp.py``,
``vit_mnist.py``) held against the JAX package on the CPU, on the same
numpy inputs and the same (converted) weights.

Tolerances:
- log-probs rtol 1e-5, atol 1e-6 with identical argmax (the f32 logits
  gate of the port); parameter gradients rtol 1e-4, atol 1e-5
  (``tests/test_flash.py``'s gradient gate);
- 8-step trajectories within ``tests/test_torch_train.py``'s bounds:
  losses rtol 2e-4, atol 2e-5, final parameters atol 5e-3.  The ViT has no
  dropout, so the three paths (single device plain, single device
  ``--flash``, ``--sp 1 --allow-degree-1 --flash``) start from the same
  weights and see the same batches as JAX's.
The JAX ``--flash`` reference runs the Pallas kernel in interpret mode;
JAX's ring runs its partial update through the kernel's pure-JAX twin off
the TPU, as its own tests do.

bf16 (``ViTConfig(bf16=True)``, against JAX's): the two frameworks round
at other places (torch's bf16 GELU and sums round once from f32; XLA may
keep f32 within a fusion), so bf16 activations differ by an ulp here and
there.  Measured on these inputs, and gated with about 2x headroom
(``BF16_*``): log-probs within 3.9e-3 (gate 1e-2) with identical argmax;
parameter gradients within 1.2e-2 absolute (gate 2e-2; the biases, whose
gradients sum 1024 bf16 terms, are the farthest); 8-step trajectories, on
all three paths, losses within 5.5e-4 (gate 2e-3) and parameters within
1.6e-3 (gate 5e-3, the f32 trajectories' own).  Log-probs stay f32.
"""

from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu.data import mnist as jax_mnist
from pytorch_mnist_ddp_tpu.data.transforms import normalize as jax_normalize
from pytorch_mnist_ddp_tpu.models import vit as jvit
from pytorch_mnist_ddp_tpu.ops import pallas_attention as pa
from pytorch_mnist_ddp_tpu.ops.adadelta import adadelta_init as jax_adadelta_init
from pytorch_mnist_ddp_tpu.ops.adadelta import adadelta_update as jax_adadelta_update
from pytorch_mnist_ddp_tpu.ops.attention import full_attention as jax_full_attention
from pytorch_mnist_ddp_tpu.ops.loss import nll_loss as jax_nll
from pytorch_mnist_ddp_tpu.parallel import ddp as jax_ddp
from pytorch_mnist_ddp_tpu.parallel import sp as jax_sp
from pytorch_mnist_ddp_tpu.utils import checkpoint as jax_checkpoint
from pytorch_mnist_ddp_tpu.utils import logging as jax_logging
from pytorch_mnist_ddp_tpu_torch import vit_mnist
import vit_mnist as jax_cli  # the JAX package's CLI (no JAX import at module level)
from pytorch_mnist_ddp_tpu_torch.models.vit import ViT, ViTConfig, layer_norm, patchify
from pytorch_mnist_ddp_tpu_torch.ops.adadelta import adadelta_init
from pytorch_mnist_ddp_tpu_torch.ops.flash_attention import select_attention
from pytorch_mnist_ddp_tpu_torch.ops.loss import nll_loss
from pytorch_mnist_ddp_tpu_torch.parallel import sp
from pytorch_mnist_ddp_tpu_torch.parallel.ddp import (
    TrainState,
    make_forward_eval_step,
    make_forward_train_step,
)
from pytorch_mnist_ddp_tpu_torch.utils import checkpoint as port_checkpoint
from pytorch_mnist_ddp_tpu_torch.utils.convert import (
    jax_vit_tree_from_torch,
    torch_vit_state_from_jax,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS, BATCH = 8, 64
LOGP_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
CONFIGS = {"default": {}, "small": {"depth": 1, "dim": 32}}


def _jax_params(cfg_kwargs, seed=0):
    return jax.device_get(jvit.init_vit_params(jax.random.PRNGKey(seed),
                                               jvit.ViTConfig(**cfg_kwargs)))


BF16_LOGP_ATOL = 1e-2
BF16_GRAD_ATOL = 2e-2
BF16_TRAJ_LOSS_ATOL = 2e-3
BF16_TRAJ_PARAM_ATOL = 5e-3


def _port_vit(params, cfg_kwargs, flash=False, remat=False) -> ViT:
    model = ViT(ViTConfig(remat=remat, **cfg_kwargs), select_attention(flash))
    model.load_state_dict(torch_vit_state_from_jax(params))
    return model


def _images(n, seed):
    return np.random.RandomState(seed).rand(n, 28, 28, 1).astype(np.float32)


def test_converter_round_trips():
    params = _jax_params({})
    state = torch_vit_state_from_jax(params)
    model = ViT()
    assert sorted(state) == sorted(model.state_dict())
    assert all(state[k].shape == v.shape for k, v in model.state_dict().items())
    assert sum(p.numel() for p in model.parameters()) == 71946
    back = jax_vit_tree_from_torch(state)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    # qkv crosses by a transpose alone: head-major in both packages.
    assert np.array_equal(state["blocks.0.qkv.weight"].numpy(),
                          params["blocks"]["0"]["qkv"]["kernel"].T)


def test_patchify_and_layer_norm_match_jax():
    cfg = jvit.ViTConfig()
    x = _images(3, 1)
    assert np.array_equal(patchify(torch.tensor(x), ViTConfig()).numpy(),
                          np.asarray(jvit.patchify(jnp.asarray(x), cfg)))
    rng = np.random.RandomState(2)
    h = (rng.randn(4, 16, 64) * 3 + 1).astype(np.float32)
    scale, bias = rng.randn(64).astype(np.float32), rng.randn(64).astype(np.float32)
    got = layer_norm(torch.tensor(h), torch.tensor(scale), torch.tensor(bias))
    want = jvit.layer_norm(jnp.asarray(h), {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _jax_loss_and_grads(params, cfg_kwargs, x, y, attention_fn):
    cfg = jvit.ViTConfig(**cfg_kwargs)

    def loss_fn(p):
        logp = jvit.vit_forward(p, x, cfg, attention_fn=attention_fn)
        return jax_nll(logp, y, None, reduction="mean"), logp

    (_, logp), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return np.asarray(logp), jax.device_get(grads)


def _check_forward_and_grads(config, flash, remat, bf16):
    cfg_kwargs = dict(CONFIGS[config], **({"bf16": True} if bf16 else {}))
    params = _jax_params(CONFIGS[config], seed=1)
    x = _images(16, 3)
    y = np.random.RandomState(4).randint(0, 10, 16)
    attention_fn = pa.flash_attention if flash else jax_full_attention
    want_logp, want_grads = _jax_loss_and_grads(params, cfg_kwargs, jnp.asarray(x),
                                                jnp.asarray(y, jnp.int32), attention_fn)
    model = _port_vit(params, cfg_kwargs, flash=flash, remat=remat)
    logp = model(torch.tensor(x))
    nll_loss(logp, torch.tensor(y), reduction="mean").backward()
    assert logp.dtype == torch.float32
    logp_tol = dict(rtol=0, atol=BF16_LOGP_ATOL) if bf16 else LOGP_TOL
    np.testing.assert_allclose(logp.detach().numpy(), want_logp, **logp_tol)
    assert np.array_equal(logp.argmax(1).numpy(), want_logp.argmax(1))
    want = torch_vit_state_from_jax(want_grads)
    grad_tol = dict(rtol=0, atol=BF16_GRAD_ATOL) if bf16 else GRAD_TOL
    for name, p in model.named_parameters():
        assert p.dtype == p.grad.dtype == torch.float32
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), err_msg=name, **grad_tol)
    if remat:  # recomputation changes no value: equal to the run without it
        plain = _port_vit(params, cfg_kwargs, flash=flash)
        logp2 = plain(torch.tensor(x))
        nll_loss(logp2, torch.tensor(y), reduction="mean").backward()
        assert torch.equal(logp2, logp)
        for (_, a), (_, b) in zip(plain.named_parameters(), model.named_parameters()):
            assert torch.equal(a.grad, b.grad)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_vit_forward_and_grads_match_jax(config, flash, remat):
    _check_forward_and_grads(config, flash, remat, bf16=False)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("flash", [False, True], ids=["dense", "flash"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_bf16_vit_forward_and_grads_match_jax(config, flash, remat):
    """The bf16 axis of the test above: ViTConfig(bf16=True) in both
    packages (bf16 q/k/v into the flash kernel's bf16 mode)."""
    _check_forward_and_grads(config, flash, remat, bf16=True)


def test_vit_refuses_variants_not_ported():
    """No variant is left to refuse: the MoE variant is ported
    (``ViT(num_experts=E)`` builds and its forward returns ``(log_probs,
    aux)``, ``tests/test_torch_moe.py``), and so is the fused whole-run
    with its options (``tests/test_torch_fused_vit.py``), which the CLI
    takes with the JAX CLI's defaults."""
    logp, aux = ViT(ViTConfig(num_experts=4))(torch.zeros(2, 28, 28, 1))
    assert logp.shape == (2, 10) and aux.shape == ()
    for flag, dest, value in (("--fused", "fused", True), ("--pregather", "pregather", True),
                              ("--timings-json=x", "timings_json", "x")):
        args = vit_mnist.build_parser().parse_args([flag])
        want = jax_cli.build_parser().parse_args([flag])
        assert getattr(args, dest) == getattr(want, dest) == value


@pytest.fixture(scope="module")
def batches():
    images, labels = jax_mnist.synthetic_mnist("train", STEPS * BATCH)
    xs = jax_normalize(images).reshape(STEPS, BATCH, 28, 28, 1)
    ys = labels.astype(np.int64).reshape(STEPS, BATCH)
    return xs, ys


def _jax_single_device_losses(params, xs, ys, attention_fn, bf16=False):
    """The JAX CLI's single-device step (vit_mnist.py:570-582)."""
    cfg = jvit.ViTConfig(bf16=bf16)

    @jax.jit
    def step(params, opt, x, y, w, lr):
        def loss_fn(p):
            return jax_nll(jvit.vit_forward(p, x, cfg, attention_fn=attention_fn), y, w,
                           reduction="mean")

        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, opt = jax_adadelta_update(params, grads, opt, lr, 0.9, 1e-6)
        return params, opt, loss

    opt = jax_adadelta_init(params)
    w = jnp.ones(BATCH, jnp.float32)
    losses = []
    for x, y in zip(xs, ys):
        params, opt, loss = step(params, opt, jnp.asarray(x), jnp.asarray(y, jnp.int32), w,
                                 jnp.float32(1.0))
        losses.append(float(loss))
    return losses, jax.device_get(params)


def _jax_sp_losses(params, xs, ys, bf16=False):
    """JAX's (data, seq) step on a one-device mesh with the flash ring."""
    cfg = jvit.ViTConfig(bf16=bf16)
    mesh = jax_sp.make_sp_mesh(num_data=1, num_seq=1, devices=jax.devices()[:1])
    step = jax_sp.make_sp_train_step(mesh, cfg, use_flash=True)
    state = jax_ddp.replicate_params(jax_ddp.make_train_state(params), mesh)
    w = jnp.ones(BATCH, jnp.float32)
    losses = []
    for x, y in zip(xs, ys):
        state, loss = step(state, jnp.asarray(x), jnp.asarray(y, jnp.int32), w, jnp.float32(1.0))
        losses.append(float(loss[0]))
    return losses, jax.device_get(state.params)


def _trajectories(batches, path, bf16):
    """8 steps at lr 1.0 from the same weights on the same batches, in JAX
    and in the port: (port losses, JAX losses, port model, JAX params)."""
    xs, ys = batches
    params = _jax_params({}, seed=7)
    if path == "sp1_flash":
        jlosses, jparams = _jax_sp_losses(params, xs, ys, bf16)
    else:
        attention_fn = pa.flash_attention if path == "flash" else jax_full_attention
        jlosses, jparams = _jax_single_device_losses(params, xs, ys, attention_fn, bf16)

    model = _port_vit(params, {"bf16": bf16}, flash=path != "plain")
    state = TrainState(opt=adadelta_init(dict(model.named_parameters())))
    if path == "sp1_flash":
        step = sp.make_sp_train_step(model.cfg, use_flash=True)
    else:
        step = make_forward_train_step(lambda m, x: m(x))
    w = torch.ones(BATCH)
    losses = [float(step(model, state, torch.tensor(x), torch.tensor(y), w, 1.0))
              for x, y in zip(xs, ys)]
    assert state.step == STEPS
    assert losses[-1] < losses[0]
    return losses, jlosses, model, jparams


@pytest.mark.parametrize("path", ["plain", "flash", "sp1_flash"])
def test_trajectory_matches_jax(batches, path):
    """8 steps at lr 1.0 from the same weights on the same batches."""
    losses, jlosses, model, jparams = _trajectories(batches, path, bf16=False)
    np.testing.assert_allclose(losses, jlosses, rtol=2e-4, atol=2e-5)
    want = torch_vit_state_from_jax(jparams)
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=5e-3, err_msg=k)


@pytest.mark.parametrize("path", ["plain", "flash", "sp1_flash"])
def test_bf16_trajectory_matches_jax(batches, path):
    """The bf16 axis of the test above, against JAX's ViTConfig(bf16=True):
    the sp1_flash leg's JAX ring runs _partial_ref (p unrounded) off the
    TPU, the port's the kernel's contract (p rounded), one more bf16
    difference.  Parameters stay f32."""
    losses, jlosses, model, jparams = _trajectories(batches, path, bf16=True)
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=BF16_TRAJ_LOSS_ATOL)
    want = torch_vit_state_from_jax(jparams)
    for k, v in model.state_dict().items():
        assert v.dtype == torch.float32
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=BF16_TRAJ_PARAM_ATOL,
                                   err_msg=k)


def test_sp_eval_matches_single_device():
    """At degree 1 the ring's forward and eval totals equal the single
    device's (a group sum of one, the whole token slice)."""
    params = _jax_params({}, seed=2)
    x = torch.tensor(_images(32, 5))
    y = torch.tensor(np.random.RandomState(6).randint(0, 10, 32))
    w = torch.ones(32)
    for flash in (False, True):
        model = _port_vit(params, {}, flash=flash)
        got = sp.make_sp_eval_step(model.cfg, use_flash=flash)(model, x, y, w)
        ref = make_forward_eval_step(lambda m, x: m(x))(model, x, y, w)
        np.testing.assert_allclose(float(got[0]), float(ref[0]), rtol=1e-6)
        assert float(got[1]) == float(ref[1])


def _jax_refusal(fn, *args):
    with pytest.raises((ValueError, SystemExit)) as err:
        fn(*args)
    return str(err.value)


@pytest.mark.parametrize("case", ["tokens_by_3", "ulysses_heads_by_8", "sp_impl_without_sp",
                                  "ulysses_with_tp"])
def test_sp_refusals_are_jax_texts(case):
    """What replaced the refusal of every group of more than one: a token
    count --sp does not divide, Ulysses' heads, --sp-impl without --sp,
    and --sp-impl ulysses with --tp, each with the JAX package's text."""
    if case in ("tokens_by_3", "ulysses_heads_by_8"):
        impl, num_seq = ("ring", 3) if case == "tokens_by_3" else ("ulysses", 8)
        mesh = jax_sp.make_sp_mesh(1, num_seq, devices=jax.devices()[:num_seq])
        want = _jax_refusal(jax_sp._check_token_divisibility, jvit.ViTConfig(), mesh, impl)
        assert ("heads=4" in want) == (impl == "ulysses")  # 16 tokens split 8 ways
        assert _jax_refusal(sp.check_token_divisibility, ViTConfig(), num_seq, impl) == want
        return
    flags = ["--sp-impl", "ulysses"] + (["--sp", "2", "--tp", "2"] if case == "ulysses_with_tp"
                                        else [])
    want = _jax_refusal(jax_cli.resolve_mode_flags, jax_cli.build_parser().parse_args(flags))
    got = _jax_refusal(vit_mnist.resolve_mode_flags, vit_mnist.build_parser().parse_args(flags))
    assert got == want


def test_params_tree_round_trips_both_ways(tmp_path):
    """The port's npz is read by the JAX package's load_params_tree, and
    the JAX package's is read (and resumed from) by the port."""
    model = ViT(generator=torch.Generator().manual_seed(3))
    path = str(tmp_path / "port.npz")
    port_checkpoint.save_params_tree(jax_vit_tree_from_torch(model.state_dict()), path)
    tree = jax_checkpoint.load_params_tree(path)
    assert jax.tree.structure(tree) == jax.tree.structure(_jax_params({}))
    for k, v in torch_vit_state_from_jax(tree).items():
        assert torch.equal(v, model.state_dict()[k])

    params = _jax_params({}, seed=4)
    jpath = str(tmp_path / "jax.npz")
    jax_checkpoint.save_params_tree(params, jpath)
    got = port_checkpoint.load_params_tree(jpath)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        assert np.array_equal(a, b)
    resumed = ViT()
    vit_mnist._resume(resumed, jpath)
    for k, v in torch_vit_state_from_jax(params).items():
        assert torch.equal(resumed.state_dict()[k], v)
    assert sorted(os.listdir(tmp_path)) == ["jax.npz", "port.npz"]  # no temporaries left


def test_format_1_archive_with_qkv_is_refused(tmp_path):
    flat = port_checkpoint._flatten_raw(_jax_params({}))  # no __format__: format 1
    path = str(tmp_path / "old.npz")
    np.savez(path, **flat)
    with pytest.raises(ValueError, match="format-1"):
        port_checkpoint.load_params_tree(path)
    with pytest.raises(ValueError, match="format-1"):
        jax_checkpoint.load_params_tree(path)
    with pytest.raises(ValueError, match="format-1"):
        vit_mnist._resume(ViT(), path)


def test_resume_refuses_another_shape(tmp_path):
    path = str(tmp_path / "small.npz")
    small = ViT(ViTConfig(dim=32))
    port_checkpoint.save_params_tree(jax_vit_tree_from_torch(small.state_dict()), path)
    with pytest.raises(SystemExit, match="does not match"):
        vit_mnist._resume(ViT(), path)
    shallow = str(tmp_path / "shallow.npz")
    port_checkpoint.save_params_tree(
        jax_vit_tree_from_torch(ViT(ViTConfig(depth=1)).state_dict()), shallow)
    with pytest.raises(SystemExit, match="different model"):
        vit_mnist._resume(ViT(), shallow)


@pytest.mark.parametrize(
    "flags, sp_on",
    [([], False), (["--sp", "1"], False), (["--sp", "1", "--allow-degree-1"], True),
     (["--allow-degree-1"], False), (["--flash", "--remat"], False)],
)
def test_resolve_mode_flags(flags, sp_on):
    args = vit_mnist.build_parser().parse_args(flags)
    assert vit_mnist.resolve_mode_flags(args) == (sp_on, False)
    assert args.sp == 1 and args.tp == 1


@pytest.mark.parametrize("flags, message", [
    (["--sp", "0"], ">= 1"),
    (["--tp", "0"], ">= 1"),
    (["--tp", "2", "--remat"], "--remat rides"),
])
def test_resolve_mode_flags_refuses(flags, message):
    with pytest.raises(SystemExit, match=message):
        vit_mnist.resolve_mode_flags(vit_mnist.build_parser().parse_args(flags))


MODE_FLAGS = [
    [*sp_flags, *tp_flags, *deg, *impl, *remat]
    for sp_flags in ([], ["--sp", "1"], ["--sp", "2"], ["--sp", "0"])
    for tp_flags in ([], ["--tp", "1"], ["--tp", "2"])
    for deg in ([], ["--allow-degree-1"])
    for impl in ([], ["--sp-impl", "ulysses"])
    for remat in ([], ["--remat"])
]


@pytest.mark.parametrize("flags", MODE_FLAGS, ids=lambda f: " ".join(f) or "none")
def test_resolve_mode_flags_is_jax_truth_table(flags):
    """Every combination of --sp, --tp, --allow-degree-1, --sp-impl and
    --remat: the same (sp_on, tp_on) and degrees as the JAX CLI's
    resolve_mode_flags, or the same refusal text."""
    def resolve(cli):
        args = cli.build_parser().parse_args(flags)
        try:
            return cli.resolve_mode_flags(args), args.sp, args.tp
        except SystemExit as e:
            return str(e)

    assert resolve(vit_mnist) == resolve(jax_cli)


TRAIN_RE = r"^Train Epoch: (\d+) \[(\d+)/(\d+) \(\d+%\)\]\tLoss: (\S+)$"
TEST_RE = r"^Test set: Average loss: (\S+), Accuracy: (\d+)/(\d+) "


@pytest.mark.parametrize("flags", [["--flash"], ["--sp", "1", "--allow-degree-1", "--flash"],
                                   ["--bf16", "--flash"]],
                         ids=["flash", "sp1_flash", "bf16_flash"])
def test_cli_runs_end_to_end_on_the_cpu(tmp_path, flags):
    env = {k: v for k, v in os.environ.items() if k != "MNIST_DATA_DIR"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.vit_mnist", "--no-cuda",
         "--dry-run", "--epochs", "1", "--save-model", *flags],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    # Rebuild the expected stdout from the JAX package's own helpers and
    # the numbers the port printed.
    (epoch, seen, n, loss), = re.findall(TRAIN_RE, out, re.M)
    (avg, correct, n_test), = re.findall(TEST_RE, out, re.M)
    elapsed = re.search(r"^Total cost time:(\S+) ms$", out, re.M).group(1)
    want = ("MNIST IDX files unavailable (no local copy, download failed); "
            "using deterministic synthetic MNIST-like data\n")
    want += jax_logging.train_log_line(1, 0, 60000, 0, 938, float(loss)) + "\n"
    want += jax_logging.test_summary_lines(float(avg), int(correct), 10000) + "\n"
    want += jax_logging.total_time_line(float(elapsed)) + "\n"
    assert (epoch, seen, n, n_test) == ("1", "0", "60000", "10000")
    assert out == want
    tree = jax_checkpoint.load_params_tree(str(tmp_path / "vit_mnist.npz"))
    assert jax.tree.structure(tree) == jax.tree.structure(_jax_params({}))
    assert all(np.isfinite(a).all() for a in jax.tree.leaves(tree))
