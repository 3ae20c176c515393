"""The port's ``tools/step_attr_bench.py`` (``python -m
pytorch_mnist_ddp_tpu_torch.tools.step_attr_bench``) held against the JAX
package's ``tools/step_attr_bench.py``, on the CPU.

- ``RUNG_NAMES`` is JAX's, and so are the ladder's inputs.
- ``--budget-s 0`` prints one parseable partial line with every rung
  skipped, and a SIGTERM mid-ladder flushes the rungs measured so far and
  exits 124 (``tests/test_bench.py``'s two contracts).
- With JAX's parameters carried across by ``utils/convert.py``, the
  port's ``fwd``, ``fwd_bwd``, ``full_nodrop`` and ``eval`` accumulators
  over 3 iterations of batch 8 equal JAX's ``Net`` + ``nll_loss`` +
  ``adadelta_update`` over the same batches, within the f32 trajectory
  gates of ``tests/test_trajectory.py`` (rtol 2e-4, atol 2e-5).  The
  dropout rungs are left out: ``jax.random`` and ``torch.Generator``
  draw different masks by design.

One intra-op thread.
"""

from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import signal
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu.models.net import Net as JaxNet
from pytorch_mnist_ddp_tpu.models.net import init_params
from pytorch_mnist_ddp_tpu.ops.adadelta import adadelta_init, adadelta_update
from pytorch_mnist_ddp_tpu.ops.loss import nll_loss
from pytorch_mnist_ddp_tpu.parallel.fused import _normalize_dev
from pytorch_mnist_ddp_tpu_torch.models.net import Net
from pytorch_mnist_ddp_tpu_torch.tools import step_attr_bench
from pytorch_mnist_ddp_tpu_torch.utils.convert import torch_state_from_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
STEPS, BATCH, ROWS = 3, 8, 64
LOSS_RTOL, LOSS_ATOL = 2e-4, 2e-5  # tests/test_trajectory.py, the f32 leg


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_step_attr",
                                                  ROOT / "tools" / "step_attr_bench.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_rung_names_are_jax_s():
    assert step_attr_bench.RUNG_NAMES == _jax_tool().RUNG_NAMES


def test_ladder_inputs_are_jax_s():
    """The JAX tool's inputs, from RandomState(0), at its default size."""
    steps, batch = 300, 200
    rng = np.random.RandomState(0)
    images = rng.randint(0, 256, (60000, 28, 28), dtype=np.uint8)
    labels = rng.randint(0, 10, 60000).astype(np.int32)
    idx = np.arange(steps * batch) % 60000
    perm = rng.permutation(60000)[idx].reshape(steps, batch)
    got = step_attr_bench.ladder_data(steps, batch)
    for name, want in (("images", images), ("labels", labels), ("perm", perm)):
        assert got[name].dtype == want.dtype and np.array_equal(got[name], want), name


# -- JAX's rung bodies over the same batches ----------------------------------------

def _jax_accumulators(params, data) -> dict[str, float]:
    """The JAX tool's fwd, fwd_bwd, full_nodrop and eval bodies, STEPS
    iterations each (its scan bodies, stepped by a Python loop)."""
    model = JaxNet(compute_dtype=jnp.float32, conv_impl="conv")
    images, labels = jnp.asarray(data["images"]), jnp.asarray(data["labels"])
    perm = jnp.asarray(data["perm"])
    fixed_x = _normalize_dev(images[:BATCH], jnp.float32)
    fixed_y = labels[:BATCH]
    w = jnp.ones((BATCH,), jnp.float32)

    def loss_of(p, x, y):
        logp = model.apply({"params": p}, x, train=False)
        return nll_loss(logp, y, w, reduction="mean")

    out = {}
    carry = jnp.float32(0.0)
    for _ in range(STEPS):
        carry = carry + loss_of(params, fixed_x + carry * jnp.float32(1e-30), fixed_y)
    out["fwd"] = carry
    carry = jnp.float32(0.0)
    for _ in range(STEPS):
        loss, grads = jax.value_and_grad(loss_of)(params, fixed_x + carry * jnp.float32(1e-30),
                                                  fixed_y)
        carry = carry + loss + jax.tree.leaves(grads)[0].sum()
    out["fwd_bwd"] = carry
    p, o, acc = params, adadelta_init(params), jnp.float32(0.0)
    for i in range(STEPS):
        x = _normalize_dev(jnp.take(images, perm[i], axis=0), jnp.float32)
        y = jnp.take(labels, perm[i], axis=0)
        loss, grads = jax.value_and_grad(loss_of)(p, x, y)
        p, o = adadelta_update(p, grads, o, jnp.float32(1.0), 0.9, 1e-6)
        acc = acc + loss
    out["full_nodrop"] = acc
    loss_sum, correct = jnp.float32(0.0), jnp.float32(0.0)
    wv = jnp.ones((BATCH,), jnp.float32)
    for i in range(STEPS):
        x = _normalize_dev(images[i * BATCH:(i + 1) * BATCH], jnp.float32)
        y = labels[i * BATCH:(i + 1) * BATCH]
        logp = model.apply({"params": params}, x, train=False)
        loss_sum += nll_loss(logp, y, wv, reduction="sum")
        correct += ((jnp.argmax(logp, axis=1) == y) * wv).sum()
    out["eval"] = loss_sum + correct
    return {k: float(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def both():
    params = jax.device_get(init_params(jax.random.PRNGKey(3)))
    data = step_attr_bench.ladder_data(STEPS, BATCH, rows=ROWS)
    model = Net()
    model.load_state_dict(torch_state_from_jax(params))
    ladder = step_attr_bench.make_ladder(model, data, steps=STEPS, batch=BATCH,
                                         eval_batch=BATCH, eval_steps=STEPS)
    return ladder, _jax_accumulators(params, data)


@pytest.mark.parametrize("rung", ["fwd", "fwd_bwd", "full_nodrop", "eval"])
def test_deterministic_rungs_match_jax(both, rung):
    ladder, want = both
    got = float(ladder[rung](STEPS))
    np.testing.assert_allclose(got, want[rung], rtol=LOSS_RTOL, atol=LOSS_ATOL)


def test_the_ladder_leaves_the_model_and_repeats(both):
    """The non-training rungs leave the model as it is (a rung run twice
    gives the same accumulator); each full rung trains its own copy."""
    ladder, _ = both
    for rung in ("fwd", "fwd_bwd", "eval"):
        assert float(ladder[rung](STEPS)) == float(ladder[rung](STEPS))
    assert ladder["full"].generator is not None and ladder["full_nodrop"].generator is None
    assert set(ladder) == set(step_attr_bench.RUNG_NAMES)


# -- the CLI's partial contracts -----------------------------------------------------

def _cli(*argv):
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    return [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.tools.step_attr_bench",
            "--device", "cpu", *argv], env


def test_budget_zero_emits_parseable_partial():
    cmd, env = _cli("--allow-cpu", "--steps", "2", "--batch", "4", "--eval-steps", "1",
                    "--eval-batch", "4", "--reps", "1", "--budget-s", "0")
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip())
    assert out["partial"] is True and out["metric"] == "step_attr_us"
    assert len(out["skipped"]) == 10
    assert not any(isinstance(v, float) for v in out.values())


def test_cpu_without_allow_cpu_is_jax_s_error():
    cmd, env = _cli()
    proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 1
    assert json.loads(proc.stdout) == {"metric": "step_attr_us", "error": "cpu backend (no TPU)"}


def test_unknown_rung_is_an_error():
    assert step_attr_bench.main(["--device", "cpu", "--allow-cpu", "--steps", "1", "--batch",
                                 "2", "--only", "full,warp"]) == 2


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        step_attr_bench.main(["--steps", "1"])


def test_sigterm_flushes_partial():
    """A SIGTERM mid-ladder flushes the rungs measured so far as one
    parseable line and exits 124."""
    cmd, env = _cli("--allow-cpu", "--steps", "20", "--batch", "64", "--eval-steps", "2",
                    "--eval-batch", "64", "--reps", "1")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env)
    first_rung_seen = threading.Event()
    stderr_lines = []

    def _watch_stderr():
        for line in proc.stderr:
            stderr_lines.append(line)
            if line.startswith("[rung] full:"):
                first_rung_seen.set()

    reader = threading.Thread(target=_watch_stderr, daemon=True)
    reader.start()
    try:
        ok = first_rung_seen.wait(timeout=120)
        assert ok and proc.poll() is None, "".join(stderr_lines)[-2000:]
        proc.send_signal(signal.SIGTERM)
        stdout, _ = proc.communicate(timeout=90)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 124
    out = json.loads(stdout.strip())
    assert out["partial"] is True
    assert isinstance(out["full"], float)
