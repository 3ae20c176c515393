"""The port's ``tools/train_chaos.py`` (``python -m
pytorch_mnist_ddp_tpu_torch.tools.train_chaos``) held against the JAX
package's ``tools/train_chaos.py``, on the CPU.

- The IDX files the twin writes are byte-equal to those of JAX's
  ``_write_synthetic_idx``.
- The twin's archive comparisons and the JAX tool's agree, problem line
  for problem line, on archives written by both packages and on altered
  copies of them.
- One kill round (``--device cpu --synthetic 512 --epochs 1 --kill-steps 4
  --nan-step -1``: 8 steps at batch 64) passes bit-exact; the default
  schedule and a two-rank gloo gang are the slow runs, as in JAX.

The trainers run in processes of their own with one intra-op thread.
"""

from __future__ import annotations

import importlib.util
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu.models.net import init_params
from pytorch_mnist_ddp_tpu.parallel import ddp as jax_ddp
from pytorch_mnist_ddp_tpu.utils import checkpoint as jax_ckpt
from pytorch_mnist_ddp_tpu_torch.models.net import Net
from pytorch_mnist_ddp_tpu_torch.parallel.ddp import make_train_state
from pytorch_mnist_ddp_tpu_torch.tools import train_chaos
from pytorch_mnist_ddp_tpu_torch.utils import checkpoint as ckpt
from pytorch_mnist_ddp_tpu_torch.utils.convert import torch_state_from_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
IDX = ("train-images-idx3-ubyte", "train-labels-idx1-ubyte", "t10k-images-idx3-ubyte",
       "t10k-labels-idx1-ubyte")


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_train_chaos",
                                                  ROOT / "tools" / "train_chaos.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX = _jax_tool()


@pytest.mark.parametrize("n_train, n_test", [(64, 32), (768, 256)])
def test_idx_files_are_jax_s(tmp_path, n_train, n_test):
    JAX._write_synthetic_idx(str(tmp_path / "jax"), n_train, n_test)
    train_chaos._write_synthetic_idx(str(tmp_path / "port"), n_train, n_test)
    for name in IDX:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


# -- the archive comparisons, on archives of both packages -----------------------

def _rewrite(src: pathlib.Path, dst: pathlib.Path, change) -> str:
    with np.load(src) as z:
        arrays = {k: z[k] for k in z.files}
    change(arrays)
    np.savez(dst, **arrays)
    return str(dst)


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    """The same state written by each package, and altered copies."""
    d = tmp_path_factory.mktemp("archives")
    params = jax.device_get(init_params(jax.random.PRNGKey(7)))
    jax_ckpt.save_train_state(jax_ddp.make_train_state(params), str(d / "jax.npz"), epoch=1)
    net = Net()
    net.load_state_dict(torch_state_from_jax(params))
    state = make_train_state(net)
    ckpt.save_train_state(dict(net.named_parameters()), state.opt, state.step,
                          str(d / "port.npz"), epoch=1, extras={"batch_cursor": 3})
    port = d / "port.npz"

    def nudge(a):
        a["params.fc2.bias"] = a["params.fc2.bias"] + np.float32(1e-3)

    def drop(a):
        del a["params.fc2.bias"]

    def recast(a):
        a["params.fc2.bias"] = a["params.fc2.bias"].astype(np.float64)

    return {"jax": str(d / "jax.npz"), "port": str(port),
            "nudged": _rewrite(port, d / "nudged.npz", nudge),
            "dropped": _rewrite(port, d / "dropped.npz", drop),
            "recast": _rewrite(port, d / "recast.npz", recast)}


PAIRS = [("jax", "port"), ("port", "jax"), ("port", "nudged"), ("jax", "dropped"),
         ("recast", "port")]


@pytest.mark.parametrize("a, b", PAIRS, ids=[f"{a}-{b}" for a, b in PAIRS])
def test_archive_comparisons_agree_with_jax(archives, a, b):
    pa, pb = archives[a], archives[b]
    got = train_chaos._archives_bit_equal(pa, pb)
    assert got == JAX._archives_bit_equal(pa, pb)
    assert (got == []) == ((a, b) in (("jax", "port"), ("port", "jax")))
    for atol in (1e-4, 1e-2):
        assert train_chaos._archives_close(pa, pb, atol) == JAX._archives_close(pa, pb, atol)
    assert train_chaos._epochs_completed(pa) == JAX._epochs_completed(pa) == 1


def test_curve_checks_agree_with_jax():
    base = {(1, 0): 2.3, (1, 1): 2.1, (1, 2): float("nan")}
    for sub in ({(1, 0): 2.3}, {(1, 1): 2.0}, {(1, 2): float("nan")}, {(2, 0): 1.0}):
        assert (train_chaos._curve_subset_of(sub, base, "c")
                == JAX._curve_subset_of(sub, base, "c"))
        assert (train_chaos._curve_close_to(sub, base, "c", 0.15)
                == JAX._curve_close_to(sub, base, "c", 0.15))


# -- the harness itself, in processes of its own ---------------------------------

def _run(tmp_path, *argv, timeout=600):
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    return subprocess.run(
        [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.tools.train_chaos", "--device", "cpu",
         "--workdir", str(tmp_path / "work"), *argv],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=timeout)


def test_a_kill_round_resumes_bit_exact(tmp_path):
    proc = _run(tmp_path, "--synthetic", "512", "--epochs", "1", "--kill-steps", "4",
                "--nan-step", "-1", timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert "  baseline: 1 epoch(s), 8 steps" in "\n".join(lines)
    assert [ln for ln in lines if ln.startswith(("PASS", "FAIL"))] == [
        "PASS kill@step4: resumed run bit-identical to baseline"]
    killed = tmp_path / "work" / "kill@step4"
    assert (killed / "final.npz").exists() and (killed / "state.npz").exists()


def test_a_kill_step_past_the_run_is_skipped_and_nothing_ran_fails(tmp_path):
    """JAX's schedule rules: a kill step at or past the last step never
    fires, and a run with no round exits 1."""
    proc = _run(tmp_path, "--synthetic", "128", "--epochs", "1", "--kill-steps", "2",
                "--nan-step", "-1", timeout=300)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "note: kill step 2 outside the run's 2 steps" in proc.stdout
    assert "train_chaos: nothing ran (empty schedule?)" in proc.stdout


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_chaos.main(["--device", "cuda", "--workdir", "unused"])


@pytest.mark.slow  # six trainer processes (~50 s on the CPU), as JAX's default schedule
def test_default_schedule_passes(tmp_path):
    proc = _run(tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert [ln.split(":")[0] for ln in proc.stdout.splitlines()
            if ln.startswith(("PASS", "FAIL"))] == [
        "PASS kill@step4", "PASS kill@step9", "PASS kill@ckpt_save", "PASS nan@step5"]


@pytest.mark.slow  # a two-rank gloo gang through the launcher, four worlds (~30 s)
def test_two_rank_gloo_gang(tmp_path):
    proc = _run(tmp_path, "--distributed", "--nproc", "2")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    verdicts = [ln for ln in proc.stdout.splitlines() if ln.startswith(("PASS", "FAIL"))]
    assert verdicts == ["PASS gang-kill[kill:step:rank=1:after=4]", "PASS gang-budget0",
                        "PASS reshard-resume"]
