"""``--elastic`` and ``--resume-reshard`` of the port's CNN trainer held
against the JAX trainer's contract on the CPU.

- ``--elastic`` (or ``ELASTIC_RESTART_COUNT`` > 0 in the environment): a
  run whose ``--save-state`` archive (or its ``.prev``) exists resumes it
  and reads ``--epochs`` as the total.  Run once with ``--epochs 1`` and
  again with ``--epochs 2``, it ends ``torch.equal`` to two epochs without
  a break (params, both accumulators, step); a third ``--epochs 2`` run
  trains no step.  Without an archive it starts fresh.
- ``--resume-reshard``: a mid-epoch archive saved by two gloo ranks
  (``tests/test_torch_family_ranks.py`` ``cnn_mid_epoch``) resumes at
  world size one with the same global batch: its remaining batches are
  the two ranks' (the samples of every global batch equal), and the run
  ends within the trajectory gates of the two ranks' own epoch (dropout
  off on both sides; parameters atol 5e-3).  Without the flag the JAX
  trainer's refusal, read from its source.
"""

from __future__ import annotations

import contextlib
import functools
import io
import os
import struct

import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu.data import mnist as jax_mnist
from pytorch_mnist_ddp_tpu_torch import trainer
from pytorch_mnist_ddp_tpu_torch.mnist import build_parser
from pytorch_mnist_ddp_tpu_torch.parallel.ddp import make_train_step
from pytorch_mnist_ddp_tpu_torch.parallel.sampler import epoch_indices
from pytorch_mnist_ddp_tpu_torch.utils import checkpoint as ckpt
from test_torch_family_ranks import family_tasks
from test_torch_launch import run_world
from test_torch_resume import _assert_same_run, assert_jax_text

LIMIT = 256  # 4 batches of 64 an epoch
RANK_BATCH, CURSOR = 32, 2  # the two ranks' batch, and where they save
PARAM_ATOL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread in this module: the suite runs several workers
    at once, and their threads would otherwise contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


@pytest.fixture(autouse=True)
def _idx_dir(monkeypatch, idx_root):
    monkeypatch.setenv("MNIST_DATA_DIR", str(idx_root))
    monkeypatch.delenv("ELASTIC_RESTART_COUNT", raising=False)


def _fit(*flags):
    args = build_parser().parse_args(["--train-limit", str(LIMIT), *flags])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        model, state = trainer.fit(args, "cpu")
    return model, state, out.getvalue()


@pytest.mark.parametrize("how", ["flag", "env"])
def test_elastic_resumes_its_own_archive_with_epochs_as_the_total(tmp_path, monkeypatch, how):
    path = str(tmp_path / "s.npz")
    flags = ["--save-state", path] + (["--elastic"] if how == "flag" else [])
    if how == "env":
        monkeypatch.setenv("ELASTIC_RESTART_COUNT", "1")
    full = _fit("--epochs", "2")
    first = _fit("--epochs", "1", *flags)  # no archive yet: a fresh run
    assert "Train Epoch: 1 " in first[2] and first[1].step == 4
    second = _fit("--epochs", "2", *flags)
    assert "Train Epoch: 2 " in second[2] and "Train Epoch: 1 " not in second[2]
    _assert_same_run(full[:2], second[:2])
    third = _fit("--epochs", "2", *flags)  # the run is complete: no step
    assert "Train Epoch" not in third[2] and third[1].step == full[1].step
    _assert_same_run(full[:2], third[:2])
    assert ckpt.load_train_state_full(path)[1] == 2


def test_elastic_reads_the_prev_rotation(tmp_path):
    path = str(tmp_path / "s.npz")
    _fit("--epochs", "1", "--save-state", path)
    os.replace(path, path + ckpt.PREV_SUFFIX)
    _, state, out = _fit("--epochs", "2", "--save-state", path, "--elastic")
    assert "Train Epoch: 2 " in out and "Train Epoch: 1 " not in out and state.step == 8


def test_elastic_does_not_replace_an_explicit_resume_state(tmp_path):
    """With --resume-state given, --epochs stays "more epochs"."""
    saved, other = str(tmp_path / "s.npz"), str(tmp_path / "o.npz")
    _fit("--epochs", "1", "--save-state", saved)
    _, state, out = _fit("--epochs", "1", "--resume-state", saved, "--save-state", other,
                         "--elastic")
    assert "Train Epoch: 2 " in out and state.step == 8


# -- --resume-reshard ---------------------------------------------------------------


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory, idx_root):
    tmp = tmp_path_factory.mktemp("reshard")
    path = str(tmp / "mid.npz")
    flags = ["--batch-size", str(RANK_BATCH), "--train-limit", str(LIMIT)]
    ranks = run_world(family_tasks, 2, tmp, [
        ("mid", "cnn_mid_epoch", [], dict(flags=flags, data_dir=str(idx_root), cursor=CURSOR,
                                          path=path))])
    return path, [r["mid"] for r in sorted(ranks, key=lambda r: r["rank"])]


def _resume_at_one(path, monkeypatch, *flags):
    # dropout off, as on the two ranks
    monkeypatch.setattr(trainer, "make_train_step", functools.partial(make_train_step,
                                                                      dropout=False))
    return _fit("--batch-size", str(2 * RANK_BATCH), "--epochs", "1", "--log-interval", "1",
                "--resume-state", path, *flags)


def test_reshard_without_the_flag_is_the_jax_refusal(two_ranks, monkeypatch):
    path, _ = two_ranks
    extras = ckpt.load_train_state_full(path)[2]
    assert (extras["world_size"], extras["global_batch"], extras["batch_cursor"]) == (
        2, 2 * RANK_BATCH, CURSOR)
    with pytest.raises(ValueError) as err:
        _resume_at_one(path, monkeypatch)
    assert "pass --resume-reshard" in str(err.value)
    assert_jax_text(str(err.value))


def test_reshard_consumes_the_same_global_batches(two_ranks):
    """Every global batch from the cursor on holds the same samples at
    world size one as over the two ranks (the sampler's contract)."""
    _, ranks = two_ranks
    one = epoch_indices(LIMIT, 1, 0, 1, seed=1)
    for b in range(CURSOR, LIMIT // (2 * RANK_BATCH)):
        rows = slice(b * RANK_BATCH, (b + 1) * RANK_BATCH)
        two = np.concatenate([r["indices"][rows] for r in ranks])
        assert sorted(two) == sorted(one[b * 2 * RANK_BATCH:(b + 1) * 2 * RANK_BATCH]), b


def test_reshard_continues_within_the_trajectory_gates(two_ranks, monkeypatch):
    path, ranks = two_ranks
    model, state, out = _resume_at_one(path, monkeypatch, "--resume-reshard")
    assert state.step == ranks[0]["step"] == LIMIT // (2 * RANK_BATCH)
    # batch numbering goes on from the cursor, 64 samples a step
    assert "Train Epoch: 1 [128/256 (50%)]" in out and "Train Epoch: 1 [0/256" not in out
    assert all(np.array_equal(v, ranks[1]["state"][k]) for k, v in ranks[0]["state"].items())
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), ranks[0]["state"][k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)
