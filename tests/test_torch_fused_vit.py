"""The port's fused ViT (``parallel/fused_vit.py``, ``vit_mnist.py
--fused``) held against the JAX package's ``make_fused_vit_run`` and
against the port's own per-batch ViT, on the CPU, at a small width
(``ViTConfig(depth=1, dim=32)``, 4 heads) on seeded numpy rows.

- JAX's four ``tests/test_fused_vit.py`` cases: two fused epochs against
  JAX's fused run on its permutation (``jax.random.permutation(
  jax.random.fold_in(key, epoch), n)``, passed through ``perm=``), within
  the port's ViT trajectory gate (``tests/test_torch_vit.py``: losses
  rtol 2e-4 / atol 2e-5, parameters atol 5e-3; eval totals rtol 1e-4,
  ``correct`` equal); ``--zero`` on two gloo ranks against JAX's
  two-device ``zero=True`` run (the rank program is
  ``test_torch_family_ranks.fused_vit_ranks``); the masked partial
  batches; ``pregather`` ``torch.equal`` to the gather.
- The port's own: the fused epoch ``torch.equal`` to the per-batch steps
  on the same batches (f32 and ``--bf16``); ``vit_mnist.fit --fused``
  printing the per-batch run's lines and ending on its bits on an IDX
  set (plain, ``--zero``, ``--bf16``, ``--remat``); ``--save-state`` /
  ``--resume-state`` through the fused path with archives crossing
  ``--zero`` and plain; ``--timings-json``'s keys (JAX's) and types;
  ``--dry-run`` demoting ``--fused``.
- ``utils/flops.py`` equal to JAX's, and ``gpu_peak_flops``.
- ``tools/vit_bench.py``: its row and MFU with the subprocesses stubbed,
  and one real ``--device cpu`` run of a per-batch mode.

On the CPU the steps run eagerly: only the card captures a graph
(``chip_smoke.py``'s ``vit_fused`` phase).  One intra-op thread.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import struct
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu.data import mnist as jax_mnist
from pytorch_mnist_ddp_tpu.models import vit as jvit
from pytorch_mnist_ddp_tpu.parallel import ddp as jax_ddp
from pytorch_mnist_ddp_tpu.parallel import fused_vit as jax_fused_vit
from pytorch_mnist_ddp_tpu.parallel.mesh import make_mesh
from pytorch_mnist_ddp_tpu.parallel.zero import make_zero_train_state
from pytorch_mnist_ddp_tpu.utils import flops as jax_flops
from pytorch_mnist_ddp_tpu_torch import vit_mnist
from pytorch_mnist_ddp_tpu_torch.data.loader import DataLoader
from pytorch_mnist_ddp_tpu_torch.data.transforms import normalize
from pytorch_mnist_ddp_tpu_torch.models.vit import ViT, ViTConfig
from pytorch_mnist_ddp_tpu_torch.ops.adadelta import adadelta_init
from pytorch_mnist_ddp_tpu_torch.ops.loss import nll_loss
from pytorch_mnist_ddp_tpu_torch.parallel import fused
from pytorch_mnist_ddp_tpu_torch.parallel.ddp import TrainState, make_forward_train_step
from pytorch_mnist_ddp_tpu_torch.parallel.fused_vit import make_fused_vit_run
from pytorch_mnist_ddp_tpu_torch.tools import vit_bench
from pytorch_mnist_ddp_tpu_torch.utils import flops
from pytorch_mnist_ddp_tpu_torch.utils.convert import torch_vit_state_from_jax
from test_torch_family_ranks import fused_vit_ranks
from test_torch_launch import run_world

CFG = {"depth": 1, "dim": 32}
N, N_TEST, BATCH = 150, 70, 32  # 5 steps, the last with 22 real rows; 3 eval batches
KEY = jax.random.PRNGKey(5)
LRS = (1.0, 0.7)
LOSS_RTOL, LOSS_ATOL, PARAM_ATOL, EVAL_RTOL = 2e-4, 2e-5, 5e-3, 1e-4
LIMIT = 200  # fit(): 4 steps of 64 a train epoch, the last with 8 real rows
# vit_mnist.py's fused branch (its `timings` dict), in its order
JAX_TIMINGS_KEYS = ("dataset", "compile_s", "data_s", "run_s", "train_size", "test_size",
                    "epochs", "n_shards", "depth", "dim", "epoch1_test_accuracy",
                    "final_test_accuracy")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dataset(n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (n, 28, 28)).astype(np.uint8), rng.randint(0, 10, n).astype(np.int64)


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(jvit.init_vit_params(jax.random.PRNGKey(0), jvit.ViTConfig(**CFG)))


def _perm(n: int, epoch: int) -> np.ndarray:
    return np.asarray(jax.random.permutation(jax.random.fold_in(KEY, epoch), n))


def _jax_run(params, train, test, epochs: int, devices: int = 1, zero: bool = False,
             pregather: bool = False):
    """JAX's fused ViT run from ``params``: losses ``[epochs, steps,
    devices]``, eval totals ``[epochs, 2]`` and the parameters in torch's
    layout."""
    mesh = make_mesh(num_data=devices, devices=jax.devices()[:devices])
    run_fn, _ = jax_fused_vit.make_fused_vit_run(
        mesh, jvit.ViTConfig(**CFG), len(train[0]), len(test[0]), BATCH * devices,
        BATCH * devices, epochs, pregather=pregather, zero=zero)
    state = (make_zero_train_state(params, mesh) if zero
             else jax_ddp.replicate_params(jax_ddp.make_train_state(params), mesh))
    state, losses, evals = run_fn(state, *jax_fused_vit.device_put_dataset(*train, mesh),
                                  *jax_fused_vit.device_put_dataset(*test, mesh), KEY,
                                  jnp.asarray(LRS[:epochs], jnp.float32))
    return (np.asarray(losses), np.asarray(evals),
            torch_vit_state_from_jax(jax.device_get(state.params)))


def _port_model(jax_params) -> ViT:
    model = ViT(ViTConfig(**CFG))
    model.load_state_dict(torch_vit_state_from_jax(jax_params))
    return model


def _port_run(jax_params, train, test, epochs: int, pregather: bool = False):
    """The port's fused run on JAX's permutations: losses ``[epochs,
    steps, 1]``, eval totals ``[epochs, 2]``, the model and the run."""
    model = _port_model(jax_params)
    state = TrainState(opt=adadelta_init(dict(model.named_parameters())))
    run = make_fused_vit_run(model, state, DataLoader(*train, BATCH, "cpu"),
                             DataLoader(*test, BATCH, "cpu", shuffle=False, mask_padding=True),
                             pregather=pregather)
    losses, evals = [], []
    for e in range(1, epochs + 1):
        losses.append(run.train.epoch(e, LRS[e - 1], perm=_perm(len(train[0]), e)).numpy())
        evals.append(fused.eval_totals(run.eval(model).numpy()))
    assert run.train.graph is None and run.train.eager_steps == state.step
    return np.stack(losses), np.asarray(evals), model, run


def _hold(losses, evals, params: dict, want_losses, want_evals, want_params: dict) -> None:
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    np.testing.assert_allclose(evals[:, 0], want_evals[:, 0], rtol=EVAL_RTOL)
    assert np.array_equal(evals[:, 1], want_evals[:, 1])
    for k, want in want_params.items():
        np.testing.assert_allclose(np.asarray(params[k]), want.numpy(), rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


# -- against JAX's make_fused_vit_run ------------------------------------------

@pytest.fixture(scope="module")
def two_epochs(jax_params):
    """JAX's and the port's two fused epochs on N training rows (the last
    batch 22 real rows) and N_TEST test rows (the last eval batch 6)."""
    train, test = _dataset(N, 0), _dataset(N_TEST, 1)
    return test, _jax_run(jax_params, train, test, 2), _port_run(jax_params, train, test, 2)


def test_two_fused_epochs_match_jax(two_epochs):
    _, want, (losses, evals, model, run) = two_epochs
    assert losses.shape == want[0].shape == (2, 5, 1) and run.train.state.step == 10
    _hold(losses, evals, {k: v.detach() for k, v in model.state_dict().items()}, *want)
    assert losses[1, -1, 0] < losses[0, 0, 0]


def test_zero_on_two_gloo_ranks_matches_jax_two_device_run(jax_params, tmp_path):
    """``--fused --zero`` on two gloo ranks (every rank on the data axis,
    ``batch`` rows each) against JAX's two-device ``zero=True`` run, and
    the port's plain fused run in the same world within the same gates."""
    train, test = _dataset(N + 64, 3), _dataset(N_TEST, 4)  # 4 global steps of 64, 22 real last
    want = _jax_run(jax_params, train, test, 2, devices=2, zero=True)
    state = {k: v.numpy() for k, v in torch_vit_state_from_jax(jax_params).items()}
    ranks = run_world(fused_vit_ranks, 2, tmp_path, state, CFG, train, test,
                      [_perm(len(train[0]), e) for e in (1, 2)], BATCH, list(LRS))
    for run in ("zero", "plain"):
        got = [r[run] for r in ranks]
        assert np.array_equal(got[0]["losses"], got[1]["losses"])  # gathered on every rank
        assert np.array_equal(got[0]["evals"], got[1]["evals"])
        assert all(torch.equal(got[0]["state"][k], got[1]["state"][k]) for k in state)
        assert got[0]["losses"].shape == (2, 4, 2) and got[0]["step"] == 8
        _hold(got[0]["losses"], got[0]["evals"], got[0]["state"], *want)


def test_masked_partial_batches_count_every_real_row_once(two_epochs):
    """The wrap-filled rows weigh 0 (the last training batch has 22 real
    rows of 32), and the eval counts each real test row once: the last
    epoch's totals are the trained model's own over the whole test set."""
    test, _, (_, evals, model, run) = two_epochs
    assert run.train.w.sum(1).tolist() == [32.0] * 4 + [22.0]
    assert run.eval.w.sum(1).tolist() == [32.0, 32.0, 6.0]
    with torch.no_grad():
        model.eval()
        logp = model(torch.from_numpy(normalize(test[0])))
    y = torch.from_numpy(test[1])
    assert evals[-1, 1] == int((logp.argmax(1) == y).sum())
    np.testing.assert_allclose(evals[-1, 0], float(nll_loss(logp, y, reduction="sum")),
                               rtol=1e-5)


def test_pregather_is_bit_identical_to_the_gather(jax_params):
    train, test = _dataset(56, 7), _dataset(24, 8)  # 56 % 32 != 0: the wrap
    a = _port_run(jax_params, train, test, 2)
    b = _port_run(jax_params, train, test, 2, pregather=True)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert all(torch.equal(x, y) for x, y in zip(a[2].parameters(), b[2].parameters()))


# -- against the port's per-batch ViT --------------------------------------------

@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_fused_epoch_equals_the_per_batch_steps(bf16):
    """One fused epoch (the loader's own batches) ``torch.equal`` to the
    per-batch step over ``loader.epoch(1)``: losses, parameters and
    accumulators."""
    cfg = ViTConfig(bf16=bf16, **CFG)
    images, labels = _dataset(N, 9)
    loader = DataLoader(images, labels, BATCH, "cpu", seed=1)
    test = DataLoader(*_dataset(N_TEST, 1), BATCH, "cpu", shuffle=False, mask_padding=True)
    init = ViT(cfg, generator=torch.Generator().manual_seed(3)).state_dict()
    models, states = [], []
    for _ in range(2):
        model = ViT(cfg)
        model.load_state_dict(init)
        models.append(model)
        states.append(TrainState(opt=adadelta_init(dict(model.named_parameters()))))
    step = make_forward_train_step(lambda m, x: m(x))
    eager = torch.stack([step(models[0], states[0], x, y, w, 1.0) for x, y, w in loader.epoch(1)])
    losses = make_fused_vit_run(models[1], states[1], loader, test).train.epoch(1, 1.0)
    assert torch.equal(eager, losses[:, 0]) and states[0].step == states[1].step == 5
    assert all(torch.equal(a, b) for a, b in zip(models[0].parameters(), models[1].parameters()))
    for ta, tb in zip(states[0].opt, states[1].opt):
        assert all(torch.equal(ta[k], tb[k]) for k in ta)


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


def _fit(idx_root, *flags, timings: dict | None = None):
    args = vit_mnist.build_parser().parse_args(
        ["--data-root", str(idx_root), "--log-interval", "2", "--test-batch-size", "64",
         "--depth", "1", "--dim", "32", *flags])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        model, state = vit_mnist.fit(args, vit_mnist.resolve_mode_flags(args), "cpu",
                                     timings=timings)
    return model, state, out.getvalue()


def _assert_same(a, b) -> None:
    (ma, sa), (mb, sb) = a[:2], b[:2]
    assert sa.step == sb.step
    for (ka, pa), (kb, pb) in zip(ma.named_parameters(), mb.named_parameters(), strict=True):
        assert ka == kb and torch.equal(pa, pb), ka
    assert type(sa.opt) is type(sb.opt)
    for ta, tb in zip(sa.opt, sb.opt):
        if isinstance(ta, dict):
            assert all(torch.equal(ta[k], tb[k]) for k in ta)
        else:
            assert torch.equal(ta, tb)


@pytest.mark.parametrize("flags", [[], ["--zero"], ["--bf16"], ["--remat"]],
                         ids=["plain", "zero", "bf16", "remat"])
def test_fit_fused_prints_the_per_batch_lines_and_bits(idx_root, flags):
    timings = {}
    got = _fit(idx_root, "--epochs", "2", "--fused", *flags, timings=timings)
    want = _fit(idx_root, "--epochs", "2", *flags)
    assert got[2] == want[2] and got[2].count("Test set:") == 2
    _assert_same(got, want)
    assert got[1].step == 8 and timings["epoch_steps"] == [4, 4]
    assert timings["host_syncs"] == 2 and timings["replays"] == 0


@pytest.mark.parametrize("saved,resumed", [(["--zero"], []), ([], ["--zero"])],
                         ids=["zero_to_plain", "plain_to_zero"])
def test_fused_archives_cross_zero_and_plain(idx_root, tmp_path, saved, resumed):
    """A fused epoch's ``--save-state`` archive is the per-batch epoch's,
    array for array (per leaf under ``--zero`` too), and resumed fused in
    the other mode it ends on the bits of the per-batch two epochs of
    that mode (a world of one: ZeRO-1's step is the plain one), its lines
    those of their second epoch."""
    path, own = str(tmp_path / "fused.npz"), str(tmp_path / "per_batch.npz")
    _fit(idx_root, "--epochs", "1", "--fused", "--save-state", path, *saved)
    _fit(idx_root, "--epochs", "1", "--save-state", own, *saved)
    with np.load(path) as a, np.load(own) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files)
    got = _fit(idx_root, "--epochs", "1", "--fused", "--resume-state", path, *resumed)
    whole = _fit(idx_root, "--epochs", "2", *resumed)
    assert "Train Epoch: 2 " in got[2] and "Train Epoch: 1 " not in got[2]
    assert got[2] in whole[2]
    _assert_same(got, whole)


def test_timings_json_has_jax_keys_and_types(idx_root, tmp_path):
    path = tmp_path / "t.json"
    _fit(idx_root, "--epochs", "2", "--fused", "--timings-json", str(path))
    t = json.loads(path.read_text())
    assert tuple(t) == vit_mnist.TIMINGS_KEYS == JAX_TIMINGS_KEYS
    assert t["dataset"] == "idx" and (t["train_size"], t["test_size"]) == (LIMIT, LIMIT)
    assert (t["epochs"], t["n_shards"], t["depth"], t["dim"]) == (2, 1, 1, 32)
    assert t["compile_s"] == 0.0  # no capture on the CPU
    assert all(isinstance(t[k], float) for k in ("data_s", "run_s")) and t["run_s"] > 0
    assert all(0.0 <= t[k] <= 1.0 for k in ("epoch1_test_accuracy", "final_test_accuracy"))


def test_dry_run_demotes_fused_to_the_per_batch_loop(idx_root):
    timings = {}
    _, state, out = _fit(idx_root, "--epochs", "1", "--fused", "--dry-run", timings=timings)
    assert state.step == 1 and "host_syncs" not in timings and "Test set:" in out


# -- utils/flops.py --------------------------------------------------------------

@pytest.mark.parametrize("cfg", [{}, {"depth": 1, "dim": 32}, {"depth": 6, "dim": 128,
                                                               "heads": 8, "mlp_dim": 256}],
                         ids=["default", "small", "wide"])
def test_flops_are_jax_counts(cfg):
    assert flops.forward_flops_per_sample() == jax_flops.forward_flops_per_sample()
    assert flops.train_step_flops_per_sample() == jax_flops.train_step_flops_per_sample()
    assert flops.run_flops(60000, 10000, 14) == jax_flops.run_flops(60000, 10000, 14)
    port, ref = ViTConfig(**cfg), jvit.ViTConfig(**cfg)
    assert flops.vit_forward_flops_per_sample(port) == jax_flops.vit_forward_flops_per_sample(ref)
    assert flops.vit_train_step_flops_per_sample(port) == \
        jax_flops.vit_train_step_flops_per_sample(ref)
    assert flops.vit_run_flops(port, 60000, 10000, 3) == jax_flops.vit_run_flops(ref, 60000,
                                                                                 10000, 3)


def test_gpu_peak_flops():
    assert flops.gpu_peak_flops("NVIDIA H100 80GB HBM3") == 67e12
    assert flops.gpu_peak_flops("NVIDIA H100 80GB HBM3", "bfloat16") == 989e12
    assert flops.gpu_peak_flops("NVIDIA H100 PCIe") is None  # other peaks, not listed
    assert flops.gpu_peak_flops("Some Card") is None
    assert flops.gpu_peak_flops("NVIDIA H100 80GB HBM3", "float16") is None


# -- tools/vit_bench.py -----------------------------------------------------------

STDOUT = ("Train Epoch: 1 [0/200 (0%)]\tLoss: 2.3\n\n"
          "Test set: Average loss: 1.0, Accuracy: 150/200 (75%)\n\n"
          "Test set: Average loss: 0.5, Accuracy: 180/200 (90%)\n\n"
          "Total cost time:12.5 ms\n")
TIMINGS = {"dataset": "synthetic", "compile_s": 0.05, "data_s": 0.2, "run_s": 10.0,
           "train_size": 60000, "test_size": 10000, "epochs": 2, "n_shards": 1, "depth": 2,
           "dim": 64, "epoch1_test_accuracy": 0.75, "final_test_accuracy": 0.9}


def _bench(monkeypatch, capsys, argv, returncode=0, timings=TIMINGS,
           cards=(1, "NVIDIA H100 80GB HBM3")):
    calls, seen = [], {}

    def run_cli(cmd, timeout):
        calls.append(cmd)
        if "--timings-json" in cmd:
            seen["path"] = cmd[cmd.index("--timings-json") + 1]
            with open(seen["path"], "w") as f:
                json.dump(timings, f)
        return subprocess.CompletedProcess(cmd, returncode, STDOUT, "boom")

    def probe_cards():
        if isinstance(cards, Exception):
            raise cards
        return cards

    monkeypatch.setattr(vit_bench, "run_cli", run_cli)
    monkeypatch.setattr(vit_bench, "probe_cards", probe_cards)
    rc = vit_bench.main(argv)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    if "path" in seen:
        assert not os.path.exists(seen["path"])  # removed on every exit path
    return rc, json.loads(lines[0]), calls


def test_vit_bench_fused_row_and_mfu(monkeypatch, capsys):
    rc, row, calls = _bench(monkeypatch, capsys, ["--mode", "fused", "--epochs", "2"])
    assert rc == 0 and calls[0][1:3] == ["-m", "pytorch_mnist_ddp_tpu_torch.vit_mnist"]
    assert "--fused" in calls[0] and "--no-cuda" not in calls[0]
    want = jax_flops.vit_run_flops(jvit.ViTConfig(), 60000, 10000, 2)
    assert row["model_tflops"] == round(want / 1e12, 3)
    assert row["peak_f32_tflops_per_chip"] == 67.0 and "peak_bf16_tflops_per_chip" not in row
    assert row["mfu"] == round(want / 10.0 / 67e12, 5) and 0 < row["mfu"] < 1
    assert (row["value"], row["run_s"], row["compile_s"], row["data_s"]) == (12.5, 10.0, 0.05, 0.2)
    assert row["images_per_sec_per_chip_run"] == round(60000 * 2 / 10.0, 1)
    assert (row["epoch1_test_accuracy"], row["final_test_accuracy"]) == (75.0, 90.0)
    assert (row["dataset"], row["n_chips"], row["device"]) == ("synthetic", 1,
                                                                "NVIDIA H100 80GB HBM3")
    assert row["metric"] == "vit_mnist_fused_wall_clock" and row["cache"] == "warm"


def test_vit_bench_zero_mode_and_unknown_card(monkeypatch, capsys):
    rc, row, calls = _bench(monkeypatch, capsys, ["--mode", "zero", "--epochs", "2"],
                            cards=(2, "Some Card"))
    assert rc == 0 and calls[0][-4:-2] == ["--zero", "--fused"]
    assert "mfu" not in row and row["cards_visible"] == 2 and row["run_s"] == 10.0


def test_vit_bench_per_batch_mode_and_failures(monkeypatch, capsys):
    rc, row, calls = _bench(monkeypatch, capsys, ["--mode", "sp", "--device", "cpu"])
    assert rc == 0 and row["mode_degree"] == 1 and "run_s" not in row
    assert "--timings-json" not in calls[0] and "--no-cuda" in calls[0]
    rc, row, _ = _bench(monkeypatch, capsys, ["--mode", "fused"], returncode=3)
    assert rc == 1 and row["value"] is None and row["error"].startswith("exit 3: boom")
    rc, row, calls = _bench(monkeypatch, capsys, ["--mode", "fused"],
                            cards=RuntimeError("no CUDA device"))
    assert rc == 1 and row["error"] == "device probe failed: no CUDA device"


def test_vit_bench_runs_the_cli_on_the_cpu(monkeypatch, capsys, idx_root):
    monkeypatch.setenv("MNIST_DATA_DIR", str(idx_root))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert vit_bench.main(["--mode", "sp", "--device", "cpu", "--epochs", "1",
                           "--batch-size", "64", "--test-batch-size", "100"]) == 0
    row = json.loads(capsys.readouterr().out)
    assert row["dataset"] == "idx" and row["value"] > 0 and row["n_chips"] == 1
    assert 0 <= row["final_test_accuracy"] <= 100 and "mfu" not in row
