"""Package boundary of the PyTorch/CUDA port.

The port imports torch, numpy and the standard library only: never jax,
flax or the JAX package.  Its entry points default to the card and raise
without one, and its kernel wrappers take the plain path only for CPU
tensors.
"""

from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from pytorch_mnist_ddp_tpu_torch.device import resolve_device
from pytorch_mnist_ddp_tpu_torch.models.net import Net
from pytorch_mnist_ddp_tpu_torch.models.quant import quantize_params
from pytorch_mnist_ddp_tpu_torch.ops import _build
from pytorch_mnist_ddp_tpu_torch.ops import int8_head
from pytorch_mnist_ddp_tpu_torch.mnist import build_parser as train_parser
from pytorch_mnist_ddp_tpu_torch.mnist import main as train_cli_main
from pytorch_mnist_ddp_tpu_torch.mnist_ddp import build_parser as ddp_parser
from pytorch_mnist_ddp_tpu_torch.mnist_ddp import main as ddp_cli_main
from pytorch_mnist_ddp_tpu_torch.serving.__main__ import main as cli_main
from pytorch_mnist_ddp_tpu_torch.serving.engine import InferenceEngine
from pytorch_mnist_ddp_tpu_torch.trainer import fit
from pytorch_mnist_ddp_tpu_torch.vit_mnist import build_parser as vit_parser
from pytorch_mnist_ddp_tpu_torch.vit_mnist import fit as vit_fit
from pytorch_mnist_ddp_tpu_torch.vit_mnist import resolve_mode_flags as resolve_vit_modes
from pytorch_mnist_ddp_tpu_torch.vit_mnist import main as vit_cli_main

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "pytorch_mnist_ddp_tpu_torch"
FORBIDDEN_ROOTS = ("jax", "flax", "pytorch_mnist_ddp_tpu")
PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _absolute_imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(ROOT)) for p in PORT_FILES]
)
def test_port_file_imports_no_jax_or_reference(path):
    bad = sorted(
        name for name in _absolute_imports(path)
        if name.split(".")[0] in FORBIDDEN_ROOTS
    )
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_every_port_module_imports_with_jax_poisoned():
    code = (
        "import importlib, pkgutil, sys\n"
        f"for name in {FORBIDDEN_ROOTS!r}:\n"
        "    sys.modules[name] = None  # any import of it raises\n"
        "import pytorch_mnist_ddp_tpu_torch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "print(len(mods))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15  # every module of the port


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the no-card contract is moot")


def test_resolve_device_defaults_to_cuda_and_raises_without_it():
    _no_card()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


@pytest.mark.parametrize(
    "entry",
    ["engine", "from_seed", "cli", "trainer", "train_cli", "vit_fit", "vit_cli",
     "vit_sp_cli", "vit_tp_cli", "ddp_cli", "ddp_tp_cli", "vit_state_cli"],
)
def test_entry_points_default_to_cuda(entry, monkeypatch):
    _no_card()
    for name in ("RANK", "WORLD_SIZE", "SLURM_PROCID"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "engine":
            InferenceEngine(Net().state_dict())
        elif entry == "from_seed":
            InferenceEngine.from_seed(1)
        elif entry == "cli":
            cli_main(["--warmup-only", "--buckets", "1"])
        elif entry == "trainer":
            fit(train_parser().parse_args(["--dry-run"]))
        elif entry == "train_cli":
            train_cli_main(["--dry-run", "--epochs", "1"])
        elif entry == "vit_fit":
            args = vit_parser().parse_args(["--dry-run", "--flash"])
            vit_fit(args, resolve_vit_modes(args))
        elif entry == "vit_cli":
            vit_cli_main(["--dry-run", "--epochs", "1", "--flash"])
        elif entry == "ddp_cli":
            ddp_cli_main(["--dry-run", "--epochs", "1", "--syncbn"])
        elif entry == "ddp_tp_cli":
            ddp_cli_main(["--dry-run", "--epochs", "1", "--tp", "2", "--step-stats"])
        elif entry == "vit_state_cli":
            vit_cli_main(["--epochs", "1", "--save-state", "s.npz", "--profile", "p"])
        elif entry == "vit_tp_cli":
            vit_cli_main(["--dry-run", "--epochs", "1", "--sp", "2", "--tp", "2", "--flash"])
        else:
            vit_cli_main(["--dry-run", "--epochs", "1", "--sp", "1", "--allow-degree-1"])


@pytest.mark.parametrize(
    "flag",
    ["--telemetry-dir=x", "--aot-cache=x", "--serve-prewarm",
     "--compile-cache-dir=x", "--loss-guard",
     "--checkpoint-every-steps=1", "--chaos=x", "--preempt-grace-s=1",
     "--spike-factor=2", "--anomaly-budget=1", "--step-timeout-s=1"],
)
def test_train_cli_refuses_flags_not_ported_yet(flag):
    with pytest.raises(SystemExit):
        train_parser().parse_args([flag])


@pytest.mark.parametrize(
    "flags,dest,value",
    [(["--resume=m.pt"], "resume", "m.pt"), (["--save-state=s.npz"], "save_state", "s.npz"),
     (["--resume-state=s.npz"], "resume_state", "s.npz"),
     (["--conv-impl=im2col_c1"], "conv_impl", "im2col_c1"),
     (["--conv-impl=im2col"], "conv_impl", "im2col"), (["--bf16"], "bf16", True),
     (["--profile=x"], "profile", "x"), (["--step-stats"], "step_stats", True),
     (["--elastic"], "elastic", True), (["--resume-reshard"], "resume_reshard", True),
     (["--fused"], "fused", True), (["--fused", "--pregather"], "pregather", True),
     (["--prefetch-depth=0"], "prefetch_depth", 0)],
    ids=["resume", "save_state", "resume_state", "conv_impl_im2col_c1", "conv_impl_im2col",
         "bf16", "profile", "step_stats", "elastic", "resume_reshard", "fused", "pregather",
         "prefetch_depth"],
)
def test_train_cli_accepts_ported_flags(flags, dest, value):
    """mnist.py's --resume, --save-state, --resume-state, --conv-impl,
    --bf16, --profile, --step-stats, --elastic, --resume-reshard,
    --fused, --pregather and --prefetch-depth are ported, with the JAX
    CLI's defaults."""
    assert getattr(train_parser().parse_args(flags), dest) == value
    defaults = train_parser().parse_args([])
    assert (defaults.resume, defaults.save_state, defaults.resume_state,
            defaults.conv_impl, defaults.bf16) == (None, None, None, "conv", False)
    assert (defaults.profile, defaults.step_stats, defaults.elastic,
            defaults.resume_reshard) == (None, False, False, False)
    assert (defaults.fused, defaults.pregather, defaults.prefetch_depth) == (False, False, 2)


@pytest.mark.parametrize(
    "flag",
    ["--telemetry-dir=x", "--checkpoint-every-steps=1", "--chaos=x"],
)
def test_ddp_cli_refuses_flags_not_ported_yet(flag):
    with pytest.raises(SystemExit):
        ddp_parser().parse_args([flag])


@pytest.mark.parametrize(
    "flags,dest,value",
    [(["--tp=2"], "tp", 2), (["--pp"], "pp", True),
     (["--pp", "--pp-microbatches=4"], "pp_microbatches", 4), (["--elastic"], "elastic", True),
     (["--resume-reshard"], "resume_reshard", True), (["--profile=x"], "profile", "x"),
     (["--step-stats"], "step_stats", True), (["--fused"], "fused", True)],
    ids=["tp", "pp", "pp_microbatches", "elastic", "resume_reshard", "profile", "step_stats",
         "fused"],
)
def test_ddp_cli_accepts_model_axis_and_run_flags(flags, dest, value):
    """mnist_ddp.py's --tp, --pp, --pp-microbatches, --elastic,
    --resume-reshard, --profile, --step-stats and --fused are ported, with
    the JAX CLI's defaults (--tp 1, --pp-microbatches 2, --fused off,
    --prefetch-depth 2)."""
    assert getattr(ddp_parser().parse_args(flags), dest) == value
    defaults = ddp_parser().parse_args([])
    assert (defaults.tp, defaults.pp, defaults.pp_microbatches, defaults.elastic,
            defaults.resume_reshard, defaults.profile, defaults.step_stats) == (
        1, False, 2, False, False, None, False)
    assert (defaults.fused, defaults.pregather, defaults.prefetch_depth) == (False, False, 2)


@pytest.mark.parametrize("flags", [["--zero"], ["--zero", "--syncbn"], ["--zero", "--bf16"]],
                         ids=["zero", "zero_syncbn", "zero_bf16"])
def test_ddp_cli_accepts_zero(flags):
    """--zero is ported (parallel/zero.py) and composes with --syncbn and
    --bf16; off by default, as in the JAX CLI."""
    args = ddp_parser().parse_args(flags)
    assert args.zero and args.syncbn == ("--syncbn" in flags) and args.bf16 == ("--bf16" in flags)
    assert ddp_parser().parse_args([]).zero is False


def test_ddp_cli_takes_mnist_flags_and_the_ddp_ones():
    """mnist_ddp.py's flags with the JAX CLI's defaults, on top of every
    flag of the port's mnist.py."""
    args = ddp_parser().parse_args([])
    assert (args.local_rank, args.world_size, args.dist_url, args.rdzv_timeout_s,
            args.rdzv_attempts, args.syncbn) == (0, 1, "env://", None, None, False)
    mnist_dests = {a.dest for a in train_parser()._actions}
    assert mnist_dests <= {a.dest for a in ddp_parser()._actions}
    args = ddp_parser().parse_args(["--syncbn", "--local_rank=3", "--world-size=4",
                                    "--dist-url=tcp://h:1", "--rdzv-timeout-s=9",
                                    "--rdzv-attempts=3", "--pallas-opt", "--batch-size=200"])
    assert (args.syncbn, args.local_rank, args.world_size, args.dist_url,
            args.rdzv_timeout_s, args.rdzv_attempts, args.pallas_opt, args.batch_size) == (
        True, 3, 4, "tcp://h:1", 9.0, 3, True, 200)


@pytest.mark.parametrize(
    "flag",
    ["--fused", "--pregather", "--timings-json=x"],
)
def test_vit_cli_refuses_flags_not_ported_yet(flag):
    with pytest.raises(SystemExit):
        vit_parser().parse_args([flag])


@pytest.mark.parametrize(
    "flags, dest, value",
    [(["--bf16"], "bf16", True), (["--bf16", "--flash"], "bf16", True),
     (["--bf16", "--sp", "1", "--allow-degree-1", "--flash"], "bf16", True),
     (["--bf16", "--flash", "--remat"], "bf16", True),
     (["--sp-impl=ulysses"], "sp_impl", "ulysses"), (["--tp=2"], "tp", 2),
     (["--sp=2"], "sp", 2), (["--pp"], "pp", True), (["--pp-microbatches=4"], "pp_microbatches", 4),
     (["--pp-stages=3"], "pp_stages", 3), (["--experts=8", "--flash"], "experts", 8),
     (["--zero", "--flash"], "zero", True), (["--save-state=x"], "save_state", "x"),
     (["--resume-state=x", "--zero"], "resume_state", "x"), (["--profile=x"], "profile", "x"),
     (["--step-stats", "--flash"], "step_stats", True)],
    ids=["bf16", "bf16_flash", "bf16_sp1_flash", "bf16_flash_remat", "sp_impl_ulysses", "tp",
         "sp2", "pp", "pp_microbatches", "pp_stages", "experts", "zero", "save_state",
         "resume_state", "profile", "step_stats"],
)
def test_vit_cli_accepts_ported_flags(flags, dest, value):
    """--bf16 is ported (the flash kernel's bf16 mode) and composes with
    --flash, --remat and the degree-1 ring; --sp N, --sp-impl, --tp,
    --pp, --pp-microbatches, --pp-stages, --experts, --zero,
    --save-state, --resume-state, --profile and --step-stats are taken
    with the JAX CLI's defaults."""
    assert getattr(vit_parser().parse_args(flags), dest) == value
    defaults = vit_parser().parse_args([])
    assert (defaults.sp, defaults.sp_impl, defaults.tp) == (None, "ring", None)
    assert (defaults.pp, defaults.pp_microbatches, defaults.pp_stages, defaults.experts,
            defaults.zero) == (False, 2, 2, 0, False)
    assert (defaults.save_state, defaults.resume_state, defaults.profile,
            defaults.step_stats) == (None, None, None, False)


@pytest.fixture
def head_args():
    q = quantize_params(Net(torch.Generator().manual_seed(3)).state_dict())
    x = torch.rand(3, 9216, generator=torch.Generator().manual_seed(4))
    return q["fc1"], q["fc2"], x


def test_cpu_head_never_touches_the_build(monkeypatch, head_args):
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path must not build or load a kernel")

    for name in ("library", "nvcc_path"):
        monkeypatch.setattr(_build, name, refuse)
    before = int8_head.LAUNCHES
    fc1, fc2, x = head_args
    out = int8_head.fused_int8_head(fc1, fc2, x)
    assert out.shape == (3, 10)
    assert torch.equal(out, int8_head.int8_head_reference(fc1, fc2, x))
    assert int8_head.LAUNCHES == before  # the plain path is not a launch


def test_head_refuses_other_devices(head_args):
    fc1, fc2, x = head_args
    with pytest.raises(ValueError, match="cuda or cpu"):
        int8_head.fused_int8_head(fc1, fc2, x.to("meta"))


def test_build_lists_sources_and_names_missing_nvcc(monkeypatch, tmp_path):
    assert {"adadelta", "flash_attention", "int8_head"} <= set(_build.sources())
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_build_target_tracks_the_source():
    target = _build._target("int8_head")
    assert target.parent == _build.BUILD_DIR
    assert target == _build._target("int8_head")  # stable for one source
    assert target.name.startswith("int8_head-") and target.suffix == ".so"
    other = _build._target("adadelta")
    assert other.name.startswith("adadelta-") and other != target


def test_builds_of_different_sources_run_concurrently(monkeypatch, tmp_path):
    """One lock per source: two sources build at once, and many threads
    asking for one source build it once."""
    import threading
    import time

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_locks", {})
    compiled, running, peak = [], [0], [0]
    guard = threading.Lock()

    def fake_compile(name, target):
        with guard:
            running[0] += 1
            peak[0] = max(peak[0], running[0])
        time.sleep(0.2)
        target.write_bytes(b"")
        with guard:
            running[0] -= 1
            compiled.append(name)

    monkeypatch.setattr(_build, "_compile", fake_compile)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    results = []
    threads = [threading.Thread(target=lambda n=n: results.append(_build.library(n)))
               for n in ["adadelta", "int8_head"] * 4]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert sorted(compiled) == ["adadelta", "int8_head"]  # each once
    assert peak[0] == 2  # the two builds overlapped
    assert len(results) == 8 and len(set(results)) == 2
