"""Package boundary of the PyTorch/CUDA port.

The port imports torch, numpy and the standard library only: never jax,
flax or the JAX package.  Its entry points default to the card and raise
without one, and its kernel wrappers take the plain path only for CPU
tensors.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import pathlib
import subprocess
import sys
import threading

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
from pytorch_mnist_ddp_tpu_torch.serving.metrics import ServingMetrics
from pytorch_mnist_ddp_tpu_torch.serving.server import make_server
from pytorch_mnist_ddp_tpu_torch.tools import serve_loadgen, slo_gate
from pytorch_mnist_ddp_tpu_torch.tools.serve_loadgen import main as loadgen_main
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
        "print(' '.join(mods))\n"
        "print(len(mods))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 15  # every module of the port
    imported = set(proc.stdout.split()[:-1])
    files = {".".join(p.relative_to(ROOT).with_suffix("").parts) for p in PKG.rglob("*.py")}
    files = {f.removesuffix(".__init__") for f in files} - {PKG.name}
    assert files <= imported, sorted(files - imported)


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
     "vit_sp_cli", "vit_tp_cli", "ddp_cli", "ddp_tp_cli", "vit_state_cli", "loadgen"],
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
        elif entry == "loadgen":
            loadgen_main(["--requests", "1"])
        elif entry == "vit_tp_cli":
            vit_cli_main(["--dry-run", "--epochs", "1", "--sp", "2", "--tp", "2", "--flash"])
        else:
            vit_cli_main(["--dry-run", "--epochs", "1", "--sp", "1", "--allow-degree-1"])


STARTUP_FLAGS = [(["--aot-cache=x"], "aot_cache", "x"), (["--serve-prewarm"], "serve_prewarm", True),
                 (["--compile-cache-dir=x"], "compile_cache_dir", "x")]


@pytest.mark.parametrize("flags,dest,value", STARTUP_FLAGS, ids=[d for _, d, _ in STARTUP_FLAGS])
def test_train_cli_accepts_the_startup_flags(flags, dest, value):
    """mnist.py's --aot-cache, --serve-prewarm and --compile-cache-dir
    (compile/) are ported, with the JAX CLI's defaults."""
    assert getattr(train_parser().parse_args(flags), dest) == value
    defaults = train_parser().parse_args([])
    assert (defaults.aot_cache, defaults.serve_prewarm, defaults.compile_cache_dir) == (
        None, False, None)


@pytest.mark.parametrize(
    "flags,dest,value",
    [(["--resume=m.pt"], "resume", "m.pt"), (["--save-state=s.npz"], "save_state", "s.npz"),
     (["--resume-state=s.npz"], "resume_state", "s.npz"),
     (["--conv-impl=im2col_c1"], "conv_impl", "im2col_c1"),
     (["--conv-impl=im2col"], "conv_impl", "im2col"), (["--bf16"], "bf16", True),
     (["--profile=x"], "profile", "x"), (["--step-stats"], "step_stats", True),
     (["--elastic"], "elastic", True), (["--resume-reshard"], "resume_reshard", True),
     (["--fused"], "fused", True), (["--fused", "--pregather"], "pregather", True),
     (["--prefetch-depth=0"], "prefetch_depth", 0),
     (["--telemetry-dir=x"], "telemetry_dir", "x"), (["--loss-guard"], "loss_guard", True),
     (["--checkpoint-every-steps=1"], "checkpoint_every_steps", 1),
     (["--chaos=x"], "chaos", "x"), (["--preempt-grace-s=1"], "preempt_grace_s", 1.0),
     (["--spike-factor=2"], "spike_factor", 2.0), (["--anomaly-budget=1"], "anomaly_budget", 1),
     (["--step-timeout-s=1"], "step_timeout_s", 1.0),
     (["--anomaly-lr-backoff=0.25"], "anomaly_lr_backoff", 0.25),
     (["--stall-abort"], "stall_abort", True), (["--chaos-seed=3"], "chaos_seed", 3)],
    ids=["resume", "save_state", "resume_state", "conv_impl_im2col_c1", "conv_impl_im2col",
         "bf16", "profile", "step_stats", "elastic", "resume_reshard", "fused", "pregather",
         "prefetch_depth", "telemetry_dir", "loss_guard", "checkpoint_every_steps", "chaos",
         "preempt_grace_s", "spike_factor", "anomaly_budget", "step_timeout_s",
         "anomaly_lr_backoff", "stall_abort", "chaos_seed"],
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
    assert (defaults.telemetry_dir, defaults.checkpoint_every_steps, defaults.preempt_grace_s,
            defaults.loss_guard, defaults.spike_factor, defaults.anomaly_budget,
            defaults.anomaly_lr_backoff, defaults.step_timeout_s, defaults.stall_abort,
            defaults.chaos, defaults.chaos_seed) == (
        None, 0, 30.0, False, 10.0, 3, 0.5, 0.0, False, None, 0)


@pytest.mark.parametrize("flags,dest,value", STARTUP_FLAGS, ids=[d for _, d, _ in STARTUP_FLAGS])
def test_ddp_cli_accepts_the_startup_flags(flags, dest, value):
    """mnist_ddp.py takes the same three startup flags, with the JAX CLI's
    defaults (every rank of a launch shares the one --aot-cache)."""
    assert getattr(ddp_parser().parse_args(flags), dest) == value
    defaults = ddp_parser().parse_args([])
    assert (defaults.aot_cache, defaults.serve_prewarm, defaults.compile_cache_dir) == (
        None, False, None)


@pytest.mark.parametrize(
    "flags,dest,value",
    [(["--tp=2"], "tp", 2), (["--pp"], "pp", True),
     (["--pp", "--pp-microbatches=4"], "pp_microbatches", 4), (["--elastic"], "elastic", True),
     (["--resume-reshard"], "resume_reshard", True), (["--profile=x"], "profile", "x"),
     (["--step-stats"], "step_stats", True), (["--fused"], "fused", True),
     (["--telemetry-dir=x"], "telemetry_dir", "x"),
     (["--checkpoint-every-steps=1"], "checkpoint_every_steps", 1),
     (["--chaos=x"], "chaos", "x"), (["--loss-guard"], "loss_guard", True)],
    ids=["tp", "pp", "pp_microbatches", "elastic", "resume_reshard", "profile", "step_stats",
         "fused", "telemetry_dir", "checkpoint_every_steps", "chaos", "loss_guard"],
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
    # every flag of the JAX CLI
    import mnist as jax_cli  # noqa: PLC0415 -- the root JAX CLI, imported here only

    jax_flags = {o for a in jax_cli.build_parser()._actions for o in a.option_strings}
    port_flags = {o for a in train_parser()._actions for o in a.option_strings}
    assert jax_flags - port_flags == set()
    jax_defaults = vars(jax_cli.build_parser().parse_args([]))
    port_defaults = vars(train_parser().parse_args([]))
    assert {k: v for k, v in jax_defaults.items() if k in port_defaults} == {
        k: v for k, v in port_defaults.items() if k in jax_defaults}
    args = ddp_parser().parse_args(["--syncbn", "--local_rank=3", "--world-size=4",
                                    "--dist-url=tcp://h:1", "--rdzv-timeout-s=9",
                                    "--rdzv-attempts=3", "--pallas-opt", "--batch-size=200"])
    assert (args.syncbn, args.local_rank, args.world_size, args.dist_url,
            args.rdzv_timeout_s, args.rdzv_attempts, args.pallas_opt, args.batch_size) == (
        True, 3, 4, "tcp://h:1", 9.0, 3, True, 200)


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
     (["--step-stats", "--flash"], "step_stats", True), (["--fused"], "fused", True),
     (["--fused", "--pregather"], "pregather", True),
     (["--fused", "--timings-json=x"], "timings_json", "x")],
    ids=["bf16", "bf16_flash", "bf16_sp1_flash", "bf16_flash_remat", "sp_impl_ulysses", "tp",
         "sp2", "pp", "pp_microbatches", "pp_stages", "experts", "zero", "save_state",
         "resume_state", "profile", "step_stats", "fused", "fused_pregather",
         "fused_timings_json"],
)
def test_vit_cli_accepts_ported_flags(flags, dest, value):
    """--bf16 is ported (the flash kernel's bf16 mode) and composes with
    --flash, --remat and the degree-1 ring; --sp N, --sp-impl, --tp,
    --pp, --pp-microbatches, --pp-stages, --experts, --zero,
    --save-state, --resume-state, --profile, --step-stats, --fused,
    --pregather and --timings-json are taken with the JAX CLI's
    defaults."""
    assert getattr(vit_parser().parse_args(flags), dest) == value
    defaults = vit_parser().parse_args([])
    assert (defaults.sp, defaults.sp_impl, defaults.tp) == (None, "ring", None)
    assert (defaults.pp, defaults.pp_microbatches, defaults.pp_stages, defaults.experts,
            defaults.zero) == (False, 2, 2, 0, False)
    assert (defaults.save_state, defaults.resume_state, defaults.profile,
            defaults.step_stats) == (None, None, None, False)
    assert (defaults.fused, defaults.pregather, defaults.timings_json) == (False, False, None)


def test_vit_cli_takes_every_flag_of_the_jax_cli():
    """The root vit_mnist.py's flags minus the port's: none left, and the
    shared flags' defaults are JAX's."""
    import vit_mnist as jax_cli  # noqa: PLC0415 -- the root JAX CLI, imported here only

    jax_flags = {o for a in jax_cli.build_parser()._actions for o in a.option_strings}
    port_flags = {o for a in vit_parser()._actions for o in a.option_strings}
    assert jax_flags - port_flags == set()
    assert vars(jax_cli.build_parser().parse_args([])) == vars(vit_parser().parse_args([]))


@pytest.mark.parametrize(
    "flags, accepted",
    [(["--pregather"], False), (["--timings-json=x"], False),
     (["--fused", "--dry-run", "--timings-json=x"], False), (["--fused", "--sp", "2"], False),
     (["--fused", "--tp", "2"], False), (["--fused", "--pp"], False),
     (["--fused", "--experts", "8"], False), (["--fused", "--flash"], False),
     (["--fused", "--zero", "--remat"], True), (["--fused", "--dry-run", "--pregather"], True),
     (["--fused", "--bf16", "--timings-json=x"], True)],
    ids=["pregather_alone", "timings_alone", "timings_dry_run", "sp", "tp", "pp", "experts",
         "flash", "zero_remat", "dry_run_pregather", "bf16_timings"],
)
def test_vit_fused_truth_table_is_jax(flags, accepted):
    """Each refusal of a fused combination exits with the JAX CLI's text,
    and each combination JAX takes the port takes, with the same modes."""
    import vit_mnist as jax_cli  # noqa: PLC0415 -- the root JAX CLI, imported here only

    def resolve(cli, parser):
        try:
            return cli(parser.parse_args(flags))
        except SystemExit as e:
            return str(e)

    got = resolve(resolve_vit_modes, vit_parser())
    assert got == resolve(jax_cli.resolve_mode_flags, jax_cli.build_parser())
    assert isinstance(got, tuple) == accepted


SERVING_FLEET_FLAGS = [
    (["--fleet", "2"], "fleet", None, 2),
    (["--fleet-base-port", "9000"], "fleet_base_port", None, 9000),
    (["--fleet-restart-budget", "1"], "fleet_restart_budget", 3, 1),
    (["--fleet-heartbeat-timeout-s", "2.5"], "fleet_heartbeat_timeout_s", 10.0, 2.5),
    (["--fleet-ready-timeout-s", "60"], "fleet_ready_timeout_s", 300.0, 60.0),
    (["--autoscale"], "autoscale", False, True),
    (["--scale-high", "12"], "scale_high", 8.0, 12.0),
    (["--scale-low", "0.5"], "scale_low", 1.0, 0.5),
    (["--scale-min", "2"], "scale_min", 1, 2),
    (["--scale-max", "6"], "scale_max", 4, 6),
    (["--scale-window-s", "0.5"], "scale_window_s", 2.0, 0.5),
    (["--scale-cooldown-s", "3"], "scale_cooldown_s", 10.0, 3.0),
]


@pytest.mark.parametrize("argv,dest,default,value", SERVING_FLEET_FLAGS,
                         ids=[a[0][0] for a in SERVING_FLEET_FLAGS])
def test_serving_accepts_the_fleet_flags(argv, dest, default, value):
    """Each fleet flag parses to the JAX CLI's default and, given, to its
    value, the type the JAX CLI gives it."""
    from pytorch_mnist_ddp_tpu.serving.__main__ import build_parser as jax_serving_parser
    from pytorch_mnist_ddp_tpu_torch.serving.__main__ import build_parser as serving_parser

    port, jax = serving_parser(), jax_serving_parser()
    assert getattr(port.parse_args([]), dest) == getattr(jax.parse_args([]), dest) == default
    got = getattr(port.parse_args(argv), dest)
    assert got == getattr(jax.parse_args(argv), dest) == value
    assert type(got) is type(value)


SERVING_FLEET_PREFLIGHT = [
    (["--fleet", "0"], "error: --fleet must be >= 1, got 0"),
    (["--fleet", "2", "--autoscale", "--scale-low", "8"],
     "error: --scale-low 8 must be < --scale-high 8 (the hysteresis band)"),
    (["--fleet", "5", "--autoscale"],
     "error: need 1 <= --scale-min (1) <= --fleet (5) <= --scale-max (4)"),
    (["--fleet", "2", "--warmup-only"],
     "error: --warmup-only is a backend concern; run it without --fleet"),
]


@pytest.mark.parametrize("argv,line", SERVING_FLEET_PREFLIGHT,
                         ids=["fleet_0", "scale_low", "scale_bounds", "warmup_only"])
def test_serving_fleet_preflight_refusals(argv, line, capsys):
    """The JAX CLI's four pre-flight refusals of --fleet: exit 2 with its
    message, before any backend is spawned."""
    assert cli_main(argv) == 2
    assert capsys.readouterr().out.splitlines() == [line]


def test_serving_cli_takes_every_flag_of_the_jax_cli():
    """JAX's serving flags minus the port's is the empty set, and each
    flag both take has the same default but --int8-impl (the port's
    default is its kernel)."""
    from pytorch_mnist_ddp_tpu.serving.__main__ import build_parser as jax_serving_parser
    from pytorch_mnist_ddp_tpu_torch.serving.__main__ import build_parser as serving_parser

    options = lambda p: {o for a in p._actions for o in a.option_strings}  # noqa: E731
    assert options(jax_serving_parser()) - options(serving_parser()) == set()
    jax_defaults = vars(jax_serving_parser().parse_args([]))
    port_defaults = vars(serving_parser().parse_args([]))
    assert {k: v for k, v in jax_defaults.items() if port_defaults[k] != v} == {
        "int8_impl": "dot"}


SERVING_STARTUP_FLAGS = [
    (["--aot-cache", "{d}/aot"], "aot_cache", "{d}/aot"),
    (["--cache-dir", "{d}/kernels"], "cache_dir", "{d}/kernels"),
    (["--serial-warmup"], "serial_warmup", True),
    (["--no-device-stage"], "no_device_stage", True),
]


@pytest.mark.parametrize("flags,dest,value", SERVING_STARTUP_FLAGS,
                         ids=[f[0][0] for f in SERVING_STARTUP_FLAGS])
@pytest.mark.parametrize("replicas", [[], ["--replicas", "2"]], ids=["engine", "pool"])
def test_serving_accepts_the_startup_flags(flags, dest, value, replicas, tmp_path, capsys,
                                           monkeypatch):
    """Each compile/ flag parses to its value (off by default), and one
    engine and a pool of two warm and pass their gates with it on the
    CPU, printing the JAX CLI's warmup lines in the port's terms."""
    from pytorch_mnist_ddp_tpu_torch.serving.__main__ import build_parser as serving_parser

    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)  # --cache-dir moves it
    flags = [f.format(d=tmp_path) for f in flags]
    value = value.format(d=tmp_path) if isinstance(value, str) else value
    assert getattr(serving_parser().parse_args(flags), dest) == value
    assert getattr(serving_parser().parse_args([]), dest) in (None, False)
    argv = ["--device", "cpu", "--warmup-only", "--buckets", "1,2", "--dtypes", "f32,int8",
            *replicas, *flags]
    assert cli_main(argv) == 0
    out = capsys.readouterr().out.splitlines()
    assert "parity gate [int8]: PASS" in "\n".join(out)
    rungs = 2 * 2 * (2 if replicas else 1)
    verified = [ln for ln in out if ln.startswith("warmup verified: ")]
    assert verified and verified[0].startswith(
        f"warmup verified: {rungs} rungs (2 buckets x 2 dtypes"
        + (" x 2 replicas)" if replicas else ")") + ", 0 kernel libraries ready, 0 nvcc builds")
    [warming] = [ln for ln in out if ln.startswith("warming buckets")]
    if not replicas:  # one engine warms its rungs in turn, flag or not
        assert "serially on cpu" in warming
    if dest == "aot_cache":
        assert warming.endswith(f"({'shared ' if replicas else ''}AOT cache {value})")
        assert os.listdir(value) == []  # the CPU loads no library
    if dest == "cache_dir":
        assert f"persistent compile cache: {value}" in out and os.path.isdir(value)


SERVING_POOL_FLAGS = [
    (["--replicas", "2"], "replicas", 2),
    (["--replica-shapes", "dp,dp"], "replica_shapes", "dp,dp"),
    (["--router-policy", "least-loaded"], "router_policy", "least-loaded"),
    (["--hedge"], "hedge", True),
    (["--hedge-delay-ms", "5"], "hedge_delay_ms", 5.0),
    (["--no-supervise"], "no_supervise", True),
    (["--stall-timeout-s", "2"], "stall_timeout_s", 2.0),
    (["--restart-budget", "1"], "restart_budget", 1),
]


@pytest.mark.parametrize("flags,dest,value", SERVING_POOL_FLAGS,
                         ids=[f[0][0] for f in SERVING_POOL_FLAGS])
def test_serving_accepts_the_pool_flags(flags, dest, value, capsys):
    """Each pool flag parses to its value, and a two-replica CPU pool with
    it warms and passes its gate."""
    from pytorch_mnist_ddp_tpu_torch.serving.__main__ import build_parser as serving_parser

    assert getattr(serving_parser().parse_args(flags), dest) == value
    argv = ["--device", "cpu", "--warmup-only", "--buckets", "1", "--dtypes", "f32,int8",
            "--int8-impl", "dot"] + (["--replicas", "2"] if dest != "replicas" else []) + flags
    assert cli_main(argv) == 0
    out = capsys.readouterr().out
    assert "x 2 replicas (devices ['cpu', 'cpu'])" in out
    assert "[r1] int8 bucket    1: ready" in out and "parity gate [int8]: PASS" in out


@pytest.mark.parametrize("shapes", ["tp2,dp", "vtp2,dp", "ep2,dp", "pp2,dp"])
def test_serving_refuses_sharded_replica_shapes(shapes, capsys):
    """A sharded --replica-shapes plan that needs more devices than are
    visible (three here; the CPU is one) exits 2 with the JAX planner's
    error before anything is built."""
    import jax
    from pytorch_mnist_ddp_tpu.parallel.mesh import parse_replica_shapes, plan_replica_meshes

    with pytest.raises(ValueError) as jax_err:
        plan_replica_meshes(parse_replica_shapes(shapes), jax.devices()[:1])
    assert cli_main(["--device", "cpu", "--replicas", "2", "--replica-shapes", shapes,
                     "--warmup-only"]) == 2
    out = capsys.readouterr().out
    assert out == f"error: --replica-shapes {shapes!r}: {jax_err.value}\n"
    assert "needs 3 devices but only 1 are visible" in out


def test_serving_pool_refusals_of_the_jax_cli(capsys):
    """The JAX CLI's pool refusals: a hedge needs two replicas, shapes need
    --replicas, a malformed shape is named."""
    for argv, expect in (
        (["--hedge"], "error: --hedge/--hedge-delay-ms need --replicas >= 2"),
        (["--replicas", "1", "--hedge-delay-ms", "3"], "error: --hedge/--hedge-delay-ms need"),
        (["--replica-shapes", "dp"], "error: --replica-shapes needs --replicas"),
        (["--replicas", "2", "--replica-shapes", "xp3"], "error: --replica-shapes 'xp3':"),
    ):
        assert cli_main(argv + ["--warmup-only"]) == 2
        assert capsys.readouterr().out.startswith(expect)


def test_serving_pool_without_a_card_raises():
    """--replicas 2 on the default device raises without a card instead of
    running the pool on the CPU."""
    _no_card()
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        cli_main(["--replicas", "2", "--warmup-only", "--buckets", "1"])


def test_serving_accepts_the_flags_of_this_slice(tmp_path, capsys):
    """The single-engine flags, warmed and gated on the CPU."""
    argv = ["--device", "cpu", "--warmup-only", "--buckets", "1,2", "--dtypes", "f32,bf16,int8",
            "--int8-impl", "dot", "--conv-impl", "im2col_c1", "--no-adaptive-linger",
            "--no-deadline-close", "--qos-weights", "interactive=3,batch=1",
            "--response-cache", "8", "--request-timeout-s", "5", "--telemetry-dir",
            str(tmp_path), "--packed", "--fill-wait-ms", "1"]
    assert cli_main(argv) == 0
    out = capsys.readouterr().out
    assert "parity gate [bf16]: PASS" in out and "parity gate [int8]: PASS" in out
    assert cli_main(["--device", "cpu", "--warmup-only", "--buckets", "1", "--bf16",
                     "--int8-impl", "pallas"]) == 0


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


def test_build_target_tracks_the_source(monkeypatch, tmp_path):
    """The build directory is a store: an entry's key is stable for one
    source and changes with it (the environment fixed: no card here)."""
    from pytorch_mnist_ddp_tpu_torch.compile import aot

    monkeypatch.setattr(aot, "_environment", lambda: {"device_kind": "fixed"})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    store = _build.build_store()
    target = store.header_path("int8_head")
    assert os.path.dirname(target) == str(tmp_path)
    assert target == store.header_path("int8_head")  # stable for one source
    assert os.path.basename(target).startswith("int8_head-") and target.endswith(".json")
    other = store.header_path("adadelta")
    assert os.path.basename(other).startswith("adadelta-") and other != target
    monkeypatch.setattr(aot, "source_digest", lambda: "an edited source")
    assert store.header_path("int8_head") != target


def test_builds_of_different_sources_run_concurrently(monkeypatch, tmp_path):
    """One lock per source: two sources build at once, and many threads
    asking for one source build it once."""
    import threading
    import time

    from pytorch_mnist_ddp_tpu_torch.compile import aot

    monkeypatch.setattr(aot, "_environment", lambda: {"device_kind": "fixed"})
    monkeypatch.setattr(aot, "_nvcc_version", lambda: "fixed")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_locks", {})
    monkeypatch.setattr(_build, "_origins", {})
    compiled, running, peak = [], [0], [0]
    guard = threading.Lock()

    def fake_build(name, out):
        with guard:
            running[0] += 1
            peak[0] = max(peak[0], running[0])
        time.sleep(0.2)
        pathlib.Path(out).write_bytes(name.encode())
        with guard:
            running[0] -= 1
            compiled.append(name)
        return ""

    monkeypatch.setattr(_build, "nvcc_build", fake_build)
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


def test_a_flagless_run_builds_no_runtime_and_no_sink_and_reads_no_more(monkeypatch,
                                                                         tmp_path):
    """Without --telemetry-dir, a resilience flag, an injector or the
    launcher's heartbeat file, fit() constructs no ResilientRuntime, no
    Telemetry and no event sink, and reads the device only where it did:
    the log lines' losses and two numbers an eval batch."""
    import struct

    from pytorch_mnist_ddp_tpu_torch import obs
    from pytorch_mnist_ddp_tpu_torch.data.mnist import _FILES, synthetic_mnist
    from pytorch_mnist_ddp_tpu_torch.resilience import runtime

    for split, n in (("train", 128), ("test", 128)):
        images, labels = synthetic_mnist(split, n)
        (tmp_path / _FILES[(split, "images")]).write_bytes(
            struct.pack(">iiii", 2051, n, 28, 28) + images.tobytes())
        (tmp_path / _FILES[(split, "labels")]).write_bytes(
            struct.pack(">ii", 2049, n) + labels.tobytes())
    monkeypatch.setenv("MNIST_DATA_DIR", str(tmp_path))
    monkeypatch.delenv("ELASTIC_HEARTBEAT_FILE", raising=False)

    def refuse(self, *args, **kwargs):
        raise AssertionError(f"a flagless run built a {type(self).__name__}")

    for cls in (runtime.ResilientRuntime, obs.Telemetry, obs.EventSink):
        monkeypatch.setattr(cls, "__init__", refuse)
    reads = []
    item = torch.Tensor.item
    monkeypatch.setattr(torch.Tensor, "item", lambda t: reads.append(1) or item(t))
    args = ["--epochs", "1", "--train-limit", "128", "--pallas-opt", "--prefetch-depth", "2"]
    fit(train_parser().parse_args(args), "cpu")
    # 2 steps, one log line (batch 0); one eval batch of two numbers
    assert len(reads) == 1 + 2


# -- the operator tools (tools/serve_loadgen.py, tools/slo_gate.py) ------------

TOOL_MODULES = ("tools/__init__.py", "tools/serve_loadgen.py", "tools/slo_gate.py")
_PARSE_ARGS = argparse.ArgumentParser.parse_args


def test_the_tools_join_the_scans():
    """Both scans above walk the package, the tools included; and the
    tools import torch only inside the functions that serve."""
    scanned = {str(p.relative_to(PKG)) for p in PORT_FILES if PKG in p.parents}
    assert set(TOOL_MODULES) <= scanned
    for name in TOOL_MODULES:
        body = ast.parse((PKG / name).read_text()).body
        top = {alias.name for node in body if isinstance(node, ast.Import)
               for alias in node.names}
        top |= {node.module for node in body
                if isinstance(node, ast.ImportFrom) and node.module}
        assert not {n for n in top if n.split(".")[0] in FORBIDDEN_ROOTS + ("torch",)}, name


def test_loadgen_url_mode_runs_with_torch_poisoned(tmp_path):
    """``--url`` drives a server with no torch in the driving process (the
    server here is this test process's, on the CPU)."""
    engine = InferenceEngine.from_seed(1, device="cpu", buckets=(4, 8))
    engine.warmup()
    server = make_server(engine, ServingMetrics(), port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    code = (
        "import sys\n"
        f"for name in {FORBIDDEN_ROOTS + ('torch',)!r}:\n"
        "    sys.modules[name] = None\n"
        "from pytorch_mnist_ddp_tpu_torch.tools.serve_loadgen import main\n"
        f"rc = main(['--url', {url!r}, '--requests', '12', '--max-request', '4',\n"
        "            '--open-loop', '--rate', '200', '--wire', 'binary',\n"
        "            '--qos-mix', 'interactive=0.5,batch=0.5', '--report', 'r.json'])\n"
        "assert not [m for m, v in sys.modules.items() if m.startswith('torch') and v]\n"
        "sys.exit(rc)\n"
    )
    try:
        proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                              text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(ROOT)})
    finally:
        server.shutdown()
        server.batcher.stop(drain=True)
        server.server_close()
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "zero additional compiles (bucket firewall held)" in proc.stdout
    report = json.loads((tmp_path / "r.json").read_text())
    assert report["status_counts"] == {"200": 12}


def _report_defaults(parser_main, argv: list[str], monkeypatch) -> dict:
    """The parsed defaults of a tool's report flags (its main, stopped at
    the parse)."""
    seen = {}

    def stop(self, args=None, namespace=None):
        seen.update(vars(_PARSE_ARGS(self, args, namespace)))
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(SystemExit):
        parser_main(argv)
    return seen


def test_the_tools_write_under_build_loadgen_and_leave_the_bench_files(tmp_path, monkeypatch,
                                                                        capsys):
    tracked = {p.name: p.read_bytes() for p in ROOT.glob("BENCH_*.json")}
    assert tracked  # the JAX tools' committed reports
    loadgen = _report_defaults(loadgen_main, [], monkeypatch)
    gate = _report_defaults(slo_gate.main, [], monkeypatch)
    monkeypatch.undo()
    paths = [v for k, v in loadgen.items() if k == "report" or k.endswith("_report")]
    assert len(paths) == 6 and gate["device"] == loadgen["device"] == "cuda"
    for path in paths + [gate["trajectory"]]:
        assert os.path.dirname(path) == os.path.join("build", "loadgen"), path
    monkeypatch.chdir(tmp_path)
    torch.set_num_threads(1)
    assert loadgen_main(["--device", "cpu", "--requests", "8", "--buckets", "4,8",
                         "--max-request", "4"]) == 0
    assert loadgen_main(["--device", "cpu", "--replicas-sweep", "1", "--requests", "8",
                         "--buckets", "4,8", "--max-request", "4"]) == 0
    assert sorted(os.listdir(tmp_path / "build" / "loadgen")) == [
        "BENCH_serving.json", "BENCH_serving_scaleout.json"]
    slo_gate._write_trajectory(gate["trajectory"], {"pass": True})
    assert (tmp_path / gate["trajectory"]).exists()
    assert {p.name: p.read_bytes() for p in ROOT.glob("BENCH_*.json")} == tracked
    assert serve_loadgen.REPORT_DIR == os.path.join("build", "loadgen")
