"""The port's ``tools/perf_report.py`` (``python -m
pytorch_mnist_ddp_tpu_torch.tools.perf_report``) held against the JAX
package's ``tools/perf_report.py``, both halves.

``--telemetry``: for the same events directory both ``summarize_telemetry``
functions return the same text.

The directories: the synthetic events of ``tests/test_compile.py``
(startup), ``tests/test_faults.py`` (pool resilience),
``tests/test_scaleout.py`` (scale-out) and ``tests/test_serving.py``
(serving); what the port's ``mnist --no-cuda --telemetry-dir`` writes,
flagless and with a healed NaN step and periodic checkpoints; what the
port's serving CLI writes at ``--warmup-only``; all of them in one
directory; and what the JAX trainer writes (``tests/test_obs.py``'s
run).

The verdict: for each set of artifacts (the ladder alone, with the trace
attribution, a warm row that reconciles and one that does not, the bf16
and conv ladders, the batch-1000 ladder latency- and compute-bound, a
partial ladder, two rounds, no ladder) both ``build_report`` functions
return the same text under one clock; so do they over what the step_attr
and trace_attr twins print on the CPU, promoted by the window_promote
twin; and the CLI writes only beside its artifacts.  One intra-op thread.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from pytorch_mnist_ddp_tpu_torch.mnist import build_parser
from pytorch_mnist_ddp_tpu_torch.serving import faults
from pytorch_mnist_ddp_tpu_torch.tools import perf_report
from pytorch_mnist_ddp_tpu_torch.trainer import fit

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_perf_report",
                                                  ROOT / "tools" / "perf_report.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX = _jax_tool()

# The synthetic fixtures of the JAX package's tests, event for event.
SYNTHETIC = {
    "startup": [  # tests/test_compile.py
        {"event": "span_end", "span": "compile", "fn": "fused_run", "duration_s": 2.0},
        {"event": "span_end", "span": "compile", "fn": "predict_step[8]", "duration_s": 0.5},
        {"event": "startup_overlap", "wall_s": 2.1,
         "tasks": {"fused_run": 2.0, "data": 1.0, "restore": 0.1}, "overlap_ratio": 0.32},
        {"event": "aot_executable", "fn": "fused_run", "outcome": "hit", "seconds": 0.2},
    ],
    "resilience": [  # tests/test_faults.py
        {"event": "replica_quarantine", "replica": "r1", "reason": "circuit_open", "flushed": 3},
        {"event": "replica_restart", "replica": "r1", "attempt": 1, "backoff_s": 0.2,
         "recovery_s": 0.35, "outcome": "restarted"},
        {"event": "replica_quarantine", "replica": "r0", "reason": "completion_stall",
         "flushed": 1},
        {"event": "replica_restart", "replica": "r0", "attempt": 1, "backoff_s": 0.2,
         "recovery_s": 0.25, "outcome": "restarted"},
        {"event": "circuit_transition", "replica": "r1", "src": "closed", "dst": "open",
         "reason": "failure_threshold"},
        {"event": "circuit_transition", "replica": "r1", "src": "open", "dst": "half-open",
         "reason": "restart_trial"},
        {"event": "circuit_transition", "replica": "r1", "src": "half-open", "dst": "closed",
         "reason": "trial_passed"},
        {"event": "replica_eject", "replica": "r2", "reason": "launch_failures", "attempts": 3},
        {"event": "request_retry"},
        {"event": "request_retry"},
    ],
    "scaleout": [  # tests/test_scaleout.py
        {"event": "serving_request", "n": 2, "latency_s": 0.010, "replica": "r0"},
        {"event": "serving_request", "n": 2, "latency_s": 0.012, "replica": "r0"},
        {"event": "serving_request", "n": 3, "latency_s": 0.030, "replica": "r1"},
        {"event": "router_decision", "policy": "cost", "replica": "r0", "rows": 2},
        {"event": "router_decision", "policy": "cost", "replica": "r1", "rows": 3},
        {"event": "replica_drain", "replica": "r1", "duration_s": 0.25},
        {"event": "replica_add", "replica": "r1", "duration_s": 0.02},
    ],
    "serving": [  # tests/test_serving.py
        {"event": "serving_request", "n": 2, "latency_s": 0.010},
        {"event": "serving_request", "n": 3, "latency_s": 0.030},
        {"event": "serving_batch", "real": 5, "bucket": 8, "fill_ratio": 0.625, "stall_s": 0.002},
    ],
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write(directory: pathlib.Path, events: list[dict], name="events-rank0.jsonl") -> str:
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / name, "w") as f:
        for e in events:
            f.write(json.dumps(e) + "\n")
    return str(directory)


def _fit(directory: pathlib.Path, *flags) -> str:
    args = build_parser().parse_args(["--epochs", "1", "--train-limit", "256",
                                      "--log-interval", "1000", "--telemetry-dir",
                                      str(directory), *flags])
    with contextlib.redirect_stdout(io.StringIO()):
        fit(args, "cpu")
    return str(directory)


@pytest.fixture(scope="module")
def port_dirs(tmp_path_factory):
    """Directories the port itself wrote: two trainer runs and a serving
    CLI's warmup."""
    root = tmp_path_factory.mktemp("port_tel")
    dirs = {"trainer": _fit(root / "trainer")}
    with faults.injected("nan:step:after=2"):
        dirs["trainer_guarded"] = _fit(root / "guarded", "--loss-guard",
                                       "--checkpoint-every-steps", "2", "--save-state",
                                       str(root / "g.npz"))
    tel = root / "serving"
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.serving", "--device", "cpu",
         "--warmup-only", "--buckets", "1,2", "--dtypes", "f32,int8", "--telemetry-dir",
         str(tel)], cwd=root, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    dirs["serving_warmup"] = str(tel)
    return dirs


def _same_text(directory: str) -> str:
    got = perf_report.summarize_telemetry(directory)
    assert got is not None
    assert got == JAX.summarize_telemetry(directory)
    return got


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_synthetic_fixture_gives_jax_text(tmp_path, name):
    _same_text(_write(tmp_path / name, SYNTHETIC[name]))


@pytest.mark.parametrize("name", ["trainer", "trainer_guarded", "serving_warmup"])
def test_port_written_directory_gives_jax_text(port_dirs, name):
    text = _same_text(port_dirs[name])
    if name.startswith("trainer"):
        assert "  steps: 4, mean" in text and "run wall:" in text
    if name == "trainer_guarded":
        assert "anomalies by kind: nan x1" in text
    if name == "serving_warmup":
        assert "startup compiles:" in text or "parity" in text


def test_every_fixture_in_one_directory(tmp_path, port_dirs):
    """Several files and runs in one directory (the summary reads each
    *.jsonl in name order)."""
    d = tmp_path / "all"
    for i, (name, events) in enumerate(sorted(SYNTHETIC.items())):
        _write(d, events, f"events-{i}-{name}.jsonl")
    for name, src in port_dirs.items():
        for path in pathlib.Path(src).glob("*.jsonl"):
            (d / f"{name}-{path.name}").write_bytes(path.read_bytes())
    _same_text(str(d))


def test_an_empty_directory_and_the_cli(tmp_path, capsys):
    assert perf_report.summarize_telemetry(str(tmp_path)) is None
    assert JAX.summarize_telemetry(str(tmp_path)) is None
    assert perf_report.main(["--telemetry", str(tmp_path)]) == 1
    assert "no parseable *.jsonl events" in capsys.readouterr().err
    d = _write(tmp_path / "s", SYNTHETIC["serving"])
    assert perf_report.main(["--telemetry", d]) == 0
    assert capsys.readouterr().out == JAX.summarize_telemetry(d) + "\n"


def test_jax_trainer_directory_gives_jax_text(tmp_path, monkeypatch):
    """A directory the JAX trainer wrote (tests/test_obs.py's run; its
    compiled fast path at its documented fallback, as in
    tests/test_torch_obs.py: the installed jax refuses the fast path's
    call)."""
    import argparse

    import jax
    import numpy as np

    import pytorch_mnist_ddp_tpu.data.mnist as jax_mnist
    from pytorch_mnist_ddp_tpu.compile import program as jax_program
    from pytorch_mnist_ddp_tpu.parallel.distributed import DistState
    from pytorch_mnist_ddp_tpu.trainer import fit as jax_fit

    monkeypatch.setattr(jax_program, "compiled_fastpath", lambda compiled: compiled)

    rng = np.random.RandomState(0)
    arrays = {"train": (rng.randint(0, 256, (64, 28, 28), np.uint8),
                        rng.randint(0, 10, 64).astype(np.uint8)),
              "test": (rng.randint(0, 256, (32, 28, 28), np.uint8),
                       rng.randint(0, 10, 32).astype(np.uint8))}
    def tiny(root="./data", split="train", *a, return_source=False, **kw):
        return (*arrays[split], "idx") if return_source else arrays[split]

    monkeypatch.setattr(jax_mnist, "load_mnist_arrays", tiny)
    tel = tmp_path / "telemetry"
    args = argparse.Namespace(
        batch_size=16, test_batch_size=16, epochs=1, lr=1.0, gamma=0.7, seed=1,
        log_interval=2, dry_run=True, save_model=False, fused=False, data_root="./data",
        profile=None, step_stats=False, telemetry_dir=str(tel))
    with contextlib.redirect_stdout(io.StringIO()):
        jax_fit(args, DistState(devices=jax.devices()[:1]))
    assert "steps: 1" in _same_text(str(tel))


# -- the verdict half (build_report, main without --telemetry) -----------------

# A whole ladder in µs a step, as the step_attr twin prints it on the card.
LADDER = {"metric": "step_attr_us", "backend": "gpu", "device_kind": "NVIDIA H100 80GB HBM3",
          "steps": 300, "batch": 200, "compute_dtype": "float32", "conv_impl": "conv",
          "empty_scan": 1.21, "gather_norm": 28.13, "gather_epoch": 24.62, "fwd": 425.6,
          "fwd_bwd": 1183.75, "full_nodrop": 1295.84, "full": 1277.43,
          "full_nogather": 1266.41, "full_pregather": 1352.29, "eval": 1286.73,
          "compile_s": {"full": 1.4}}
# JAX's test's ladder: five rungs, nothing of the pregather or dropout.
PARTIAL = {"metric": "step_attr_us", "device_kind": "test", "steps": 300, "batch": 200,
           "full": 830.0, "fwd_bwd": 700.0, "eval": 900.0, "empty_scan": 5.0,
           "gather_norm": 30.0}
# Input-bound: fwd+bwd under 80% of the step, the pregather 17% faster.
OVERHEAD = {**LADDER, "fwd": 210.0, "fwd_bwd": 400.0, "full_pregather": 1060.0}
ATTR = {"metric": "trace_attribution", "process": "GPU 0", "thread": "streams 7, 20",
        "span_s": 0.059641, "busy_s": 0.052083, "gap_share": 0.127, "kernel_s": 0.05574,
        "by_category": {"convolution": {"time_s": 0.0158, "count": 1700, "share_of_busy": 0.283},
                        "matmul": {"time_s": 0.0153, "count": 1400, "share_of_busy": 0.274}}}


def _row(**keys):
    return {"metric": "step_attr_us", "device_kind": "NVIDIA H100 80GB HBM3", "steps": 300,
            "batch": 200, **keys}


# name -> ({file: row}, a phrase the report must hold, or None for no report)
ARTIFACT_SETS = {
    "ladder": ({"bench_r1_stepattr.json": LADDER}, "Input path verdict: pregather wins only"),
    "with_attr": ({"bench_r1_stepattr.json": LADDER, "bench_r1_attr.json": ATTR},
                  "Trace: device busy 0.052083s over 0.059641s span"),
    "warm_reconciles": ({"bench_r1_stepattr.json": LADDER,
                         "bench_r1_warm.json": {"run_s": 8.41, "cache": "warm"}},
                        "— reconciles (0.94×)"),
    "warm_does_not_reconcile": ({"bench_r1_stepattr.json": LADDER,
                                 "bench_r1_warm.json": {"run_s": 21.7, "cache": "cold"}},
                                "DOES NOT reconcile"),
    "bf16": ({"bench_r1_stepattr.json": LADDER,
              "bench_r1_stepattr_bf16.json": _row(compute_dtype="bfloat16", full=1004.2)},
             "bf16 ladder: full 1,004.2 µs vs f32 1,277.4 µs (+21%)."),
    "conv_c1_wins_im2col_not": (
        {"bench_r1_stepattr.json": LADDER,
         "bench_r1_stepattr_im2col_c1.json": _row(conv_impl="im2col_c1", full=1150.0,
                                                  fwd=380.5),
         "bench_r1_stepattr_im2col.json": _row(conv_impl="im2col", full=1250.0, fwd=440.0)},
        "conv ladder (im2col): full 1,250.0 µs vs native-conv 1,277.4 µs (+2%); fwd 440.0 "
        "vs 425.6 µs — keep the native conv."),
    "conv_im2col_wins_c1_not": (
        {"bench_r1_stepattr.json": LADDER,
         "bench_r1_stepattr_im2col_c1.json": _row(conv_impl="im2col_c1", full=1390.0),
         "bench_r1_stepattr_im2col.json": _row(conv_impl="im2col", full=900.0, fwd=300.0)},
        "— flip `--conv-impl` after an end-to-end `bench.py --conv-impl` row confirms"),
    "b1000_latency_bound": ({"bench_r5_stepattr.json": PARTIAL,
                             "bench_r5_stepattr_b1000.json": {"metric": "step_attr_us",
                                                              "batch": 1000, "steps": 60,
                                                              "full": 1100.0}},
                            "per-op/latency overhead"),
    "b1000_compute_bound": ({"bench_r5_stepattr.json": PARTIAL,
                             "bench_r5_stepattr_b1000.json": {"metric": "step_attr_us",
                                                              "batch": 1000, "steps": 60,
                                                              "full": 3800.0}},
                            "bandwidth/compute-bound"),
    "partial_ladder": ({"bench_r5_stepattr.json": PARTIAL},
                       "| input (pregather alternative) | — |"),
    "overhead_bound_pregather_flips": ({"bench_r1_stepattr.json": OVERHEAD},
                                       "**Flip to pregather**: the pregather step is 17% faster"),
    "newer_round_shadows_older": (
        {"bench_r4_stepattr.json": PARTIAL,
         "bench_r4_stepattr_bf16.json": _row(full=600.0),
         "bench_r4_attr.json": ATTR,
         "bench_r12_stepattr.json": LADDER,
         "bench_r12_warm.json": {"run_s": 8.0, "cache": "warm"}},
        "artifacts bench_r12_*"),
    "everything": ({"bench_r1_stepattr.json": OVERHEAD, "bench_r1_attr.json": ATTR,
                    "bench_r1_warm.json": {"run_s": 8.41, "cache": "warm"},
                    "bench_r1_stepattr_bf16.json": _row(full=1004.2),
                    "bench_r1_stepattr_im2col_c1.json": _row(full=1150.0, fwd=380.5),
                    "bench_r1_stepattr_im2col.json": _row(full=1250.0),
                    "bench_r1_stepattr_b1000.json": _row(batch=1000, steps=60, full=2400.0)},
                   "see the attribution rows above"),
    "no_ladder": ({"bench_r1_attr.json": ATTR, "bench_r1_stepattr_bf16.json": _row(full=9.0),
                   "bench_r1_warm.json": {"run_s": 8.0}}, None),
    "ladder_without_full": ({"bench_r1_stepattr.json": {**PARTIAL, "full": None}}, None),
    "unparseable_ladder": ({"bench_r1_stepattr.json": "{not json"}, None),
}


@pytest.fixture
def artifacts(tmp_path, monkeypatch):
    """A directory both tools read (the port's ARTIFACT_DIR, the JAX tool's
    REPO), and one clock for both."""
    import time
    import types

    d = tmp_path / "perf"
    d.mkdir()
    monkeypatch.setattr(perf_report, "ARTIFACT_DIR", str(d))
    monkeypatch.setattr(JAX, "REPO", str(d))
    clock = types.SimpleNamespace(strftime=time.strftime,
                                  gmtime=lambda *a: time.gmtime(1_800_000_000))
    monkeypatch.setattr(perf_report, "time", clock)
    monkeypatch.setattr(JAX, "time", clock)
    return d


def _put_artifacts(d: pathlib.Path, files: dict) -> None:
    for name, row in files.items():
        (d / name).write_text(row if isinstance(row, str) else json.dumps(row))


@pytest.mark.parametrize("name", sorted(ARTIFACT_SETS))
def test_the_verdict_is_jax_s_text(name, artifacts):
    files, phrase = ARTIFACT_SETS[name]
    _put_artifacts(artifacts, files)
    got, want = perf_report.build_report(), JAX.build_report()
    if phrase is None:
        assert got is None and want is None
        return
    assert got is not None and got.splitlines() == want.splitlines()
    assert phrase in got, got
    header = got.splitlines()[0]
    prefix = min(files, key=lambda f: (-int(f.split("_")[1][1:]), f)).split("_")[:2]
    assert header == (f"### Window analysis — 2027-01-15T08:00:00Z "
                      f"({files['_'.join(prefix) + '_stepattr.json']['device_kind']}; "
                      f"artifacts {'_'.join(prefix)}_*)")


def _tracked_digests() -> dict:
    import hashlib

    paths = sorted(ROOT.glob("BENCH_*.json")) + [ROOT / "docs" / "PERF.md"]
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest() for p in paths}


def test_the_cli_writes_only_under_its_artifact_dir(artifacts, capsys, monkeypatch):
    """Without a ladder: exit 1 and JAX's stderr line.  ``--no-write``
    prints only; without it ``PERF.md`` beside the artifacts gains exactly
    the printed block.  No tracked file changes."""
    before = _tracked_digests()
    assert len(before) > 1
    assert perf_report.main([]) == 1
    port_err = capsys.readouterr()
    monkeypatch.setattr(sys, "argv", ["perf_report.py", "--no-write"])
    assert JAX.main() == 1
    assert port_err.err == capsys.readouterr().err != ""
    assert port_err.out == ""
    _put_artifacts(artifacts, ARTIFACT_SETS["everything"][0])
    assert perf_report.main(["--no-write"]) == 0
    printed = capsys.readouterr().out
    assert printed == perf_report.build_report() + "\n"
    assert not (artifacts / "PERF.md").exists()
    assert perf_report.main([]) == 0
    assert capsys.readouterr().out == printed
    assert (artifacts / "PERF.md").read_text() == "\n" + printed
    assert perf_report.main([]) == 0
    assert (artifacts / "PERF.md").read_text() == 2 * ("\n" + printed)
    assert _tracked_digests() == before
    assert perf_report.ARTIFACT_DIR == str(artifacts)


def test_the_artifact_dir_is_the_checkout_s_build_perf():
    """build/ is untracked (.gitignore); the protocol constants are JAX's."""
    assert perf_report.ARTIFACT_DIR == str(ROOT / "build" / "perf")
    assert "build/" in (ROOT / ".gitignore").read_text().splitlines()
    assert (perf_report.TRAIN_STEPS, perf_report.EVAL_BATCHES, perf_report.EPOCHS) == (
        JAX.TRAIN_STEPS, JAX.EVAL_BATCHES, JAX.EPOCHS)


def _on_a_stream(trace_path: pathlib.Path, out: pathlib.Path) -> None:
    """The host ops of a CPU trace recast as kernels on one CUDA stream of
    device 0, as a card's trace carries its device work."""
    data = json.loads(trace_path.read_text())
    gpu, stream = 0, 7
    events = [{"ph": "M", "name": "process_labels", "pid": gpu, "tid": 0,
               "args": {"labels": "GPU 0"}},
              {"ph": "M", "name": "thread_name", "pid": gpu, "tid": stream,
               "args": {"name": f"stream {stream} "}}]
    events += [{**e, "cat": "kernel", "pid": gpu, "tid": stream}
               for e in data["traceEvents"] if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    out.write_text(json.dumps({"schemaVersion": 1, "traceEvents": events}))


def test_real_producers_through_the_promotion_give_jax_s_text(artifacts, tmp_path, capsys):
    """The step_attr twin's own lines (the ladder on the CPU, a batch
    variant and a bf16 one) and the trace_attr twin's JSON over a real CPU
    profiler trace of training steps, promoted by the window_promote twin
    as the artifacts are on the card: both reports print the same text.
    A CPU trace has no device line, so the twin's error JSON is one
    attribution; the same ops recast onto a stream are the other."""
    from pytorch_mnist_ddp_tpu_torch.models.net import Net
    from pytorch_mnist_ddp_tpu_torch.tools import step_attr_bench, trace_attr, window_promote
    from pytorch_mnist_ddp_tpu_torch.utils.profiling import trace

    small = ["--device", "cpu", "--allow-cpu", "--steps", "2", "--batch", "8",
             "--eval-batch", "16", "--eval-steps", "1", "--reps", "1"]
    runs = {"f32": [], "b1000": ["--batch", "40", "--only", "full,fwd_bwd"],
            "bf16": ["--bf16", "--only", "full"]}
    for name, extra in runs.items():
        assert step_attr_bench.main(small + extra) == 0
        (tmp_path / f"{name}.json").write_text(capsys.readouterr().out)
    ladder = json.loads((tmp_path / "f32.json").read_text())
    assert window_promote.count_rungs(ladder) == 10 and ladder["device_kind"] == "cpu"
    for name, dst in (("f32", "stepattr"), ("b1000", "stepattr_b1000")):
        assert window_promote.main(["rungs", str(tmp_path / f"{name}.json"),
                                    str(artifacts / f"bench_r1_{dst}.json")]) == 0
        assert capsys.readouterr().out.startswith("stepattr promoted")
    (artifacts / "bench_r1_stepattr_bf16.json").write_bytes(
        (tmp_path / "bf16.json").read_bytes())

    net = Net(torch.Generator().manual_seed(0))
    x = torch.randn(8, 28, 28, 1)
    with trace(str(tmp_path / "trace"), "cpu"):
        for _ in range(2):
            net(x).sum().backward()
    (cpu_trace,) = (tmp_path / "trace").glob("*.pt.trace.json")
    _on_a_stream(cpu_trace, tmp_path / "stream.pt.trace.json")
    texts = {}
    for name, path, rc in (("cpu_trace", cpu_trace, 1),
                           ("on_a_stream", tmp_path / "stream.pt.trace.json", 0)):
        assert trace_attr.main([str(path), "--out", str(tmp_path / f"{name}.json")]) == rc
        (artifacts / "bench_r1_attr.json").write_text(capsys.readouterr().out)
        got = perf_report.build_report()
        assert got == JAX.build_report()
        texts[name] = got
    assert "Trace:" not in texts["cpu_trace"]
    assert "Trace: device busy" in texts["on_a_stream"]
    for text in texts.values():
        assert text.splitlines()[0].endswith("(cpu; artifacts bench_r1_*)")
        assert sum(line.startswith("| ") and "|---|" not in line
                   for line in text.splitlines()) == 2 + 10 + 9
        assert "bf16 ladder: full" in text and "Batch-scaling:" in text
