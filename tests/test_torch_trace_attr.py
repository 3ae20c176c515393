"""The port's ``tools/trace_attr.py`` (``python -m
pytorch_mnist_ddp_tpu_torch.tools.trace_attr``) held against the JAX
package's ``tools/trace_attr.py``.

- Each fixture of ``tests/test_trace_attr.py`` (nested events, an
  overlapping non-nested event, host threads and gaps, the empty trace,
  the "Steps" line) rewritten as torch.profiler events on a CUDA stream:
  the twin's ``busy_s``, ``span_s``, ``gap_share``, ``by_category`` and
  ``top_ops`` equal JAX's output on the original.
- The categories: where each of a list of real kernel names lands (the
  port's three kernels among them), and why for those with no JAX
  counterpart.
- A real CPU trace from ``utils/profiling.trace`` has no device line and
  fails with the structured error.
"""

from __future__ import annotations

import gzip
import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from pytorch_mnist_ddp_tpu_torch.tools import trace_attr
from pytorch_mnist_ddp_tpu_torch.utils.profiling import trace

ROOT = pathlib.Path(__file__).resolve().parents[1]
COMPARED = ("busy_s", "span_s", "gap_share", "by_category", "top_ops")


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_trace_attr",
                                                  ROOT / "tools" / "trace_attr.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX = _jax_tool()


# -- the JAX fixtures (tests/test_trace_attr.py) --------------------------------

def _jax_meta(pid, pname, tid, tname):
    return [{"ph": "M", "pid": pid, "name": "process_name", "args": {"name": pname}},
            {"ph": "M", "pid": pid, "tid": tid, "name": "thread_name", "args": {"name": tname}}]


def _jax_op(pid, tid, name, ts, dur, module="jit_run"):
    return {"ph": "X", "pid": pid, "tid": tid, "ts": ts, "dur": dur, "name": name,
            "args": {"hlo_op": name, "hlo_module": module}}


def _write_jax(tmp_path, events):
    d = tmp_path / "jax" / "plugins" / "profile" / "2026_01_01_00_00_00"
    d.mkdir(parents=True)
    with gzip.open(d / "vm.trace.json.gz", "wt") as f:
        json.dump({"displayTimeUnit": "ns", "traceEvents": events}, f)
    return str(tmp_path / "jax")


# -- the same work as torch.profiler writes it: kernels on a stream -------------

GPU, STREAM = 0, 7
HOST = 4242


def _port_meta():
    return [{"ph": "M", "name": "process_name", "pid": GPU, "tid": 0,
             "args": {"name": "python3"}},
            {"ph": "M", "name": "process_labels", "pid": GPU, "tid": 0,
             "args": {"labels": "GPU 0"}},
            {"ph": "M", "name": "thread_name", "pid": GPU, "tid": STREAM,
             "args": {"name": f"stream {STREAM} "}},
            {"ph": "M", "name": "process_name", "pid": HOST, "tid": 0,
             "args": {"name": "python3"}},
            {"ph": "M", "name": "thread_name", "pid": HOST, "tid": HOST,
             "args": {"name": f"thread {HOST} (python3)"}}]


def _kernel(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": GPU, "tid": STREAM, "ts": ts,
            "dur": dur, "args": {"device": GPU, "stream": STREAM}}


def _host(name, ts, dur, cat="cpu_op"):
    return {"ph": "X", "cat": cat, "name": name, "pid": HOST, "tid": HOST, "ts": ts, "dur": dur,
            "args": {}}


def _write_port(tmp_path, events, gz=False):
    d = tmp_path / "port"
    d.mkdir()
    payload = {"schemaVersion": 1, "traceEvents": _port_meta() + events}
    if gz:
        with gzip.open(d / "host_1.1.pt.trace.json.gz", "wt") as f:
            json.dump(payload, f)
    else:
        (d / "host_1.1.pt.trace.json").write_text(json.dumps(payload))
    return str(d)


FIXTURES = {
    "nested": (
        _jax_meta(1, "/device:TPU:0", 10, "XLA Ops") + [
            _jax_op(1, 10, "while.1", 0.0, 100.0),
            _jax_op(1, 10, "convolution.1", 10.0, 30.0),
            _jax_op(1, 10, "loop_add_fusion.2", 50.0, 20.0)],
        [_kernel("while.1", 0.0, 100.0), _kernel("convolution.1", 10.0, 30.0),
         _kernel("loop_add_fusion.2", 50.0, 20.0)]),
    "overlapping": (
        _jax_meta(1, "/device:TPU:0", 10, "XLA Ops") + [
            _jax_op(1, 10, "while.1", 0.0, 100.0),
            _jax_op(1, 10, "fusion.1", 10.0, 20.0),
            _jax_op(1, 10, "dot.1", 15.0, 30.0)],
        [_kernel("while.1", 0.0, 100.0), _kernel("fusion.1", 10.0, 20.0),
         _kernel("dot.1", 15.0, 30.0)]),
    "host_threads": (
        _jax_meta(1, "/device:TPU:0", 10, "XLA Ops") + _jax_meta(2, "/host:CPU", 20, "python")
        + [_jax_op(1, 10, "dot.1", 0.0, 25.0), _jax_op(1, 10, "dot.2", 75.0, 25.0),
           {"ph": "X", "pid": 2, "tid": 20, "ts": 0.0, "dur": 1e6, "name": "PyRun"}],
        [_kernel("dot.1", 0.0, 25.0), _kernel("dot.2", 75.0, 25.0),
         _host("PyRun", 0.0, 1e6), _host("cudaLaunchKernel", 1.0, 5.0, "cuda_runtime")]),
    "steps_line": (
        _jax_meta(1, "/device:TPU:0", 10, "XLA Ops") + _jax_meta(1, "/device:TPU:0", 11, "Steps")
        + [_jax_op(1, 10, "convolution.1", 0.0, 30.0),
           {"ph": "X", "pid": 1, "tid": 11, "ts": 0.0, "dur": 100.0, "name": "1"},
           {"ph": "X", "pid": 1, "tid": 11, "ts": 100.0, "dur": 100.0, "name": "2"}],
        [_kernel("convolution.1", 0.0, 30.0),
         _kernel("1", 0.0, 100.0, cat="gpu_user_annotation"),
         _kernel("2", 100.0, 100.0, cat="gpu_user_annotation")]),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_gives_jax_numbers(tmp_path, name):
    jax_events, port_events = FIXTURES[name]
    want = JAX.attribute(_write_jax(tmp_path, jax_events))
    got = trace_attr.attribute(_write_port(tmp_path, port_events))
    assert {k: got[k] for k in COMPARED} == {k: want[k] for k in COMPARED}
    assert (got["op_events"], got["overlap_events"]) == (want["op_events"],
                                                         want["overlap_events"])
    assert (got["process"], got["thread"]) == ("GPU 0", f"stream {STREAM}")


def test_the_fixtures_keep_jax_s_pins(tmp_path):
    """The numbers tests/test_trace_attr.py pins, read off the twin."""
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    nested = trace_attr.attribute(_write_port(tmp_path / "a", FIXTURES["nested"][1]))
    ops = {o["op"]: o["time_s"] for o in nested["top_ops"]}
    assert ops == pytest.approx({"convolution.1": 30e-6, "loop_add_fusion.2": 20e-6,
                                 "while.1": 50e-6})
    assert nested["busy_s"] == pytest.approx(100e-6) and nested["gap_share"] == 0.0
    steps = trace_attr.attribute(_write_port(tmp_path / "b", FIXTURES["steps_line"][1]))
    assert steps["top_ops"][0]["op"] == "convolution.1"
    assert steps["other_op_lines"] == {f"GPU 0:stream {STREAM} annotations": 200e-6}


def test_gzip_and_file_paths_read_alike(tmp_path):
    events = FIXTURES["host_threads"][1]
    plain = trace_attr.attribute(_write_port(tmp_path, events))
    (tmp_path / "gz").mkdir()
    gz = trace_attr.attribute(_write_port(tmp_path / "gz", events, gz=True))
    path = next((tmp_path / "port").glob("*.pt.trace.json"))
    assert plain == gz == trace_attr.attribute(str(path))


def test_annotation_line_is_main_only_without_device_ops(tmp_path):
    """No stream ran an op: the error, as JAX's with no op line; the
    annotation line alone does not make a device line."""
    d = _write_port(tmp_path, [_kernel("ProfilerStep#1", 0.0, 100.0, "gpu_user_annotation")])
    with pytest.raises(ValueError, match="no device op events"):
        trace_attr.attribute(d)


def _cli(*argv):
    return subprocess.run([sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.tools.trace_attr",
                           *argv], capture_output=True, text=True, timeout=60, cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})


def test_empty_trace_fails_structured(tmp_path):
    proc = _cli(str(tmp_path))
    assert proc.returncode == 1
    out = json.loads(proc.stdout)
    assert out["metric"] == "trace_attribution" and out["error"]


def test_cli_out_and_top(tmp_path):
    d = _write_port(tmp_path, FIXTURES["nested"][1])
    out = tmp_path / "attr.json"
    proc = _cli(d, "--out", str(out), "--top", "1")
    assert proc.returncode == 0, proc.stderr
    printed = json.loads(proc.stdout)
    assert printed == json.loads(out.read_text())
    assert [o["op"] for o in printed["top_ops"]] == ["while.1"]


def test_a_cpu_trace_has_no_device_line(tmp_path):
    """utils/profiling.trace on the CPU writes host events only."""
    x = torch.ones(8, 8)
    with trace(str(tmp_path), "cpu"):
        (x @ x).sum()
    assert list(tmp_path.glob("*.pt.trace.json"))
    with pytest.raises(ValueError, match="no device op events"):
        trace_attr.attribute(str(tmp_path))
    assert trace_attr.main([str(tmp_path)]) == 1


# -- categories -------------------------------------------------------------------

# Real kernel names off the card (tests/torch_trace_kernel_names.json says
# where from), each with where it lands and why.
REAL = json.loads((ROOT / "tests" / "torch_trace_kernel_names.json").read_text())["pins"]
# (name, category, why): XLA names, which land where JAX puts them; names
# the card's traces did not hold, as their sources declare them; the
# port's kernels, which land where the XLA ops they replace land.
CATEGORY_PINS = [(r["name"], r["category"], r["why"]) for r in REAL] + [
    ("loop_convolution_fusion", "convolution", "JAX: a fusion is named after its root"),
    ("dot_general.3", "matmul", "JAX"),
    ("all-reduce.1", "collective", "JAX"),
    ("copy.4", "copy_layout", "JAX"),
    ("reduce.7", "reduce", "JAX"),
    ("select-and-scatter.2", "gather_scatter", "JAX"),
    ("loop_add_fusion", "elementwise_fusion", "JAX"),
    ("custom-call.1", "other", "JAX: no pattern"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)", "collective",
     "NCCL's all-reduce: a collective, not a reduce (an NCCL world of one launches none)"),
    ("void (anonymous namespace)::flash_kernel<float, 4, 64, 16, 4>((anonymous namespace)::"
     "Params)", "matmul", "rows 4/5 (csrc/flash_attention.cu): attention's QK^T and PV, "
     "JAX's plain version two dots"),
    ("void (anonymous namespace)::flash_wide_kernel<float, 4>((anonymous namespace)::Params)",
     "matmul", "rows 4/5 past head_dim 128"),
    ("void (anonymous namespace)::int8_head_kernel<true, true, false>(float const*, int, int, "
     "signed char const*, float const*, float const*, int, signed char const*, float const*, "
     "float const*, int, float*)", "matmul",
     "row 1 (csrc/int8_head.cu): fc1 and fc2 as int8 GEMMs, JAX's plain version two dots"),
]


@pytest.mark.parametrize("name, category, why", CATEGORY_PINS,
                         ids=[f"{c}:{n[:48]}" for n, c, _ in CATEGORY_PINS])
def test_category_pins(name, category, why):
    assert trace_attr._categorize(name) == category, why


@pytest.mark.parametrize("name", [n for n, _, why in CATEGORY_PINS if why.startswith("JAX")])
def test_xla_names_land_where_jax_puts_them(name):
    assert trace_attr._categorize(name) == JAX._categorize(name)


def _on(stream, name, ts, dur):
    return {**_kernel(name, ts, dur), "tid": stream, "args": {"device": GPU, "stream": stream}}


def test_a_device_s_streams_are_one_line(tmp_path):
    """A replayed CUDA graph runs its kernels one after another on several
    of CUDA's streams: one timeline, every kernel in its table."""
    events = [_on(7, "a", 0.0, 10.0), _on(175, "b", 12.0, 5.0), _on(176, "a", 20.0, 10.0),
              _on(7, "c", 40.0, 10.0)]
    got = trace_attr.attribute(_write_port(tmp_path, events))
    assert got["thread"] == "streams 7, 175, 176"
    assert got["busy_s"] == pytest.approx(35e-6) and got["span_s"] == pytest.approx(50e-6)
    assert {o["op"]: o["count"] for o in got["top_ops"]} == {"a": 2, "b": 1, "c": 1}
    assert got["overlap_events"] == 0 and got["other_op_lines"] == {}


def test_kernels_that_ran_at_once_count_once(tmp_path):
    """Two streams busy at once: busy_s is the time the device was busy,
    each kernel keeps its own stream's time, and the time they shared is
    reported apart."""
    events = [_on(7, "a", 0.0, 20.0), _on(9, "b", 10.0, 20.0)]
    got = trace_attr.attribute(_write_port(tmp_path, events))
    assert got["busy_s"] == pytest.approx(30e-6) and got["kernel_s"] == pytest.approx(40e-6)
    assert got["concurrent_s"] == pytest.approx(10e-6) and got["concurrent_share"] == 0.25
    assert got["concurrent_events"] == 2 and got["overlap_events"] == 0
    assert {o["op"]: o["time_s"] for o in got["top_ops"]} == pytest.approx(
        {"a": 20e-6, "b": 20e-6})
    assert [o["share_of_busy"] for o in got["top_ops"]] == [0.5, 0.5]


def test_a_kernel_inside_another_stream_s_is_not_its_child(tmp_path):
    """An FFT transform that runs wholly inside a GEMM on another stream:
    the GEMM keeps its whole duration (the merged walk would have charged
    the transform to it as a nested child) and both count as concurrent."""
    events = [_on(7, "gemm", 0.0, 50.0), _on(9, "fft2d_r2c", 10.0, 20.0),
              _on(7, "elementwise_kernel", 60.0, 10.0)]
    got = trace_attr.attribute(_write_port(tmp_path, events))
    ops = {o["op"]: o["time_s"] for o in got["top_ops"]}
    assert ops == pytest.approx({"gemm": 50e-6, "fft2d_r2c": 20e-6, "elementwise_kernel": 10e-6})
    assert got["busy_s"] == pytest.approx(60e-6) and got["concurrent_s"] == pytest.approx(20e-6)
    assert got["concurrent_events"] == 2 and got["gap_share"] == round(1 - 60 / 70, 3)
    assert got["by_category"]["convolution"]["share_of_busy"] == 0.25


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_one_stream_has_nothing_concurrent(tmp_path, name):
    """On one stream kernel_s is busy_s, as JAX's tool knows one busy."""
    got = trace_attr.attribute(_write_port(tmp_path, FIXTURES[name][1]))
    assert got["kernel_s"] == got["busy_s"]
    assert (got["concurrent_s"], got["concurrent_events"]) == (0.0, 0)
