"""The port's ``compile/`` (startup: the build service, the startup
overlap, the kernel-library store, Programs) held against the JAX
package's, on the CPU.

- ``CompileService`` and ``StartupTasks`` of both packages run the same
  fake jobs, which sleep and so release the GIL as an ``nvcc`` child or
  XLA's compiler does: the same counter names and spans, the same errors
  and refusals, no false overlap on a dependent chain, overlap ratios
  within ``RATIO_TOL`` of each other (the two runs are timed apart, so
  only the shape of the schedule is held, not the milliseconds).
- ``ExecutableStore``: the JAX store cannot round-trip on this box (its
  executables' fast path refuses the installed jax), so the port's store
  is held to the behaviours the JAX package's own tests pin
  (tests/test_compile.py): miss, hit, a fallback that rewrites the entry,
  pruning, modes, keys, concurrent writers.  There is no ``nvcc`` here:
  a fake nvcc writes a small file, a fake loader reads it, and the
  environment (the torch build, the driver, the card) is a fixed dict.
- The CLIs: a run with ``--aot-cache --serve-prewarm`` prints and saves
  what a flagless one does; ``--serve-prewarm``'s refusals are the JAX
  trainer's texts; engines and a pool with a store, a serial warmup or
  device staging off answer exactly as the default.
"""

from __future__ import annotations

import json
import os
import pathlib
import struct
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu.compile import CompileService as JaxCompileService
from pytorch_mnist_ddp_tpu.compile import StartupTasks as JaxStartupTasks
from pytorch_mnist_ddp_tpu.models.net import init_params
from pytorch_mnist_ddp_tpu.obs.events import EventSink as JaxEventSink
from pytorch_mnist_ddp_tpu.obs.events import read_events as jax_read_events
from pytorch_mnist_ddp_tpu.obs.registry import Registry as JaxRegistry
from pytorch_mnist_ddp_tpu.parallel.mesh import make_mesh
from pytorch_mnist_ddp_tpu.serving.engine import InferenceEngine as JaxEngine
from pytorch_mnist_ddp_tpu.serving.metrics import ServingMetrics as JaxServingMetrics
from pytorch_mnist_ddp_tpu_torch.compile import (
    CompileService,
    ExecutableStore,
    Program,
    StartupTasks,
    build_programs,
    source_digest,
)
from pytorch_mnist_ddp_tpu_torch.compile import aot
from pytorch_mnist_ddp_tpu_torch.data.mnist import _FILES, synthetic_mnist
from pytorch_mnist_ddp_tpu_torch.mnist import build_parser
from pytorch_mnist_ddp_tpu_torch.mnist import main as cli_main
from pytorch_mnist_ddp_tpu_torch.mnist_ddp import build_parser as ddp_parser
from pytorch_mnist_ddp_tpu_torch.models.net import Net
from pytorch_mnist_ddp_tpu_torch.obs.events import EventSink, read_events
from pytorch_mnist_ddp_tpu_torch.obs.registry import Registry
from pytorch_mnist_ddp_tpu_torch.ops import _build
from pytorch_mnist_ddp_tpu_torch.parallel.distributed import DistState
from pytorch_mnist_ddp_tpu_torch.serving import faults
from pytorch_mnist_ddp_tpu_torch.serving.engine import InferenceEngine
from pytorch_mnist_ddp_tpu_torch.serving.metrics import ServingMetrics
from pytorch_mnist_ddp_tpu_torch.serving.pool import EnginePool
from pytorch_mnist_ddp_tpu_torch.trainer import fit
from pytorch_mnist_ddp_tpu_torch.utils.compile_cache import enable_persistent_cache
from test_torch_resume import assert_jax_text

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = ("jax", "port")
SERVICE = {"jax": JaxCompileService, "port": CompileService}
TASKS = {"jax": JaxStartupTasks, "port": StartupTasks}
REGISTRY = {"jax": JaxRegistry, "port": Registry}
SINK = {"jax": (JaxEventSink, jax_read_events), "port": (EventSink, read_events)}
DELAY = 0.05  # a fake job's sleep
# The two packages' ratios come from two timed runs: their schedules are
# the same, their milliseconds are not.  Two 50 ms legs side by side score
# ~0.5 in both; a loaded 6-worker host moves a run by up to ~0.15.
RATIO_TOL = 0.2
LIMIT = 256  # IDX rows a split for the CLI runs
ENV = {"torch_version": "2.x", "torch_cuda": "12.x", "driver": 12040,
       "device_kind": "NVIDIA H100 80GB HBM3", "capability": "9.0", "num_devices": 1}
TOOLKIT = "Cuda compilation tools, release 12.x"
ASK_NVCC = aot._nvcc_version.__wrapped__  # the real toolkit query, uncached


# -- the service and the startup overlap, against JAX's ------------------------

def _ladder_wall(pkg: str, n: int, workers: int) -> float:
    with SERVICE[pkg](max_workers=workers) as svc:
        # The clock starts before the first submit: a worker may start
        # (and one-worker runs finish) a job while the rest are submitted.
        t0 = time.perf_counter()
        jobs = [svc.submit(f"bucket[{i}]", time.sleep, DELAY) for i in range(n)]
        for job in jobs:
            job.result()
        return time.perf_counter() - t0


@pytest.mark.parametrize("pkg", PACKAGES)
def test_fanout_beats_the_serial_sum_in_both(pkg):
    """JAX's structural pin: three GIL-releasing jobs over three workers
    take well under the one-worker sum."""
    serial = _ladder_wall(pkg, 3, 1)
    parallel = _ladder_wall(pkg, 3, 3)
    assert serial >= 3 * DELAY
    assert parallel < 0.75 * serial


def _service_record(pkg: str, tmp_path) -> tuple[set, set]:
    registry = REGISTRY[pkg]()
    sink_cls, read = SINK[pkg]
    sink = sink_cls(str(tmp_path / pkg))
    with SERVICE[pkg](max_workers=2, registry=registry, sink=sink) as svc:
        svc.submit("int8_head", time.sleep, 0.01)
        svc.submit("restore", time.sleep, 0.01, kind="startup_task")
        svc.wait_all()
    sink.close()
    families = {name: children for name, _, _, children in registry.collect()}
    labels = {tuple(sorted(lab.items())) for lab, _ in families["compile_seconds_total"]}
    spans = {(e.get("span"), e.get("fn")) for e in read(sink.path) if e["event"] == "span_end"}
    assert registry.counter("compile_seconds_total", fn="int8_head").value >= 0.01
    return labels, spans


def test_service_counters_and_spans_are_jaxs(tmp_path):
    """The same compile_seconds_total labels (a startup task never lands
    on it) and the same (span, fn) pairs."""
    jax_record = _service_record("jax", tmp_path)
    port_record = _service_record("port", tmp_path)
    assert port_record == jax_record
    assert port_record == ({(("fn", "int8_head"),)},
                           {("compile", "int8_head"), ("startup_task", "restore")})


@pytest.mark.parametrize("pkg", PACKAGES)
def test_errors_propagate_and_bad_workers_are_refused_in_both(pkg):
    def boom():
        raise RuntimeError("nvcc failed")

    with SERVICE[pkg](max_workers=1) as svc:
        job = svc.submit("boom", boom)
        with pytest.raises(RuntimeError, match="nvcc failed"):
            job.result()
        with pytest.raises(RuntimeError, match="nvcc failed"):
            svc.wait_all()
    with pytest.raises(ValueError, match="max_workers must be >= 1, got 0"):
        SERVICE[pkg](max_workers=0)


def _overlap(pkg: str, tmp_path) -> tuple[float, dict]:
    registry = REGISTRY[pkg]()
    sink_cls, read = SINK[pkg]
    sink = sink_cls(str(tmp_path / pkg))
    with SERVICE[pkg](max_workers=2, registry=registry, sink=sink) as svc:
        tasks = TASKS[pkg](svc, registry=registry, sink=sink)
        tasks.add("fused_run", lambda: time.sleep(DELAY), kind="compile")
        tasks.add("data", lambda: time.sleep(DELAY))
        ratio = tasks.rendezvous()
        assert tasks.duration("fused_run") >= DELAY
    sink.close()
    assert registry.gauge("startup_overlap_ratio").value == pytest.approx(ratio)
    [event] = [e for e in read(sink.path) if e["event"] == "startup_overlap"]
    assert event["overlap_ratio"] == pytest.approx(ratio) and event["wall_s"] > 0
    return ratio, {"tasks": sorted(event["tasks"]), "keys": sorted(event)}


def test_overlap_ratio_and_event_agree_with_jax(tmp_path):
    jax_ratio, jax_event = _overlap("jax", tmp_path)
    port_ratio, port_event = _overlap("port", tmp_path)
    assert port_event == jax_event
    assert port_ratio > 0.2 and jax_ratio > 0.2
    assert abs(port_ratio - jax_ratio) <= RATIO_TOL


def _chain(pkg: str) -> tuple[float, float, float]:
    def restore():
        time.sleep(DELAY)
        return "lead"

    with SERVICE[pkg](max_workers=2) as svc:
        tasks = TASKS[pkg](svc)
        tasks.add("restore", restore)
        tasks.add("data", lambda: (tasks.result("restore"), time.sleep(DELAY), "run")[-1])
        assert tasks.result("data") == "run"
        ratio = tasks.rendezvous()
    return ratio, tasks.duration("data"), tasks.wait_seconds("data")


def test_a_dependent_chain_claims_no_overlap_in_either():
    """The restore -> upload chain of the fused startup runs strictly in
    turn: both packages exclude the wait from the ratio and keep it in
    the task's duration."""
    for pkg in PACKAGES:
        ratio, duration, wait = _chain(pkg)
        assert 0.0 <= ratio < 0.2, pkg
        assert duration >= DELAY + wait - 1e-3, pkg


@pytest.mark.parametrize("pkg", PACKAGES)
def test_a_duplicate_task_name_is_refused_in_both(pkg):
    with SERVICE[pkg](max_workers=1) as svc:
        tasks = TASKS[pkg](svc)
        tasks.add("a", lambda: None)
        with pytest.raises(ValueError, match="startup task 'a' already added"):
            tasks.add("a", lambda: None)
        tasks.rendezvous()


# -- the store ----------------------------------------------------------------

@pytest.fixture
def env(monkeypatch):
    """A fixed environment (this box has no card and no nvcc) and a clean
    process-wide library table."""
    current = dict(ENV)
    monkeypatch.setattr(aot, "_environment", lambda: dict(current))
    monkeypatch.setattr(aot, "_nvcc_version", lambda: TOOLKIT)
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_locks", {})
    monkeypatch.setattr(_build, "_origins", {})
    return current


class FakeNvcc:
    """Writes a library whose bytes differ build to build (as nvcc's
    embedded temporary names make a real one's), and counts builds."""

    def __init__(self):
        self.builds = 0

    def __call__(self, path: str) -> str:
        self.builds += 1
        pathlib.Path(path).write_bytes(b"library build %d" % self.builds)
        return f"ptxas info: build {self.builds}"


def _load(path: str) -> bytes:
    return pathlib.Path(path).read_bytes()


def _entry_files(store: ExecutableStore, name: str) -> tuple[dict, pathlib.Path]:
    header = store.entry(name)
    return header, pathlib.Path(store.directory) / header["file"]


def test_miss_then_hit_loads_the_cold_build(env, tmp_path):
    registry, sink = Registry(), EventSink(str(tmp_path / "events"))
    store = ExecutableStore(str(tmp_path / "store"), registry=registry, sink=sink)
    nvcc = FakeNvcc()
    lib, outcome = store.load_or_build("int8_head", nvcc, _load)
    assert (lib, outcome, nvcc.builds) == (b"library build 1", "miss", 1)
    header, path = _entry_files(store, "int8_head")
    assert header["sha256"] == aot._sha256(str(path)) and header["library"] == "int8_head"
    assert header["nvcc"] == TOOLKIT  # recorded at build time, not keyed on
    assert (path.with_suffix(".log")).read_text() == "ptxas info: build 1"
    lib, outcome = store.load_or_build("int8_head", nvcc, _load)
    assert (lib, outcome, nvcc.builds) == (b"library build 1", "hit", 1)
    sink.close()
    assert registry.counter("aot_executables_total", outcome="miss").value == 1
    assert registry.counter("aot_executables_total", outcome="hit").value == 1
    events = [(e["fn"], e["outcome"]) for e in read_events(sink.path)
              if e["event"] == "aot_executable"]
    assert events == [("int8_head", "miss"), ("int8_head", "hit")]


def _tamper(store, name, how):
    header, path = _entry_files(store, name)
    hpath = pathlib.Path(store.header_path(name))
    if how == "header_not_json":
        hpath.write_text("{not json")
    elif how == "header_environment":
        hpath.write_text(json.dumps({**header, "torch_version": "0.0.0"}))
    elif how == "header_library":
        hpath.write_text(json.dumps({**header, "library": "int8_head"}))
    elif how == "library_bytes":
        path.write_bytes(b"someone else's library")
    elif how == "library_missing":
        path.unlink()
    elif how == "header_sha256":
        hpath.write_text(json.dumps({**header, "sha256": "0" * 64}))


FALLBACKS = ["header_not_json", "header_environment", "header_library", "library_bytes",
             "library_missing", "header_sha256", "aot_load_fault"]


@pytest.mark.parametrize("how", FALLBACKS)
def test_a_failed_gate_falls_back_and_rewrites_the_entry(env, tmp_path, how):
    """miss, hit, then fallback: a fresh build under a new file name whose
    header replaces the entry, so the next load is a hit again.  The
    loader never sees a library that failed the gate."""
    registry = Registry()
    store = ExecutableStore(str(tmp_path), registry=registry)
    nvcc = FakeNvcc()
    loaded = []

    def load(path):
        loaded.append(pathlib.Path(path).name)
        return _load(path)

    assert store.load_or_build("adadelta", nvcc, load)[1] == "miss"
    assert store.load_or_build("adadelta", nvcc, load)[1] == "hit"
    cold = store.entry("adadelta")["file"]
    if how == "aot_load_fault":
        with faults.injected("fail:aot_load:count=1"):
            lib, outcome = store.load_or_build("adadelta", nvcc, load)
    else:
        _tamper(store, "adadelta", how)
        lib, outcome = store.load_or_build("adadelta", nvcc, load)
    assert (lib, outcome, nvcc.builds) == (b"library build 2", "fallback", 2)
    header, path = _entry_files(store, "adadelta")
    assert header["file"] != cold and header["sha256"] == aot._sha256(str(path))
    assert loaded == [cold, cold, header["file"]]
    assert store.load_or_build("adadelta", nvcc, load) == (b"library build 2", "hit")
    assert registry.counter("aot_executables_total", outcome="fallback").value == 1


def test_a_changed_environment_is_a_miss_never_a_false_hit(env, tmp_path):
    store = ExecutableStore(str(tmp_path))
    nvcc = FakeNvcc()
    store.load_or_build("int8_head", nvcc, _load)
    env["device_kind"] = "NVIDIA H200"
    assert store.load_or_build("int8_head", nvcc, _load) == (b"library build 2", "miss")
    env["device_kind"] = ENV["device_kind"]
    assert store.load_or_build("int8_head", nvcc, _load) == (b"library build 1", "hit")


@pytest.mark.parametrize("field", sorted(ENV) + ["source_digest", "nvcc_flags", "library"])
def test_the_key_changes_with_each_field(env, tmp_path, monkeypatch, field):
    store = ExecutableStore(str(tmp_path))
    before = store.key_for("int8_head")
    assert before == store.key_for("int8_head") and len(before) == 64
    if field == "source_digest":
        monkeypatch.setattr(aot, "source_digest", lambda: "0" * 64)
    elif field == "nvcc_flags":
        monkeypatch.setattr(_build, "NVCC_FLAGS", (*_build.NVCC_FLAGS, "-lineinfo"))
    elif field == "library":
        assert store.key_for("adadelta") != before
        return
    else:
        env[field] = "other"
    assert store.key_for("int8_head") != before


def test_the_source_digest_covers_python_and_kernel_sources(monkeypatch, tmp_path):
    digest = source_digest()
    assert digest == source_digest() and len(digest) == 64
    (tmp_path / "csrc").mkdir()
    (tmp_path / "m.py").write_text("x = 1\n")
    (tmp_path / "csrc" / "k.cu").write_text("__global__ void k() {}\n")
    (tmp_path / "notes.txt").write_text("not a source")
    monkeypatch.setattr(aot, "_PKG_ROOT", tmp_path)
    fresh = aot.source_digest.__wrapped__
    before = fresh()
    (tmp_path / "notes.txt").write_text("still not a source")
    assert fresh() == before
    (tmp_path / "csrc" / "k.cu").write_text("__global__ void k() { return; }\n")
    after_kernel = fresh()
    (tmp_path / "m.py").write_text("x = 2\n")
    assert len({before, after_kernel, fresh()}) == 3


def test_prune_keeps_the_newest_entries_and_reaps_stale_files(env, tmp_path):
    store = ExecutableStore(str(tmp_path))
    for i in range(store.MAX_ENTRIES + 3):
        old = tmp_path / f"old{i}.json"
        old.write_text(json.dumps({"file": f"old{i}.so", "log": f"old{i}.log"}))
        (tmp_path / f"old{i}.so").write_bytes(b"x")
        for p in (old, tmp_path / f"old{i}.so"):
            os.utime(p, (i, i))  # older than the real entry, past the grace
    crashed = tmp_path / "int8_head.abc.so.tmp"
    crashed.write_bytes(b"torn")
    os.utime(crashed, (1, 1))
    live = tmp_path / "adadelta.def.so.tmp"
    live.write_bytes(b"a writer still at work")
    assert store.load_or_build("int8_head", FakeNvcc(), _load)[1] == "miss"
    headers = sorted(f for f in os.listdir(tmp_path) if f.endswith(".json"))
    assert len(headers) == store.MAX_ENTRIES
    assert store.header_path("int8_head").endswith(tuple(headers))
    # the libraries the kept old headers name stay, the others go
    libs = {f for f in os.listdir(tmp_path) if f.endswith(".so")}
    kept_old = {json.loads((tmp_path / h).read_text())["file"] for h in headers}
    assert libs == kept_old | {store.entry("int8_head")["file"]}
    assert not crashed.exists() and live.exists()
    assert store.load_or_build("int8_head", FakeNvcc(), _load)[1] == "hit"


def test_modes_are_0700_for_a_new_directory_and_the_umask_for_entries(env, tmp_path):
    old = os.umask(0o022)
    try:
        store = ExecutableStore(str(tmp_path / "new" / "store"))
        store.load_or_build("int8_head", FakeNvcc(), _load)
    finally:
        os.umask(old)
    assert (tmp_path / "new" / "store").stat().st_mode & 0o777 == 0o700
    for f in (tmp_path / "new" / "store").iterdir():
        assert f.stat().st_mode & 0o777 == 0o644, f.name
    existing = tmp_path / "mine"
    existing.mkdir(mode=0o755)
    os.chmod(existing, 0o755)
    ExecutableStore(str(existing))
    assert existing.stat().st_mode & 0o777 == 0o755  # the operator's decision stands


WRITER = """
import json, pathlib, sys, time
from pytorch_mnist_ddp_tpu_torch.compile import aot
aot._environment = lambda: {"env": "fixed"}
aot._nvcc_version = lambda: "fixed"
store = aot.ExecutableStore(sys.argv[1])
tag = sys.argv[2].encode()
pathlib.Path(sys.argv[3]).touch()
while not pathlib.Path(sys.argv[4]).exists():  # both writers start together
    time.sleep(0.001)

def build(path):
    with open(path, "wb") as f:
        for _ in range(40):
            f.write(tag * 4096)
            f.flush()
            time.sleep(0.004)
    return "report " + sys.argv[2]

lib, outcome = store.load_or_build("int8_head", build, lambda p: pathlib.Path(p).read_bytes())
print(json.dumps({"outcome": outcome, "bytes": len(lib), "tags": sorted(set(lib))}))
"""


def test_two_processes_writing_one_directory_leave_complete_entries(tmp_path):
    """Two processes miss together: both build (the per-source locks are a
    process's own), each loads the whole library it built, and the entry
    left behind is one of them, complete and matching its header."""
    store_dir, go = tmp_path / "store", tmp_path / "go"
    procs = [subprocess.Popen([sys.executable, "-c", WRITER, str(store_dir), tag,
                               str(tmp_path / f"ready-{tag}"), str(go)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env={**os.environ, "PYTHONPATH": str(ROOT)})
             for tag in ("a", "b")]
    deadline = time.time() + 60
    while not all((tmp_path / f"ready-{t}").exists() for t in "ab") and time.time() < deadline:
        time.sleep(0.01)
    go.touch()
    outs = [p.communicate(timeout=60) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err for _, err in outs]
    results = [json.loads(out) for out, _ in outs]
    for r, tag in zip(results, "ab"):
        assert r["outcome"] == "miss"
        assert (r["bytes"], r["tags"]) == (40 * 4096, [ord(tag)])
    [header_name] = [f for f in os.listdir(store_dir) if f.endswith(".json")]
    header = json.loads((store_dir / header_name).read_text())
    lib = (store_dir / header["file"]).read_bytes()
    assert aot._sha256(str(store_dir / header["file"])) == header["sha256"]
    assert len(lib) == 40 * 4096 and len(set(lib)) == 1
    assert not [f for f in os.listdir(store_dir) if f.endswith(".tmp")]


@pytest.fixture
def fake_nvcc(monkeypatch):
    """``nvcc`` replaced by a writer of its -o file; ctypes by a reader."""
    calls = []

    def run(cmd, **kwargs):
        calls.append(cmd)
        out = cmd[cmd.index("-o") + 1]
        pathlib.Path(out).write_bytes(b"built %d" % len(calls))
        return subprocess.CompletedProcess(cmd, 0, stdout="ptxas info", stderr=None)

    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", run)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", _load(path)))
    return calls


def test_builds_count_only_real_nvcc_runs(env, fake_nvcc, tmp_path, monkeypatch):
    """A miss runs nvcc once; a later process (its library table empty)
    hits and runs none; within one process a second store or directory
    loads no second copy."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build_dir")
    store = ExecutableStore(str(tmp_path / "store"))
    builds, loads = _build.BUILDS, _build.LOADS
    lib = _build.library("int8_head", store=store)
    assert (_build.BUILDS - builds, _build.LOADS - loads, _build.origin("int8_head")) == (
        1, 1, "miss")
    assert _build.library("int8_head") is lib  # no second copy, no outcome
    assert _build.library("int8_head", store=ExecutableStore(str(tmp_path / "other"))) is lib
    assert (_build.BUILDS - builds, _build.LOADS - loads) == (1, 1)
    monkeypatch.setattr(_build, "_loaded", {})  # the next process
    monkeypatch.setattr(_build, "_origins", {})
    assert _build.library("int8_head", store=store) == lib
    assert (_build.BUILDS - builds, _build.LOADS - loads, _build.origin("int8_head")) == (
        1, 2, "hit")
    # without a store, the build directory's: built once, then a hit
    _build.library("adadelta")
    monkeypatch.setattr(_build, "_loaded", {})
    _build.library("adadelta")
    assert (_build.BUILDS - builds, _build.origin("adadelta")) == (2, "hit")
    assert _build.build_store().directory == str(tmp_path / "build_dir")
    assert _build.build_store().entry("adadelta")["library"] == "adadelta"
    assert len(fake_nvcc) == 2 and all(c[0] == "nvcc" for c in fake_nvcc)


def test_a_hit_needs_no_nvcc(env, fake_nvcc, tmp_path, monkeypatch):
    """A host with no compiler loads what another built (the trainer to
    server handoff); there a miss raises, and nothing falls back."""
    store = ExecutableStore(str(tmp_path))
    lib = _build.library("int8_head", store=store)
    monkeypatch.setattr(_build, "_loaded", {})  # the serving host's process
    monkeypatch.setattr(_build, "_origins", {})

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc_path", no_nvcc)
    monkeypatch.setattr(aot, "_nvcc_version", ASK_NVCC)  # asks nvcc_path
    builds = _build.BUILDS
    assert _build.library("int8_head", store=store) == lib
    assert (_build.origin("int8_head"), _build.BUILDS - builds) == ("hit", 0)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library("adadelta", store=store)
    assert _build.origin("adadelta") is None and store.entry("adadelta") is None


def test_a_failed_build_raises_and_keeps_nothing(env, monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", lambda cmd, **kw: subprocess.CompletedProcess(
        cmd, 1, stdout="error: identifier undefined", stderr=None))
    store = ExecutableStore(str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc failed for csrc/int8_head.cu"):
        _build.library("int8_head", store=store)
    assert os.listdir(tmp_path) == [] and _build.origin("int8_head") is None


def test_programs_load_their_libraries_through_the_store_once(env, fake_nvcc, tmp_path):
    registry, store = Registry(), ExecutableStore(str(tmp_path))
    warmed = []
    programs = [Program("train_step", ("adadelta",), store=store),
                Program("eval_step", store=store),
                Program("predict_step[int8]", ("int8_head",), store=store,
                        warm=lambda *a: warmed.append(a), example_args=(1, 2))]
    build_programs(programs, registry=registry)
    assert (_build.origin("adadelta"), _build.origin("int8_head")) == ("miss", "miss")
    assert warmed == [(1, 2)] and all(p.built for p in programs)
    programs[2].build()  # idempotent
    assert warmed == [(1, 2)] and len(fake_nvcc) == 2
    labels = {lab["fn"] for lab, _ in dict(
        (n, c) for n, _, _, c in registry.collect())["compile_seconds_total"]}
    assert labels == {"train_step", "eval_step", "predict_step[int8]"}


def test_the_build_directory_is_set_by_name_and_off_on_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    target = tmp_path / "kernels"
    assert enable_persistent_cache(str(target), device="cpu") is None
    assert not target.exists()
    assert enable_persistent_cache(str(target), force=True, device="cpu") == str(target)
    assert target.is_dir() and _build.BUILD_DIR == target
    assert _build.build_store().directory == str(target)
    assert target.stat().st_mode & 0o777 == 0o700  # a store's new directory


# -- the engines and the CLIs ------------------------------------------------------

BUCKETS = (1, 2, 4)


def _answers(engine) -> dict:
    x = np.random.RandomState(7).rand(4, 28, 28, 1).astype(np.float32)
    return {(dt, b): engine.predict_logits(x[:b], dtype=dt)
            for dt in ("f32", "int8") for b in engine.buckets}


@pytest.fixture(scope="module")
def default_answers():
    engine = InferenceEngine.from_seed(12, device="cpu", buckets=BUCKETS, dtypes=("int8",))
    engine.warmup()
    engine.verify_parity()
    return _answers(engine)


@pytest.mark.parametrize("variant", ["aot_cache", "no_device_stage"])
def test_engine_variants_answer_as_the_default(default_answers, tmp_path, variant):
    kwargs = {"aot_cache": {"aot_cache": str(tmp_path / "aot")},
              "no_device_stage": {"device_stage": False}}[variant]
    engine = InferenceEngine.from_seed(12, device="cpu", buckets=BUCKETS, dtypes=("int8",),
                                       **kwargs)
    rungs = engine.warmup()
    assert rungs == [(dt, b) for dt in ("f32", "int8") for b in BUCKETS]
    assert engine.rungs_run == len(rungs) and engine.libraries == ()
    engine.verify_parity()
    got = _answers(engine)
    assert all(np.array_equal(got[k], default_answers[k]) for k in default_answers)
    if variant == "aot_cache":  # made, and empty: the CPU loads no library
        assert os.listdir(tmp_path / "aot") == []


@pytest.mark.parametrize("parallel", [True, False], ids=["concurrent", "serial_warmup"])
def test_a_pool_of_two_with_the_flags_answers_as_the_default(default_answers, tmp_path,
                                                             parallel):
    pool = EnginePool.from_seed(12, replicas=2, device="cpu", buckets=BUCKETS,
                                dtypes=("int8",), aot_cache=str(tmp_path / "aot"),
                                device_stage=False)
    assert pool.engines[0].store is pool.engines[1].store is pool.store
    pool.warmup(parallel=parallel)
    assert pool.rungs_run() == 2 * 2 * len(BUCKETS)
    pool.verify_parity(raise_on_failure=True)
    for engine in pool.engines:
        got = _answers(engine)
        assert all(np.array_equal(got[k], default_answers[k]) for k in default_answers)


def test_rung_spans_carry_the_jax_engines_labels(tmp_path):
    """The compile_seconds_total labels a warmup leaves are the JAX
    engine's (its parallel warmup's job names)."""
    labels = {}
    params = jax.device_get(init_params(jax.random.PRNGKey(0)))
    jax_engine = JaxEngine({"params": params}, mesh=make_mesh(1, devices=jax.devices()[:1]),
                           buckets=(1, 2), dtypes=("int8",), metrics=JaxServingMetrics())
    jax_engine.warmup()
    port = InferenceEngine(Net(torch.Generator().manual_seed(0)).state_dict(), device="cpu",
                           buckets=(1, 2), dtypes=("int8",), metrics=ServingMetrics())
    port.warmup()
    for name, engine in (("jax", jax_engine), ("port", port)):
        families = {n: c for n, _, _, c in engine.metrics.registry.collect()}
        labels[name] = {lab["fn"] for lab, _ in families["compile_seconds_total"]}
    assert labels["port"] == labels["jax"] == {
        "predict_step[1]", "predict_step[2]", "predict_step[int8][1]", "predict_step[int8][2]"}


@pytest.fixture(scope="module")
def idx_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("idx")
    for split, n in (("train", LIMIT), ("test", LIMIT)):
        images, labels = synthetic_mnist(split, n)
        (root / _FILES[(split, "images")]).write_bytes(
            struct.pack(">iiii", 2051, n, 28, 28) + images.tobytes())
        (root / _FILES[(split, "labels")]).write_bytes(
            struct.pack(">ii", 2049, n) + labels.tobytes())
    return root


def _cli_run(monkeypatch, capsys, workdir, idx_root, *flags) -> tuple[str, bytes]:
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)  # restored after the test
    workdir.mkdir()
    monkeypatch.chdir(workdir)
    monkeypatch.setenv("MNIST_DATA_DIR", str(idx_root))
    cli_main(["--no-cuda", "--epochs", "1", "--pallas-opt", "--save-model",
              "--log-interval", "1", *flags])
    return capsys.readouterr().out, (workdir / "mnist_cnn.pt").read_bytes()


@pytest.mark.parametrize("flags", [["--aot-cache", "{d}/aot", "--serve-prewarm",
                                    "--compile-cache-dir", "{d}/kernels"],
                                   ["--fused", "--aot-cache", "{d}/aot"]],
                         ids=["per_batch", "fused"])
def test_the_flags_change_no_printed_line_and_no_saved_byte(monkeypatch, capsys, tmp_path,
                                                            idx_root, flags):
    fused = ["--fused"] if "--fused" in flags else []
    plain = _cli_run(monkeypatch, capsys, tmp_path / "plain", idx_root, *fused)
    flagged = _cli_run(monkeypatch, capsys, tmp_path / "flagged", idx_root,
                       *[f.format(d=tmp_path) for f in flags])
    assert plain == flagged and "Test set: Average loss" in plain[0]
    assert (tmp_path / "aot").is_dir() and os.listdir(tmp_path / "aot") == []
    assert (tmp_path / "kernels").is_dir() == ("--compile-cache-dir" in flags)


def test_telemetry_records_startup_and_compile_spans(tmp_path, idx_root, monkeypatch):
    monkeypatch.setenv("MNIST_DATA_DIR", str(idx_root))
    for fused in ([], ["--fused"]):
        tel = tmp_path / f"tel{len(fused)}"
        args = build_parser().parse_args(["--epochs", "1", "--pallas-opt", "--aot-cache",
                                          str(tmp_path / "aot"), "--telemetry-dir", str(tel),
                                          *fused])
        timings: dict = {}
        fit(args, "cpu", timings=timings)
        events = read_events(str(tel / "events-rank0.jsonl"))
        spans = {(e["span"], e.get("fn")) for e in events if e["event"] == "span_end"}
        prom = (tel / "metrics.prom").read_text()
        assert ("startup", None) in spans
        compiled = {fn for span_name, fn in spans if span_name == "compile"}
        if fused:
            assert ("compile", "fused_run") in spans and ("startup_task", "data") in spans
            [overlap] = [e for e in events if e["event"] == "startup_overlap"]
            assert set(overlap["tasks"]) == {"restore", "fused_run", "data"}
            assert "startup_overlap_ratio " in prom
            assert timings["startup_overlap_ratio"] == overlap["overlap_ratio"]
            assert compiled == {"fused_run"} and 'compile_seconds_total{fn="' in prom
        else:
            # no step launches a kernel library on the CPU: nothing to build
            assert compiled == set() and "compile_seconds_total" not in prom


TWO_RANKS = DistState(distributed=True, rank=0, world_size=2)


@pytest.mark.parametrize("flags,parser,world,fragment", [
    (["--serve-prewarm"], build_parser, None, "add --aot-cache DIR"),
    (["--serve-prewarm", "--aot-cache", "x", "--fused"], build_parser, None, "drop --fused"),
    (["--serve-prewarm", "--aot-cache", "x", "--tp", "2"], ddp_parser, TWO_RANKS,
     "rides the DP paths; drop --tp/--pp"),
    (["--serve-prewarm", "--aot-cache", "x", "--pp"], ddp_parser, TWO_RANKS,
     "rides the DP paths; drop --tp/--pp"),
], ids=["no_store", "fused", "tp", "pp"])
def test_serve_prewarm_refusals_are_the_jax_trainers(flags, parser, world, fragment,
                                                     monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    args = parser().parse_args(flags)
    with pytest.raises(ValueError, match=fragment) as err:
        fit(args, "cpu", dist=world)
    assert_jax_text(str(err.value))
    assert not (tmp_path / "x").exists()  # refused before the store is made
