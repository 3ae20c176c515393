"""The port's SLO gate (``pytorch_mnist_ddp_tpu_torch/tools/slo_gate.py``)
against the JAX package's ``tools/slo_gate.py``.

- ``_read_prom``/``_prom_sum`` on the JAX gate's own fixture (both gates
  read it alike) and on the port server's ``/metrics?format=prom``.
- The compile budget's arithmetic, packed and bucketed: what the gate
  expects is what a pool of the protocol's shape builds.
- The port's ``slo_budgets.json`` is the JAX file key for key, except
  ``replica_shapes`` (``dp,dp``: no sharded replica yet) and
  ``virtual_devices`` (no counterpart: the gate serves on ``--device``);
  its chaos clauses parse in the port's fault grammar.
- A small protocol (the committed one at 64 requests, 80 requests/s and a
  swap at 0.5 s) run green and, at the same time, under ``--inject p99``,
  which must exit 1 on a p99 breach.
"""

from __future__ import annotations

import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import threading
import urllib.request

import pytest
import torch

from pytorch_mnist_ddp_tpu.serving.buckets import packed_capacities as jax_capacities
from pytorch_mnist_ddp_tpu_torch.serving.engine import InferenceEngine
from pytorch_mnist_ddp_tpu_torch.serving.faults import FaultInjector
from pytorch_mnist_ddp_tpu_torch.serving.metrics import ServingMetrics
from pytorch_mnist_ddp_tpu_torch.serving.pool import EnginePool
from pytorch_mnist_ddp_tpu_torch.serving.server import make_server
from pytorch_mnist_ddp_tpu_torch.tools import slo_gate as port

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_BUDGETS = ROOT / "pytorch_mnist_ddp_tpu_torch" / "tools" / "slo_budgets.json"
JAX_BUDGETS = ROOT / "tools" / "slo_budgets.json"


def _load_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_gate = _load_tool("slo_gate")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spec(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


# tests/test_program.py's fixture
PROM = (
    "# HELP serving_batch_fill_ratio x\n"
    "# TYPE serving_batch_fill_ratio summary\n"
    'serving_batch_fill_ratio{quantile="0.5"} 0.75\n'
    "serving_batch_fill_ratio_sum 12.5\n"
    "serving_batch_fill_ratio_count 20\n"
    'jax_compiles_total{fn="predict_step"} 4\n'
    'jax_compiles_total{fn="predict_step_bf16"} 2\n'
)


def test_prom_parsing_equals_the_jax_gates(tmp_path):
    path = tmp_path / "m.prom"
    path.write_text(PROM)
    parsed = port._read_prom(str(path))
    assert parsed == jax_gate._read_prom(str(path))
    assert parsed["serving_batch_fill_ratio_sum"] == 12.5
    for family, want in (("jax_compiles_total", 6.0), ("serving_batch_fill_ratio_count", 20.0),
                         ("serving_batch_fill_ratio", 0.75)):
        assert port._prom_sum(parsed, family) == jax_gate._prom_sum(parsed, family) == want
    assert port._read_prom(str(tmp_path / "missing.prom")) == {}


def test_prom_parsing_of_the_port_servers_exposition(tmp_path):
    metrics = ServingMetrics()
    engine = InferenceEngine.from_seed(1, device="cpu", buckets=(4, 8), metrics=metrics)
    engine.warmup()
    server = make_server(engine, metrics, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        body = json.dumps({"instances": [[0] * 784] * 3}).encode()
        for _ in range(5):
            req = urllib.request.Request(url + "/predict", data=body,
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=30) as r:
                assert r.status == 200
        with urllib.request.urlopen(url + "/metrics?format=prom", timeout=30) as r:
            (tmp_path / "s.prom").write_bytes(r.read())
    finally:
        server.shutdown()
        server.batcher.stop(drain=True)
        server.server_close()
    prom = port._read_prom(str(tmp_path / "s.prom"))
    assert port._prom_sum(prom, "compile_programs_total") == 2.0  # the two rungs
    assert set(k for k in prom if k.startswith("compile_programs_total")) == {
        'compile_programs_total{fn="predict_step[4]"}',
        'compile_programs_total{fn="predict_step[8]"}'}
    assert port._prom_sum(prom, "serving_batch_fill_ratio_count") == 5.0
    fill = port._prom_sum(prom, "serving_batch_fill_ratio_sum") / 5.0
    assert fill == pytest.approx(3 / 4)  # three rows in the 4-row bucket
    assert port._prom_sum(prom, "serving_pipeline_stall_seconds_sum") >= 0.0


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "bucketed"])
@pytest.mark.parametrize("buckets", ["4,8", "1,2,4,8,16"])
def test_the_compile_budget_is_what_the_pool_builds(packed, buckets):
    protocol = {**_spec(PORT_BUDGETS)["protocol"], "packed": packed, "buckets": buckets}
    ladder = [int(b) for b in buckets.split(",")]
    jax_rungs = list(jax_capacities(max(ladder), 1)) if packed else ladder  # the JAX gate's
    want = protocol["replicas"] * len(jax_rungs)
    assert port.expected_warmup_compiles(protocol) == want
    metrics = ServingMetrics()
    pool = EnginePool.from_seed(1, replicas=protocol["replicas"], device="cpu",
                                buckets=ladder, packed=packed, metrics=metrics,
                                replica_shapes=protocol["replica_shapes"])
    pool.warmup()
    assert metrics.programs_built() == want


def test_the_budget_file_is_the_jax_files_but_the_shapes():
    port_spec, jax_spec = _spec(PORT_BUDGETS), _spec(JAX_BUDGETS)
    assert set(port_spec) == set(jax_spec) == {"_doc", "protocol", "budgets"}
    assert port_spec["budgets"] == jax_spec["budgets"]
    jax_protocol = dict(jax_spec["protocol"])
    del jax_protocol["virtual_devices"]
    jax_protocol["replica_shapes"] = "dp,dp"
    assert port_spec["protocol"] == jax_protocol
    for clause in ("recovery_chaos", "inject_p99_chaos"):
        assert FaultInjector(port_spec["protocol"][clause]).specs, clause


def _gate(tmp_path, name: str, *flags: str) -> subprocess.Popen:
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    return subprocess.Popen(
        [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.tools.slo_gate", "--device", "cpu",
         "--budgets", str(tmp_path / "budgets.json"), "--no-append",
         "--workdir", str(tmp_path / name), *flags],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_a_small_protocol_passes_and_an_injected_p99_fails(tmp_path):
    spec = _spec(PORT_BUDGETS)
    spec["protocol"].update(requests=64, rate_rps=80, swap_at_s=0.5)
    (tmp_path / "budgets.json").write_text(json.dumps(spec))
    green, injected = _gate(tmp_path, "green"), _gate(tmp_path, "injected", "--inject", "p99")
    out_green, _ = green.communicate(timeout=240)
    out_injected, _ = injected.communicate(timeout=240)
    assert green.returncode == 0, out_green
    assert "SLO GATE: PASS" in out_green
    for name in ("post_warmup_compiles", "recovery_restarts", "swap_torn_responses",
                 "canary_exact_split"):
        assert any(line.startswith(f"slo_gate: {name}") and line.endswith("[ok]")
                   for line in out_green.splitlines()), name
    assert injected.returncode == 1, out_injected
    assert "SLO GATE: FAIL (breached: client_p99_ms" in out_injected
    assert "[injected=p99]" in out_injected
    # --no-append: no trajectory written; the artifacts stay in --workdir
    assert not (tmp_path / "build").exists()
    assert (tmp_path / "green" / "registry_report.json").exists()
