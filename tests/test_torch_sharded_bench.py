"""The port's ``tools/sharded_bench.py`` (the JAX package's tool of the
same name) on the CPU.

- The structural pin: fake engines, read back where the port's completion
  worker reads a batch, through the port's batcher, replicas and router;
  tp4 beats dp1 by more than 25% of the wall time.
- Two of the real plans (``tp4``, ``ep2,ep2``) as live pools over
  ``[cpu] * 8``: every sharded replica's parity gate passes and the drive
  adds no compile.
- ``main``: the report's keys are the ones the JAX tool writes (its
  committed ``BENCH_sharded.json``), under ``build/sharded/`` by default,
  and ``--device cuda`` without a card raises.

One intra-op thread; a few requests a rung.
"""

from __future__ import annotations

import json
import os
import pathlib
import time

import pytest
import torch

from pytorch_mnist_ddp_tpu_torch.tools import sharded_bench

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _args(*argv):
    return sharded_bench.build_parser().parse_args(
        ["--device", "cpu", "--requests", "4", "--service-ms", "20", *argv])


def test_the_fake_result_blocks_where_the_port_reads():
    from pytorch_mnist_ddp_tpu_torch.serving.batcher import _read_back

    engine = sharded_bench.FakeShardedEngine(devices=4, service_s=0.08)
    t0 = time.perf_counter()
    result = engine.launch(torch.zeros(8, 28, 28, 1).numpy(), 8)
    assert time.perf_counter() - t0 < 0.02  # the launch returns at once
    out = _read_back(result)
    assert time.perf_counter() - t0 >= 0.02 - 1e-3  # 80 ms over 4 devices
    assert out.shape == (8, sharded_bench.NUM_CLASSES) and engine.dispatches == [8]


def test_structural_pin_passes_its_margin():
    pin = sharded_bench.run_structural_pin(_args())
    assert pin["passed"] and pin["tp4_win_vs_dp1"] > pin["min_win"] == 0.25
    rungs = pin["rungs"]
    assert [r["fake_devices"] for r in rungs.values()] == [1, 4, 4, 8]
    assert rungs["dp1"]["batches_dispatched"] == rungs["tp4"]["batches_dispatched"] == 12


def test_two_real_plans_pass_their_gates_with_no_added_compile():
    plans = [p for p in sharded_bench.REAL_PLANS if p[0] in ("tp4", "ep2,ep2")]
    rows = sharded_bench.run_real_sweep(_args(), plans=plans)
    assert [r["replica_shapes"] for r in rows] == ["tp4", "ep2,ep2"]
    assert [r["devices"] for r in rows] == [4, 4]
    for row in rows:
        assert row["passed"] and row["additional_compiles"] == 0
        assert row["parity"] and all(p["passed"] for p in row["parity"].values())


def _keys(doc, prefix=""):
    out = set()
    if isinstance(doc, dict):
        for key, value in doc.items():
            out.add(f"{prefix}/{key}")
            if key != "parity":  # keyed by the shard kinds a plan holds
                out |= _keys(value, f"{prefix}/{key}")
    elif isinstance(doc, list) and doc:
        out |= _keys(doc[0], f"{prefix}[]")
    return out


def test_main_writes_the_jax_tool_s_report(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(sharded_bench, "REAL_PLANS", [("tp4", 1)])
    report = tmp_path / "r.json"
    assert sharded_bench.main(["--device", "cpu", "--requests", "4", "--service-ms", "20",
                               "--report", str(report)]) == 0
    out = capsys.readouterr().out
    assert "SHARDED BENCH: PASS" in out and f"wrote {report}" in out
    ours = json.loads(report.read_text())
    jax_written = json.loads((ROOT / "BENCH_sharded.json").read_text())
    assert _keys(ours) == _keys(jax_written)
    assert ours["mode"] == "sharded-sweep" and "cpu" in ours["host_bound_caveat"]
    assert sharded_bench.build_parser().parse_args([]).report == os.path.join(
        "build", "sharded", "BENCH_sharded.json")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device; the no-card contract is moot")
    with pytest.raises(RuntimeError, match="CUDA"):
        sharded_bench.run_real_sweep(
            sharded_bench.build_parser().parse_args(["--requests", "1"]), plans=[("tp4", 1)])
