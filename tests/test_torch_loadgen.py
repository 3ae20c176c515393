"""The port's load generator (``pytorch_mnist_ddp_tpu_torch/tools/
serve_loadgen.py``) against the JAX package's ``tools/serve_loadgen.py``.

- Parity on the same seed and flags: ``build_plan``'s sizes, payload
  catalog, repeat flags, QoS labels and pre-encoded bodies (JSON and the
  binary wire), the open loop's arrival schedule (both tools' loops under
  one virtual clock), and ``summarize``'s report on the same raw timings.
- End to end on the CPU (``--device cpu``): closed and open loop,
  bucketed and packed, f32 and ``--dtype int8``: every request answered
  once, the compile firewall held; an unwarmed ladder trips it.
- Small rounds of ``--chaos``, ``--ab-tail``, ``--hostpath-ab``,
  ``--devicepath-ab``, ``--replicas-sweep``, the registry rounds and
  ``--fleet-sweep --fleet-fake`` meet their verdicts.
- Refusals: each of the JAX parser's conflicts, exited as the JAX tool
  exits; a sharded ``--replica-shapes`` plan needing more devices than
  the CPU's one (the JAX planner's error).
- ``JAXLINT_LOCKWATCH=1``: the JAX tool's gate after the run (the acyclic
  line, ``rc or 3`` on a cycle).

One intra-op thread; buckets of at most 8 rows, a few dozen requests a
round.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu_torch.serving.engine import InferenceEngine
from pytorch_mnist_ddp_tpu_torch.serving.metrics import ServingMetrics
from pytorch_mnist_ddp_tpu_torch.serving.server import make_server
from pytorch_mnist_ddp_tpu_torch.tools import serve_loadgen as port

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


def _load_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_tool = _load_tool("serve_loadgen")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _plan_args(**over) -> argparse.Namespace:
    base = dict(requests=32, seed=3, max_request=6, dtype="f32", qos_mix=None,
                wire="json", repeat_dist=None)
    base.update(over)
    return argparse.Namespace(**base)


PLANS = {
    "json": {},
    "binary": {"wire": "binary"},
    "qos_mix": {"qos_mix": "interactive=0.8,batch=0.2"},
    "zipf_binary": {"repeat_dist": "zipf:1.1:8", "wire": "binary"},
    "int8_qos_binary": {"dtype": "int8", "qos_mix": "interactive=0.5,batch=0.5",
                        "wire": "binary"},
    "log_probs_zipf": {"json_log_probs": True, "repeat_dist": "zipf:2"},
}


@pytest.mark.parametrize("send_qos", [True, False], ids=["qos_sent", "labels_only"])
@pytest.mark.parametrize("case", sorted(PLANS))
def test_build_plan_equals_the_jax_tools(case, send_qos):
    args = _plan_args(**PLANS[case])
    want = jax_tool.build_plan(args, send_qos=send_qos)
    got = port.build_plan(args, send_qos=send_qos)
    assert got.keys() == want.keys()
    for key in ("sizes", "payload_ids", "repeat_flags", "qos_labels", "distinct", "wire",
                "repeat_dist", "headers"):
        assert got[key] == want[key], key
    assert got["bodies"] == want["bodies"]  # byte for byte, JSON and binary
    # a repeated (payload, class) is one bytes object: what makes it a cache hit
    sent = got["qos_labels"] if send_qos else [None] * args.requests
    first = {}
    for key, body in zip(zip(got["payload_ids"], sent), got["bodies"]):
        assert first.setdefault(key, body) is body


class _VirtualClock:
    """``time`` for an open loop: ``sleep`` advances a virtual clock and
    records where it landed, so a loop's firing schedule is read exactly."""

    def __init__(self):
        self.now = 0.0
        self.fired: list[float] = []
        self._lock = threading.Lock()

    def perf_counter(self) -> float:
        with self._lock:
            return self.now

    def sleep(self, delay: float) -> None:
        with self._lock:
            self.now += delay
            self.fired.append(self.now)


@pytest.mark.parametrize("rate", [37.5, 400.0])
def test_open_loop_arrivals_equal_the_jax_tools(monkeypatch, rate):
    args = _plan_args(qos_mix="interactive=0.8,batch=0.2")
    schedules, raws = {}, {}
    for name, tool in (("jax", jax_tool), ("port", port)):
        clock = _VirtualClock()
        monkeypatch.setattr(tool, "time", clock)
        monkeypatch.setattr(tool, "fetch_raw", lambda *a, **k: (200, b""))
        monkeypatch.setattr(tool, "_decode_reply", lambda *a: None)
        raws[name] = tool.run_open_loop("http://x", tool.build_plan(args), rate=rate,
                                        seed=args.seed, timeout_s=1.0, max_workers=4)
        schedules[name] = clock.fired
    assert len(schedules["port"]) == args.requests
    assert schedules["port"] == schedules["jax"]
    for key in ("offered_rate_rps", "achieved_arrival_rate_rps", "mode", "sizes"):
        assert raws["port"][key] == raws["jax"][key], key
    assert [r[2] for r in raws["port"]["results"]] == [r[2] for r in raws["jax"]["results"]]


def _snapshot(completed: int, compiles: int) -> dict:
    return {
        "requests": {"completed": completed}, "compiles": compiles,
        "dtypes": {"f32": {"requests": completed}}, "qos": {"batch": {"shed": 1}},
        "hedges": {"won": 2, "lost": 1}, "replicas": {"r0": {"state": "active"}},
        "batch_occupancy_pct": 71.5, "padding_waste_pct": 28.5, "queue_depth": 3,
        "pipeline": {"fill_ratio_mean": 0.8}, "cache": {"hit": 4, "miss": 9},
    }


@pytest.mark.parametrize("case", ["qos_mix", "zipf_binary", "json"])
def test_summarize_equals_the_jax_tools(case):
    args = _plan_args(**PLANS[case])
    plan = port.build_plan(args)
    rs = np.random.RandomState(11)
    statuses = rs.choice([200, 200, 200, 503, 504], size=args.requests)
    raw = {"results": [(int(s), float(lat), q) for s, lat, q in zip(
               statuses, rs.uniform(0.001, 0.2, args.requests), plan["qos_labels"])],
           "wall_s": 1.25, "sizes": plan["sizes"], "plan": plan, "mode": "open-loop",
           "dtype": "f32", "offered_rate_rps": 40.0, "achieved_arrival_rate_rps": 39.5}
    before, after = _snapshot(10, 4), _snapshot(10 + args.requests, 5)
    want = jax_tool.summarize(raw, before, after)
    assert port.summarize(raw, before, after) == want
    assert want["additional_compiles"] == 1


def test_the_firewall_counts_programs_and_libraries():
    snap = {"compiles": 0, "programs": {"rungs": 6, "library_builds": 1, "library_loads": 2}}
    assert port._compile_count(snap) == 9
    assert port._compile_count({"compiles": 3}) == 3
    assert port._compile_count({}) is None


def _report(tmp_path, name: str) -> dict:
    with open(tmp_path / name) as f:
        return json.load(f)


E2E = {
    "closed_bucketed_f32": ["--concurrency", "4"],
    "closed_packed_int8": ["--concurrency", "4", "--packed", "--dtype", "int8",
                           "--int8-impl", "pallas"],
    "open_bucketed_int8": ["--open-loop", "--rate", "300", "--dtype", "int8"],
    "open_packed_f32": ["--open-loop", "--rate", "300", "--packed", "--fill-wait-ms", "5",
                        "--wire", "binary"],
}


@pytest.mark.parametrize("case", sorted(E2E))
def test_every_request_answered_once_and_the_firewall_holds(tmp_path, capsys, case):
    rc = port.main([*CPU, "--requests", "24", "--max-request", "8", "--buckets", "1,2,4,8",
                    "--report", str(tmp_path / "r.json"), *E2E[case]])
    out = capsys.readouterr().out
    assert rc == 0, out
    report = _report(tmp_path, "r.json")
    assert report["status_counts"] == {"200": 24}
    before, after = report["server_metrics_before"], report["server_metrics_after"]
    assert after["requests"]["completed"] - before["requests"]["completed"] == 24
    assert report["additional_compiles"] == 0
    assert "zero additional compiles (bucket firewall held)" in out
    rungs = 1 if "--packed" in E2E[case] else 4
    dtypes = 2 if "int8" in E2E[case] else 1
    assert before["programs"]["rungs"] == rungs * dtypes  # the warmed grid
    assert after["programs"] == before["programs"]
    assert report["mode"] == ("open-loop" if "--open-loop" in E2E[case] else "closed-loop")


@pytest.mark.parametrize("check", [True, False], ids=["checked", "no_check_compiles"])
def test_an_unwarmed_ladder_trips_the_firewall(tmp_path, capsys, monkeypatch, check):
    # Warmup builds no rung: every rung a request reaches builds on its
    # path, as the JAX engine traces an unwarmed bucket on first call.
    monkeypatch.setattr(InferenceEngine, "warmup", lambda self, on_rung=None, sink=None: [])
    rc = port.main([*CPU, "--requests", "24", "--max-request", "8", "--buckets", "1,2,4,8",
                    "--concurrency", "4", "--report", str(tmp_path / "r.json"),
                    *([] if check else ["--no-check-compiles"])])
    out = capsys.readouterr().out
    report = _report(tmp_path, "r.json")
    assert report["additional_compiles"] > 0
    assert report["server_metrics_after"]["programs"]["rungs"] == report["additional_compiles"]
    assert "RETRACE: " in out and "request shapes escaped the bucket policy" in out
    assert rc == (1 if check else 0)


ROUNDS = {
    "chaos": ["--open-loop", "--rate", "100", "--requests", "40", "--replicas", "2",
              "--chaos", "fail:launch:r1:count=3", "--chaos-stall-timeout", "2.0",
              "--report", "{d}/r.json"],
    "ab_tail": ["--ab-tail", "--open-loop", "--rate", "150", "--requests", "40",
                "--replicas", "2", "--qos-mix", "interactive=0.8,batch=0.2",
                "--hedge-delay-ms", "50", "--timeout-ms", "5000", "--tail-report", "{d}/r.json"],
    "hostpath_ab": ["--hostpath-ab", "--open-loop", "--rate", "150", "--requests", "40",
                    "--cache-rate", "100", "--buckets", "8", "--max-request", "8",
                    "--timeout-ms", "8000", "--concurrency", "16",
                    "--hostpath-report", "{d}/r.json"],
    "devicepath_ab": ["--devicepath-ab", "--open-loop", "--rate", "300", "--requests", "60",
                      "--replicas", "2", "--fill-wait-ms", "30", "--timeout-ms", "15000",
                      "--concurrency", "64",
                      "--devicepath-p99-slack", "2.0", "--hostpath-report", "{d}/r.json"],
    "replicas_sweep": ["--replicas-sweep", "1,2", "--requests", "16", "--concurrency", "4",
                       "--scaleout-report", "{d}/r.json"],
    "registry": ["--swap-at-s", "0.5", "--canary-sweep", "25,50", "--requests", "24",
                 "--registry-report", "{d}/r.json"],
    "fleet_fake": ["--fleet-sweep", "1,2", "--fleet-fake", "--open-loop", "--rate", "200",
                   "--requests", "60", "--concurrency", "32", "--timeout-ms", "8000",
                   "--fleet-service-ms", "5", "--fleet-report", "{d}/r.json"],
}


def _round_verdict(case: str, report: dict) -> None:
    if case == "chaos":
        chaos = report["chaos"]
        assert chaos["lost"] == chaos["transport_errors"] == 0
        assert chaos["recovered"] and not chaos["unfired"]
        assert chaos["fired"] and chaos["restarts"]["r1"] >= 1
        assert report["additional_compiles"] == 0
    elif case == "ab_tail":
        assert [r["label"] for r in report["rungs"]] == ["baseline", "tail"]
        for r in report["rungs"]:
            assert r["lost"] == r["transport_errors"] == r["duplicates"] == 0
            assert r["additional_compiles"] == 0
        assert set(report["deltas"]) == {"interactive", "batch"}
    elif case == "hostpath_ab":
        for r in [*report["wire_ab"]["rungs"].values(), report["cache_round"]]:
            assert r["lost"] == r["duplicates"] == r["additional_compiles"] == 0
        assert report["cache_round"]["server_cache"]["hit"] > 0
    elif case == "devicepath_ab":
        ab = report["device_ab"]
        assert ab["passed"]
        assert ab["warmup_executables_packed"] < ab["warmup_executables_bucketed"]
        assert ab["fill_ratio_mean_packed"] > ab["fill_ratio_mean_bucketed"]
    elif case == "replicas_sweep":
        assert [r["replicas"] for r in report["sweep"]] == [1, 2]
        assert all(r["additional_compiles"] == 0 for r in report["sweep"])
        assert report["sweep"][0]["scaling_efficiency"] == pytest.approx(1.0)
    elif case == "registry":
        swap = report["swap"]
        assert swap["lost_or_failed"] == swap["torn"] == swap["additional_compiles"] == 0
        assert swap["served_new"] > 0 and swap["swap_http_status"] == 200
        assert all(r["misrouted"] == r["failed"] == 0 for r in report["canary_sweep"]["rungs"])
        assert report["additional_compiles"] == 0
    else:
        assert [r["backends"] for r in report["sweep"]] == [1, 2]
        kill = report["recovery_under_kill"]
        assert kill["lost"] == kill["transport_errors"] == 0 and kill["replaced"]
        assert not kill["replacement_compiles"]
        scale = report["autoscale_round"]
        assert scale["scaled_up"] and scale["drained_back"] and scale["lost"] == 0


def _backlogged(monkeypatch, service_s: float = 0.04) -> None:
    """Each batch takes a fixed ``service_s`` before it launches: two
    replicas then serve 8 rows per 40 ms each, about half the rows the
    open loop offers (300 requests/s of 1-4 rows).  With the client's cap
    on outstanding requests above the round's 60, every request is sent on
    its seeded schedule, and every batch after a replica's first forms
    from a backlog: what a batch holds follows the arrival order, not how
    the host schedules the client's and the server's threads."""
    launch = InferenceEngine.launch

    def slowed(self, *args, **kwargs):
        time.sleep(service_s)
        return launch(self, *args, **kwargs)

    monkeypatch.setattr(InferenceEngine, "launch", slowed)


@pytest.mark.parametrize("case", sorted(ROUNDS))
def test_each_round_meets_its_verdict(tmp_path, capsys, monkeypatch, case):
    if case == "devicepath_ab":
        _backlogged(monkeypatch)
    argv = [a.format(d=tmp_path) for a in ROUNDS[case]]
    if "--buckets" not in argv:
        argv += ["--buckets", "4,8", "--max-request", "4"]
    rc = port.main([*CPU, *argv])
    out = capsys.readouterr().out
    assert rc == 0, out
    _round_verdict(case, _report(tmp_path, "r.json"))


def test_url_mode_drives_a_running_server(tmp_path, capsys):
    engine = InferenceEngine.from_seed(1, device="cpu", buckets=(4, 8))
    engine.warmup()
    server = make_server(engine, ServingMetrics(), port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        rc = port.main(["--url", url, "--requests", "20", "--max-request", "4",
                        "--report", str(tmp_path / "r.json")])
    finally:
        server.shutdown()
        server.batcher.stop(drain=True)
        server.server_close()
    assert rc == 0, capsys.readouterr().out
    report = _report(tmp_path, "r.json")
    assert report["status_counts"] == {"200": 20} and report["additional_compiles"] == 0


# The JAX parser's conflicts (serve_loadgen.py's main), and the refusals
# its run functions raise before anything is served.
CONFLICTS = {
    "url_replicas": ["--url", "http://127.0.0.1:9", "--replicas", "2"],
    "chaos_url": ["--chaos", "fail:launch:r1", "--url", "http://127.0.0.1:9"],
    "chaos_sweep": ["--chaos", "fail:launch:r1", "--replicas-sweep", "1,2"],
    "chaos_no_replicas": ["--chaos", "fail:launch:r1"],
    "hedge_url": ["--hedge", "--url", "http://127.0.0.1:9"],
    "hedge_one_engine": ["--hedge-delay-ms", "5"],
    "cache_url": ["--response-cache", "4", "--url", "http://127.0.0.1:9"],
    "cache_zero": ["--response-cache", "0"],
    "swap_replicas": ["--swap-at-s", "1", "--replicas", "2"],
    "swap_fleet": ["--canary-sweep", "25", "--fleet-sweep", "1"],
    "swap_zero": ["--swap-at-s", "0"],
    "swap_cache": ["--swap-at-s", "1", "--response-cache", "4"],
    "hostpath_url": ["--hostpath-ab", "--url", "http://127.0.0.1:9"],
    "hostpath_tail": ["--hostpath-ab", "--ab-tail"],
    "devicepath_sweep": ["--devicepath-ab", "--replicas-sweep", "1"],
    "devicepath_packed": ["--devicepath-ab", "--packed"],
    "fleet_url": ["--fleet-sweep", "1", "--url", "http://127.0.0.1:9"],
    "fleet_replicas": ["--fleet-sweep", "1", "--replicas", "2"],
    "tail_chaos": ["--ab-tail", "--chaos", "fail:launch:r1"],
    "sweep_url": ["--replicas-sweep", "1", "--url", "http://127.0.0.1:9"],
    "tail_closed_loop": ["--ab-tail"],
    "tail_one_replica": ["--ab-tail", "--open-loop", "--replicas", "1"],
    "tail_oversize": ["--ab-tail", "--open-loop", "--max-request", "64"],
    "fleet_closed_loop": ["--fleet-sweep", "1,2"],
    "fleet_zero": ["--fleet-sweep", "0,1", "--open-loop"],
    "hostpath_closed_loop": ["--hostpath-ab"],
    "devicepath_closed_loop": ["--devicepath-ab"],
    "sweep_zero": ["--replicas-sweep", "0,1"],
    "qos_mix_unknown": ["--url", "http://127.0.0.1:9", "--qos-mix", "bulk=1"],
    "qos_mix_sum": ["--url", "http://127.0.0.1:9", "--qos-mix", "interactive=0.5"],
    "repeat_dist": ["--url", "http://127.0.0.1:9", "--repeat-dist", "uniform:2"],
}


@pytest.mark.parametrize("case", sorted(CONFLICTS))
def test_conflicts_exit_as_the_jax_tools(case, capsys):
    codes = {}
    for name, tool in (("jax", jax_tool), ("port", port)):
        with pytest.raises(SystemExit) as exc:
            tool.main(["--requests", "2", *CONFLICTS[case]])
        err = capsys.readouterr().err.strip().splitlines()
        codes[name] = (exc.value.code, err[-1].split(": error: ")[-1] if err else None)
    assert codes["port"] == codes["jax"]
    assert codes["port"][0] not in (None, 0)


@pytest.mark.parametrize("spec", ["tp2,dp", "dp,ep2", "pp2"])
def test_a_sharded_replica_shape_is_refused(capsys, spec):
    """A sharded plan that needs more devices than the one CPU is refused
    with the serving CLI's words and the JAX planner's error (exit 2)."""
    import jax
    from pytorch_mnist_ddp_tpu.parallel.mesh import parse_replica_shapes, plan_replica_meshes

    with pytest.raises(ValueError) as jax_err:
        plan_replica_meshes(parse_replica_shapes(spec), jax.devices()[:1])
    rc = port.main([*CPU, "--replicas", str(len(spec.split(","))), "--replica-shapes", spec])
    out = capsys.readouterr().out
    assert rc == 2
    assert out == f"error: --replica-shapes {spec!r}: {jax_err.value}\n"


def test_lockwatch_is_refused_not_passed(capsys, monkeypatch):
    """The JAX tool's gate, ported: silent with the tracer off; after a
    traced run, the acyclic line and the run's own exit code; on a seeded
    lock-order cycle, ``rc or 3`` and the cycle named."""
    from pytorch_mnist_ddp_tpu_torch.analysis import lockwatch

    monkeypatch.delenv("JAXLINT_LOCKWATCH", raising=False)
    assert port._lockwatch_gate(0) == 0 and port._lockwatch_gate(1) == 1
    assert capsys.readouterr() == ("", "")
    monkeypatch.setenv("JAXLINT_LOCKWATCH", "1")
    lockwatch.watch().reset()
    try:
        rc = port.main([*CPU, "--requests", "6", "--buckets", "4,8", "--max-request", "4"])
        assert rc == 0
        assert lockwatch.watch().counts().get("batcher.pending", 0) > 0
        capsys.readouterr()
        assert port._lockwatch_gate(rc) == rc
        assert capsys.readouterr().out == "lockwatch: lock acquisition order acyclic\n"
        a, b = lockwatch.make_lock("test.a"), lockwatch.make_lock("test.b")
        with a, b:
            pass
        with b, a:
            pass
        assert port._lockwatch_gate(0) == 3 and port._lockwatch_gate(1) == 1
        err = capsys.readouterr().err
        assert "LOCK ORDER CYCLE" in err and "test.a -> test.b -> test.a" in err
    finally:
        lockwatch.watch().reset()
