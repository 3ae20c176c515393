"""Real replica pools on the CPU: the port's ``EnginePool`` against the JAX
package's.

The JAX pool runs two replicas on two of conftest's virtual CPU devices
(no AOT store); the port's runs ``EnginePool(replicas=2, device="cpu")``
on the same weights (``utils/convert.py``).  Both serve buckets up to 8
with the int8 variant beside f32.  Under ``roundrobin`` the same seeded
requests land on the same replicas, f32 answers agree within 1e-5 with
the same argmax and int8 within 5e-4 (tests/test_torch_quant.py's gate).
Beside that: the restart and ``add`` contracts (no warmup rung, no kernel
library loaded), the ``warmup`` fault, HTTP end to end with a drain, an
``add`` and a resubmitted request, ``/readyz`` with no routable replica,
the CLI's pool lines, and the int8 head's launch counter under threads.
"""

from __future__ import annotations

import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu.data.transforms import normalize as jax_normalize
from pytorch_mnist_ddp_tpu.models.net import init_params
from pytorch_mnist_ddp_tpu.serving.metrics import ServingMetrics as JaxMetrics
from pytorch_mnist_ddp_tpu.serving.pool import EnginePool as JaxPool
from pytorch_mnist_ddp_tpu.utils.rng import root_key, split_streams
from pytorch_mnist_ddp_tpu_torch.models.net import Net
from pytorch_mnist_ddp_tpu_torch.ops import _build
from pytorch_mnist_ddp_tpu_torch.ops import int8_head
from pytorch_mnist_ddp_tpu_torch.serving import faults
from pytorch_mnist_ddp_tpu_torch.serving.devices import (
    parse_replica_shapes,
    plan_replica_meshes,
    replica_devices,
    visible_devices,
)
from pytorch_mnist_ddp_tpu_torch.serving.engine import InferenceEngine
from pytorch_mnist_ddp_tpu_torch.serving.metrics import ServingMetrics
from pytorch_mnist_ddp_tpu_torch.serving.pool import EnginePool, _check_own_streams
from pytorch_mnist_ddp_tpu_torch.serving.server import make_server
from pytorch_mnist_ddp_tpu_torch.utils.convert import torch_state_from_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
F32_TOL, INT8_TOL = 1e-5, 5e-4
MAX_BUCKET = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(init_params(split_streams(root_key(1))["init"]))


@pytest.fixture(scope="module")
def state(jax_params):
    return torch_state_from_jax(jax_params)


@pytest.fixture(scope="module")
def requests():
    """Seeded requests of 1..8 rows and one of 12 (split over both
    replicas), as the server's model input."""
    rs = np.random.RandomState(15)
    sizes = [1, 3, 8, 2, 5, 12, 4, 7, 1, 6]
    return [jax_normalize(rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)) for n in sizes]


def serve_all(router, requests, dtype):
    """Each request through the router in turn: (answer, replicas that
    completed it)."""
    out = []
    for x in requests:
        req = router.submit(x, dtype=dtype)
        value = req.result()
        parts = getattr(req, "_parts", [req])
        out.append((np.asarray(value), tuple(p.completed_by for p in parts)))
    return out


@pytest.fixture(scope="module")
def jax_answers(jax_params, requests):
    metrics = JaxMetrics()
    pool = JaxPool({"params": jax_params}, replicas=2, devices=jax.devices()[:2],
                   max_bucket=MAX_BUCKET, dtypes=("int8",), metrics=metrics)
    pool.warmup()
    assert all(g["passed"] for g in pool.verify_parity().values())
    answers = {}
    for dt in ("f32", "int8"):  # a fresh router each, as the port's test starts one
        router = pool.start(router_policy="roundrobin", supervise=False, linger_ms=0.0,
                            adaptive_linger=False)
        try:
            answers[dt] = serve_all(router, requests, dt)
        finally:
            pool.stop()
            pool.router = None  # the JAX pool keeps its router after stop
    return answers


@pytest.fixture(scope="module")
def pool(state):
    metrics = ServingMetrics()
    p = EnginePool(state, replicas=2, device="cpu", max_bucket=MAX_BUCKET, dtypes=("int8",),
                   metrics=metrics)
    p.warmup()
    assert all(g["passed"] for g in p.verify_parity().values())
    return p


def test_replica_planning_wraps_like_jax():
    from pytorch_mnist_ddp_tpu.parallel import mesh as jmesh

    cards = [torch.device("cuda", i) for i in range(3)]
    assert [d.index for d in replica_devices(7, cards)] == \
        [d.id for d in jmesh.replica_devices(7, jax.devices()[:3])]
    assert replica_devices(None, cards) == cards
    assert [mesh.devices for _, _, mesh in plan_replica_meshes(
        parse_replica_shapes("dp,dp,dp,dp"), cards[:1])] == [(cards[0],)] * 4
    for spec in ("dp,dp", "tp4,dp", " DP ,pp2", ["vtp2", "ep4"]):
        assert parse_replica_shapes(spec) == jmesh.parse_replica_shapes(spec)
    for bad in ("tp", "dp2", "xp3", "tp0", ""):
        with pytest.raises(ValueError) as port_err:
            parse_replica_shapes(bad)
        with pytest.raises(ValueError) as jax_err:
            jmesh.parse_replica_shapes(bad)
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError) as port_err:
        plan_replica_meshes(parse_replica_shapes("tp2,dp"), cards[:2])
    with pytest.raises(ValueError) as jax_err:
        jmesh.plan_replica_meshes(jmesh.parse_replica_shapes("tp2,dp"), jax.devices()[:2])
    assert str(port_err.value) == str(jax_err.value)
    assert "needs 3 devices but only 2 are visible" in str(port_err.value)
    with pytest.raises(ValueError, match="need >= 1 replica"):
        replica_devices(0, cards)


@pytest.mark.parametrize("device, want", [
    (None, [0, 1, 2, 3]), ("cuda", [0, 1, 2, 3]), ("cuda:1", [1]), ("cuda:3", [3]),
])
def test_a_named_card_takes_every_replica(monkeypatch, device, want):
    """On four fake cards a bare ``cuda`` plans over all of them, while
    ``cuda:K`` (the single engine's --device) pins every replica to card K."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    cards = visible_devices(device)
    assert [d.index for d in cards] == want
    assert [d.index for d in replica_devices(6, cards)] == [want[i % len(want)] for i in range(6)]


def test_replicas_sharing_a_stream_are_refused():
    """Past a card's 32 pooled streams two replicas would share one and
    serialize; the pool refuses that, and allows one stream number on two
    cards."""
    def engine(card, stream):
        return SimpleNamespace(device=torch.device("cuda", card),
                               stream=SimpleNamespace(cuda_stream=stream))

    _check_own_streams([engine(0, 11), engine(0, 12), engine(1, 11)])
    _check_own_streams([SimpleNamespace(device=torch.device("cpu"), stream=None)] * 2)
    with pytest.raises(ValueError, match="replicas r0 and r2 share a CUDA stream on cuda:0"):
        _check_own_streams([engine(0, 11), engine(0, 12), engine(0, 11)])


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_roundrobin_pool_answers_like_jax(pool, jax_answers, requests, dtype):
    router = pool.start(router_policy="roundrobin", supervise=False, linger_ms=0.0,
                        adaptive_linger=False)
    try:
        port = serve_all(router, requests, dtype)
    finally:
        pool.stop()
    assert pool.router is None  # stopped: startable again
    tol = F32_TOL if dtype == "f32" else INT8_TOL
    for (got, by), (want, jax_by) in zip(port, jax_answers[dtype]):
        assert by == jax_by
        assert float(np.abs(got - want).max()) <= tol
        assert (got.argmax(1) == want.argmax(1)).all()
    assert {r for _, by in port for r in by} == {"r0", "r1"}


def test_every_replica_equals_the_single_engine(pool, state, requests):
    single = InferenceEngine(state, device="cpu", max_bucket=MAX_BUCKET, dtypes=("int8",))
    single.warmup()
    single.verify_parity()
    x = np.concatenate(requests[:4])[:MAX_BUCKET]
    for dtype in ("f32", "int8"):
        want = single.predict_logits(x, dtype=dtype)
        for engine in pool.engines:
            assert np.array_equal(engine.predict_logits(x, dtype=dtype), want)
    assert pool.weights_digest == single.weights_digest
    assert pool.variant_verified("int8") and pool.warmed
    assert pool.devices == [torch.device("cpu")] * 2


def test_restart_and_add_run_no_rung_and_load_no_library(pool, requests):
    rungs, loads = pool.rungs_run(), _build.LOADS
    assert rungs == 2 * 2 * len(pool.buckets)
    router = pool.start(router_policy="roundrobin", linger_ms=0.0, adaptive_linger=False,
                        supervisor_kwargs=dict(interval_s=0.01, backoff_base_s=0.02,
                                               backoff_jitter=0.0, restart_budget=5))
    try:
        pool.drain("r1")
        assert pool.add("r1") == "r1"
        with faults.injected("fail:launch:r1:count=3"):
            for x in requests * 2:
                for _ in range(3):
                    try:
                        router.submit(x).result()
                        break
                    except Exception:
                        continue
        deadline = time.perf_counter() + 5
        while pool.supervisor.stats()["restarts_total"] < 1 and time.perf_counter() < deadline:
            time.sleep(0.01)
        assert pool.supervisor.stats()["restarts_total"] >= 1
        assert router.replica("r1").state == "active"
    finally:
        pool.stop()
    assert pool.rungs_run() == rungs and _build.LOADS == loads


def test_warmup_fault_surfaces_instead_of_serving_unwarmed(state):
    p = EnginePool(state, replicas=2, device="cpu", buckets=(1,))
    with faults.injected("fail:warmup:r1") as injector:
        with pytest.raises(faults.FaultError, match="warmup"):
            p.warmup()
    assert injector.fired_counts() == {"fail:warmup:r1": 1}
    assert not p.warmed and p.engines[0].warmed and not p.engines[1].warmed


def test_parity_failure_on_any_replica_surfaces(pool, monkeypatch):
    failing = dict(pool.engines[0].parity_report["int8"], passed=False)
    monkeypatch.setattr(pool.engines[1], "verify_parity",
                        lambda tol=None, sink=None: {"int8": failing})
    monkeypatch.setattr(pool.engines[0], "verify_parity",
                        lambda tol=None, sink=None: {"int8": pool.engines[0].parity_report["int8"]})
    gates = pool.verify_parity()
    assert gates["int8"]["passed"] is False and gates["int8"]["replica"] == "r1"
    with pytest.raises(RuntimeError, match="failed their parity gate"):
        pool.verify_parity(raise_on_failure=True)


def test_weights_swap_and_canary_reach_every_replica(state):
    p = EnginePool(state, replicas=2, device="cpu", buckets=(4,), dtypes=("int8",))
    p.warmup()
    p.verify_parity()
    other = Net(torch.Generator().manual_seed(99)).state_dict()
    ref = InferenceEngine(other, device="cpu", buckets=(4,))
    x = np.random.RandomState(3).rand(4, 28, 28, 1).astype(np.float32)
    assert p.install_version("v2", other) == ref.weights_digest
    assert all(np.array_equal(e.predict_logits(x, dtype="f32@v2"), ref.predict_logits(x))
               for e in p.engines)
    assert p.remove_version("v2") == 2 * 2
    digest = p.publish_weights(other, version="v2")
    assert digest == ref.weights_digest == p.weights_digest and p.version == "v2"
    assert all(np.array_equal(e.predict_logits(x), ref.predict_logits(x)) for e in p.engines)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _post(url, rows):
    body = json.dumps({"instances": rows.reshape(len(rows), -1).tolist(),
                       "return_log_probs": True}).encode()
    req = urllib.request.Request(url, body, {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_end_to_end_with_drain_add_and_resubmission(state):
    metrics = ServingMetrics()
    p = EnginePool(state, replicas=2, device="cpu", buckets=(1, 2, 4), metrics=metrics)
    p.warmup()
    router = p.start(router_policy="cost", linger_ms=1.0,
                     supervisor_kwargs=dict(interval_s=0.01))
    server = make_server(p, metrics, batcher=router)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    raw = np.random.RandomState(4).randint(0, 256, (40, 28, 28)).astype(np.uint8)
    want = p.engines[0].predict_logits(jax_normalize(raw))
    try:
        status, health = _get(base + "/healthz")
        assert status == 200 and health["replicas"] == {"r0": "active", "r1": "active"}
        answers = {}

        def client(c):
            for j in range(6):
                i = (c * 6 + j) % 37
                answers[(c, j)] = (i, *_post(base + "/predict", raw[i:i + 3]))

        clients = [threading.Thread(target=client, args=(c,)) for c in range(4)]
        for t in clients:
            t.start()
        p.drain("r1")  # mid-stream
        status, health = _get(base + "/healthz")
        assert health["replicas"]["r1"] == "drained"
        for t in clients:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in clients)
        p.add("r1")
        assert _get(base + "/healthz")[1]["replicas"]["r1"] == "active"
        assert len(answers) == 24
        for i, status, body in answers.values():
            assert status == 200
            assert np.abs(np.asarray(body["log_probs"]) - want[i:i + 3]).max() <= F32_TOL
        # A request flushed off a dead replica is resubmitted on the other.
        with faults.injected("fail:launch:*:count=1") as injector:
            status, body = _post(base + "/predict", raw[:2])
        assert status == 200 and injector.fired_counts() == {"fail:launch:*:count=1": 1}
        assert np.abs(np.asarray(body["log_probs"]) - want[:2]).max() <= F32_TOL
        assert metrics.retried == 1 and metrics.failed == 1
        status, snap = _get(base + "/metrics")
        assert snap["retries"] == 1 and set(snap["replicas"]) == {"r0", "r1"}
        prom = urllib.request.urlopen(base + "/metrics?format=prom").read().decode()
        for family in ("serving_request_retries_total", "serving_replica_inflight",
                       "serving_router_decisions_total", "serving_replica_drain_seconds"):
            assert family in prom
    finally:
        server.shutdown()
        p.stop()
        server.server_close()
    assert metrics.completed == 25 and metrics.rejected == 0


def test_readyz_503_when_no_replica_is_routable(state):
    metrics = ServingMetrics()
    p = EnginePool(state, replicas=2, device="cpu", buckets=(1,), metrics=metrics)
    p.warmup()
    router = p.start(supervise=False, linger_ms=0.0)
    server = make_server(p, metrics, batcher=router)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        status, body = _get(base + "/readyz")
        assert status == 200 and body["routable_replicas"] == 2
        router.quarantine("r0", reason="test")
        status, body = _get(base + "/readyz")
        assert status == 200 and body["replicas"] == {"r0": "quarantined", "r1": "healthy"}
        router.quarantine("r1", reason="test")
        status, body = _get(base + "/readyz")
        assert status == 503 and body == {
            "routable_replicas": 0, "replicas": {"r0": "quarantined", "r1": "quarantined"},
            "circuits": {"r0": "open", "r1": "open"}, "status": "unready"}
        status, _ = _post(base + "/predict", np.zeros((1, 28, 28), np.uint8))
        assert status == 503
    finally:
        server.shutdown()
        p.stop()
        server.server_close()


def test_cli_serves_the_pool_and_prints_the_pool_lines(tmp_path):
    """The CLI in its own process: the JAX CLI's pool lines, one answer,
    and SIGTERM's drain and report."""
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.serving", "--device", "cpu",
         "--port", "0", "--replicas", "2", "--buckets", "1,2", "--router-policy",
         "least-loaded", "--hedge-delay-ms", "50", "--restart-budget", "2"],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if line.startswith("serving on"):
                break
        serving = lines[-1]
        port = int(serving.split("http://127.0.0.1:")[1].split(" ")[0])
        status, _ = _post(f"http://127.0.0.1:{port}/predict", np.zeros((2, 28, 28), np.uint8))
        assert status == 200
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0
    assert lines[1] == ("warming buckets [1, 2] x dtypes ['f32'] x 2 replicas "
                        "(devices ['cpu', 'cpu'])")
    rungs = [re.fullmatch(r"  \[(r[01])\]  f32 bucket    ([12]): ready \((\d) rungs warmed\)", x)
             for x in lines[2:6]]
    assert all(rungs), lines[2:6]
    assert {(m[1], m[2]) for m in rungs} == {("r0", "1"), ("r0", "2"), ("r1", "1"), ("r1", "2")}
    counts = [int(m[3]) for m in rungs]
    assert counts == sorted(counts) and counts[-1] == 4
    assert serving == (
        f"serving on http://127.0.0.1:{port} (POST /predict, GET /metrics, GET /healthz "
        "liveness, GET /readyz readiness; 2 replicas, router policy least-loaded, "
        "supervisor on, hedging on (50 ms), per-replica in-flight window 2, adaptive "
        "linger on, deadline close on)")
    assert "draining admitted requests and the in-flight window..." in rest
    assert "  requests: 1 ok / 0 rejected / 0 timed out / 0 failed (admitted 1)" in rest
    assert "  hedges: " in rest


def test_int8_head_launch_counter_loses_no_count_across_threads(monkeypatch):
    """Dispatch threads count launches at once; a bare += would lose some.
    The plain CPU path itself counts nothing."""
    monkeypatch.setattr(int8_head, "LAUNCHES", 0)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [int8_head.count_launch()
                                                     for _ in range(5000)])
                   for _ in range(16)]  # more threads than cores
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert int8_head.LAUNCHES == 16 * 5000
    from pytorch_mnist_ddp_tpu_torch.models.quant import quantize_params

    q = quantize_params(Net(torch.Generator().manual_seed(3)).state_dict())
    x = torch.rand(2, 9216, generator=torch.Generator().manual_seed(4))
    threads = [threading.Thread(target=int8_head.fused_int8_head, args=(q["fc1"], q["fc2"], x))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert int8_head.LAUNCHES == 16 * 5000
