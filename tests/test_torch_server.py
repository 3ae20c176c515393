"""The port's HTTP serving path on the CPU: make_server, the micro-batcher
and the CLI, with carried-across JAX seed-1 weights; the QoS field, the
binary wire, the response cache, the registry's admin surface and the
JAX server's status mapping (400, 408, 500, 503, 504).

Answers over HTTP are held against ``engine.predict_logits`` on the same
rows: within 1e-5 (a request may coalesce into another bucket size than
the direct call, and the CPU convolution's summation can change with it)
and with identical predictions.
"""

from __future__ import annotations

import json
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from pytorch_mnist_ddp_tpu.models.net import init_params
from pytorch_mnist_ddp_tpu.utils.rng import root_key, split_streams
from pytorch_mnist_ddp_tpu_torch.data.transforms import normalize
from pytorch_mnist_ddp_tpu_torch.serving import wire
from pytorch_mnist_ddp_tpu_torch.serving.batcher import MicroBatcher, RejectedError
from pytorch_mnist_ddp_tpu_torch.serving.engine import InferenceEngine
from pytorch_mnist_ddp_tpu_torch.serving.metrics import ServingMetrics
from pytorch_mnist_ddp_tpu_torch.serving.server import decode_instances, make_server
from pytorch_mnist_ddp_tpu_torch.utils.convert import torch_state_from_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5


@pytest.fixture(scope="module")
def state():
    params = jax.device_get(init_params(split_streams(root_key(1))["init"]))
    return torch_state_from_jax(params)


@pytest.fixture(scope="module")
def engine(state):
    eng = InferenceEngine(
        state, device="cpu", buckets=(1, 2, 4, 8), dtypes=("int8",),
        metrics=ServingMetrics(),
    )
    eng.warmup()
    assert eng.verify_parity()["int8"]["passed"]
    return eng


class _Running:
    """A started server on 127.0.0.1:0 and its accept thread."""

    def __init__(self, engine, **batcher_kwargs):
        self.metrics = ServingMetrics()
        self.server = make_server(engine, self.metrics, **batcher_kwargs)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def stop(self):
        self.server.shutdown()
        self.server.batcher.stop(drain=True)
        self.server.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def running(engine):
    srv = _Running(engine, linger_ms=1.0)
    yield srv
    srv.stop()


def _post(url: str, body, raw: bytes | None = None) -> tuple[int, dict]:
    data = raw if raw is not None else json.dumps(body).encode()
    req = urllib.request.Request(url + "/predict", data, {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url: str, path: str) -> tuple[int, bytes]:
    try:
        with urllib.request.urlopen(url + path, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _raw(n: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, (n, 28, 28)).astype(np.uint8)


@pytest.mark.parametrize("shape", ["flat", "28x28", "28x28x1"])
@pytest.mark.parametrize("dtype", [None, "f32", "int8"])
def test_predict_json_instance_shapes(engine, running, shape, dtype):
    raw = _raw(3, seed=len(shape))
    instances = {
        "flat": raw.reshape(3, -1), "28x28": raw, "28x28x1": raw[..., None],
    }[shape].tolist()
    body = {"instances": instances, "return_log_probs": True}
    if dtype is not None:
        body["dtype"] = dtype
    status, resp = _post(running.url, body)
    assert status == 200, resp
    want = engine.predict_logits(normalize(raw), dtype=dtype)
    np.testing.assert_allclose(np.asarray(resp["log_probs"], np.float32), want,
                               rtol=0, atol=TOL)
    assert resp["predictions"] == want.argmax(1).tolist()


def test_predict_normalized_inputs_pass_verbatim(engine, running):
    x = normalize(_raw(2, seed=9))
    status, resp = _post(running.url, {
        "instances": x.tolist(), "normalized": True, "return_log_probs": True,
    })
    assert status == 200
    np.testing.assert_allclose(np.asarray(resp["log_probs"], np.float32),
                               engine.predict_logits(x), rtol=0, atol=TOL)
    assert "log_probs" not in _post(running.url, {"instances": x.tolist()})[1]


@pytest.mark.parametrize(
    "body, raw",
    [
        (None, b"{not json"),
        ({}, None),
        ({"instances": [0.0] * 784}, None),  # one sample, not wrapped in a list
        ({"instances": [[0.0] * 783]}, None),
        ({"instances": [[0.0] * 784], "dtype": "bf16"}, None),
        ([1, 2], None),
        ({"instances": [["a"] * 784]}, None),
    ],
    ids=["not_json", "missing", "unwrapped", "bad_width", "unknown_dtype",
         "not_object", "not_numeric"],
)
def test_malformed_requests_get_400(running, body, raw):
    status, resp = _post(running.url, body, raw)
    assert status == 400 and resp["error"]


def test_oversize_request_is_rejected_503(running):
    status, resp = _post(running.url, {"instances": _raw(9, seed=1).reshape(9, -1).tolist()})
    assert status == 503 and "outside" in resp["error"]


def test_metrics_json_and_prometheus(running):
    _post(running.url, {"instances": _raw(1, seed=2).reshape(1, -1).tolist()})
    status, body = _get(running.url, "/metrics")
    snap = json.loads(body)
    assert status == 200 and snap["requests"]["completed"] >= 1
    assert snap["buckets"] == [1, 2, 4, 8] and "latency_ms" in snap
    status, prom = _get(running.url, "/metrics?format=prom")
    text = prom.decode()
    assert status == 200
    assert 'serving_requests_total{outcome="completed"}' in text
    assert "# TYPE serving_request_latency_seconds summary" in text


@pytest.mark.parametrize("path, status", [("/healthz", 200), ("/readyz", 200), ("/nope", 404)])
def test_health_endpoints(running, path, status):
    got, body = _get(running.url, path)
    assert got == status
    if path == "/healthz":
        health = json.loads(body)
        assert health["status"] == "ok" and health["device"] == "cpu"
        assert health["dtypes"] == {"f32": True, "int8": True}


def test_concurrent_clients_then_drain_loses_nothing(engine):
    srv = _Running(engine, linger_ms=5.0, queue_depth=64)
    results, errors = [], []

    def client(seed):
        for i in range(4):
            raw = _raw(1 + (seed + i) % 4, seed=100 * seed + i)
            status, resp = _post(srv.url, {
                "instances": raw.reshape(len(raw), -1).tolist(),
                "dtype": "int8" if i % 2 else "f32",
            })
            (results if status == 200 else errors).append((raw, i, resp))

    threads = [threading.Thread(target=client, args=(s,)) for s in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    srv.stop()
    assert not errors and len(results) == 32
    for raw, i, resp in results:
        want = engine.predict_logits(normalize(raw), dtype="int8" if i % 2 else None)
        assert resp["predictions"] == want.argmax(1).tolist()
    assert srv.metrics.completed == 32 and srv.metrics.failed == 0
    assert srv.metrics.batches <= 32  # coalescing happened or not, never more
    with pytest.raises(RejectedError, match="draining"):
        srv.server.batcher.submit(normalize(_raw(1, seed=0)))


@pytest.mark.parametrize("packed", [False, True], ids=["bucketed", "packed"])
def test_batcher_drain_completes_everything_admitted(engine, state, packed):
    eng = engine
    if packed:
        eng = InferenceEngine(state, device="cpu", buckets=(1, 2, 4, 8), packed=True)
        eng.warmup()
    batcher = MicroBatcher(eng, linger_ms=20.0, fill_wait_ms=20.0, max_inflight=1).start()
    xs = [normalize(_raw(1 + i % 3, seed=i)) for i in range(12)]
    pending = [batcher.submit(x) for x in xs]
    batcher.stop(drain=True)
    for x, req in zip(xs, pending):
        assert req.done()
        np.testing.assert_allclose(req.result(), eng.predict_logits(x), rtol=0, atol=TOL)


def test_batcher_full_queue_rejects(engine):
    batcher = MicroBatcher(engine, queue_depth=2)  # not started: nothing drains
    x = normalize(_raw(1, seed=3))
    batcher.submit(x)
    batcher.submit(x)
    with pytest.raises(RejectedError, match="queue full"):
        batcher.submit(x)
    batcher.stop(drain=False)


def test_decode_instances_applies_training_normalize():
    raw = _raw(2, seed=4)
    assert np.array_equal(decode_instances({"instances": raw.tolist()}), normalize(raw))


CLI = [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.serving", "--device", "cpu"]
CLI_ENV = {**os.environ, "PYTHONPATH": str(ROOT)}


def test_cli_warmup_only_passes_the_int8_gate():
    proc = subprocess.run(
        CLI + ["--warmup-only", "--buckets", "1,2,4", "--dtypes", "f32,int8"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=CLI_ENV,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "parity gate [int8]: PASS" in proc.stdout
    assert "warming buckets [1, 2, 4] x dtypes ['f32', 'int8'] serially on cpu" in proc.stdout
    assert proc.stdout.count(": ready (") == 6


def test_cli_refuses_to_serve_on_a_failed_gate():
    # Seed 11's random weights tie on argmax within the int8 error on the
    # 8-row parity slice: the gate must refuse them.
    proc = subprocess.run(
        CLI + ["--seed", "11", "--buckets", "1,2,4,8", "--dtypes", "int8"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=CLI_ENV,
    )
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "parity gate [int8]: FAIL" in proc.stdout
    assert "refusing to serve" in proc.stdout and "serving on" not in proc.stdout


def test_cli_serves_then_drains_on_sigterm():
    proc = subprocess.Popen(
        CLI + ["--port", "0", "--buckets", "1,2,4", "--dtypes", "f32,int8"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=CLI_ENV,
    )
    try:
        for line in proc.stdout:
            if line.startswith("serving on http://"):
                url = line.split()[2]
                break
        else:
            pytest.fail("the CLI exited before serving")
        raw = _raw(2, seed=12)
        status, resp = _post(url, {"instances": raw.tolist(), "dtype": "int8"})
        assert status == 200 and len(resp["predictions"]) == 2
        proc.send_signal(signal.SIGTERM)
        rest = proc.communicate(timeout=60)[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, rest
    assert "draining admitted requests" in rest
    assert "requests: 1 ok / 0 rejected / 0 timed out / 0 failed" in rest


# -- the serving stack over HTTP: QoS, the wire, the cache, the registry's
# admin surface, the status mapping -------------------------------------------


def _post_raw(url: str, data: bytes, ctype: str) -> tuple[int, bytes, str]:
    req = urllib.request.Request(url + "/predict", data, {"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read(), r.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type", "")


def _admin(url: str, verb: str, body: dict) -> tuple[int, dict]:
    req = urllib.request.Request(f"{url}/admin/{verb}", json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class _ListSink:
    def __init__(self):
        self.events = []

    def emit(self, event, **fields):
        self.events.append((event, fields))

    def __bool__(self):
        return True


def test_qos_field_selects_the_class_and_an_unknown_one_is_400(running):
    body = {"instances": _raw(1, seed=20).reshape(1, -1).tolist()}
    status, resp = _post(running.url, {**body, "qos": "premium"})
    assert status == 400 and "premium" in resp["error"]
    assert _post(running.url, {**body, "qos": "batch"})[0] == 200
    assert _post(running.url, body)[0] == 200
    qos = json.loads(_get(running.url, "/metrics")[1])["qos"]
    assert qos["batch"]["requests"] >= 1 and qos["interactive"]["requests"] >= 1


def test_binary_wire_answers_the_json_logits_and_falls_back_to_json(engine):
    sink = _ListSink()
    srv = _Running(engine, linger_ms=1.0, sink=sink)
    try:
        raw = _raw(3, seed=21)
        for dtype in ("f32", "int8"):
            status, body, ctype = _post_raw(
                srv.url, wire.encode_request(raw.astype(np.float32), dtype=dtype, qos="batch"),
                wire.WIRE_REQUEST_TYPE)
            assert status == 200 and ctype == wire.WIRE_RESPONSE_TYPE
            logits = wire.decode_response(body)
            json_logits = np.asarray(_post(srv.url, {
                "instances": raw.tolist(), "dtype": dtype, "return_log_probs": True,
            })[1]["log_probs"], np.float32)
            np.testing.assert_allclose(logits, json_logits, rtol=0, atol=TOL)
        status, body, _ = _post_raw(srv.url, b"MNW1" + b"\0" * 10, wire.WIRE_REQUEST_TYPE)
        assert status == 400 and b"shorter than" in body
        status, body, _ = _post_raw(srv.url, json.dumps({"instances": raw.tolist()}).encode(),
                                    "text/plain")
        assert status == 200 and ("wire_fallback", {"content_type": "text/plain"}) in sink.events
        snap = json.loads(_get(srv.url, "/metrics")[1])
        assert snap["wire"]["requests"]["binary"] == 3
        assert snap["wire"]["bytes"]["in"] > 3 * 3 * 784 * 4
    finally:
        srv.stop()


def test_response_cache_coalesces_and_hits_over_http(engine):
    srv = _Running(engine, linger_ms=1.0, response_cache=16)
    try:
        body = {"instances": _raw(2, seed=22).reshape(2, -1).tolist(), "dtype": "int8"}
        batches0 = engine.metrics.batches
        barrier = threading.Barrier(8)
        answers = []

        def client():
            barrier.wait()
            answers.append(_post(srv.url, body))

        threads = [threading.Thread(target=client) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert [a[0] for a in answers] == [200] * 8 and len({str(a[1]) for a in answers}) == 1
        assert engine.metrics.batches - batches0 == 1  # one dispatch for eight requests
        assert _post(srv.url, body) == answers[0]
        cache = srv.metrics.snapshot()["cache"]
        assert cache["miss"] == 1 and cache["hit"] + cache["coalesced"] == 8
        assert engine.metrics.batches - batches0 == 1
    finally:
        srv.stop()


@pytest.fixture()
def registry_server(engine, tmp_path):
    from pytorch_mnist_ddp_tpu_torch.serving.registry import ModelRegistry
    from pytorch_mnist_ddp_tpu_torch.serving.rollout import RolloutController
    from pytorch_mnist_ddp_tpu_torch.utils.checkpoint import model_state_dict, save_state_dict

    reg = ModelRegistry(str(tmp_path))
    for version, seed in (("v1", 1), ("v2", 2)):
        params = jax.device_get(init_params(split_streams(root_key(seed))["init"]))
        path = str(tmp_path / f"{version}.pt")
        save_state_dict(model_state_dict(torch_state_from_jax(params)), path)
        reg.publish("mnist", version, path)
    entry = reg.resolve()
    eng = InferenceEngine(reg.load(entry), device="cpu", buckets=(1, 2, 4, 8),
                          metrics=ServingMetrics(), version=entry.version)
    eng.warmup()
    srv = _Running(eng, linger_ms=1.0, response_cache=16,
                   rollout=RolloutController(reg, eng))
    yield srv, eng
    srv.stop()


def test_admin_swap_canary_rollback_and_the_model_fields(registry_server, running):
    srv, eng = registry_server
    assert _admin(running.url, "swap", {"version": "v2"})[0] == 503  # no registry
    body = {"instances": _raw(2, seed=23).reshape(2, -1).tolist(), "return_log_probs": True}
    v1 = _post(srv.url, body)[1]["log_probs"]
    status, resp = _admin(srv.url, "canary", {"version": "v2", "pct": 100})
    assert status == 200 and resp["canary"]["version"] == "v2"
    assert _post(srv.url, body)[1]["log_probs"] != v1  # every unpinned request: v2
    assert _post(srv.url, {**body, "version": "v1"})[1]["log_probs"] == v1  # pinned
    status, resp = _post(srv.url, {**body, "dtype": "f32@v2"})
    assert status == 400 and "unknown dtype" in resp["error"]
    assert _admin(srv.url, "rollback", {})[1]["canary"] is None
    assert _post(srv.url, body)[1]["log_probs"] == v1
    status, resp = _admin(srv.url, "swap", {"version": "v9"})
    assert status == 400 and "unknown version" in resp["error"]
    assert _admin(srv.url, "swap", {})[0] == 400  # missing field
    status, resp = _admin(srv.url, "swap", {"version": "v2"})
    assert status == 200 and resp["version"] == "v2" and resp["weights_digest"] == eng.weights_digest
    v2 = _post(srv.url, body)[1]["log_probs"]
    assert v2 != v1 and _post(srv.url, {**body, "model": "mnist", "version": "v2"})[1][
        "log_probs"] == v2
    assert _post(srv.url, {**body, "model": "other"})[0] == 400
    assert _post(running.url, {**body, "model": "mnist"})[0] == 400  # no registry there
    assert json.loads(_get(srv.url, "/healthz")[1])["rollout"]["version"] == "v2"
    assert _admin(srv.url, "rollout", {})[1]["version"] == "v2"


def test_a_stalled_body_is_answered_408(engine):
    import socket

    srv = _Running(engine, request_timeout_s=0.3)
    try:
        host, port = srv.server.server_address[:2]
        with socket.create_connection((host, port), timeout=10) as sock:
            sock.sendall(b"POST /predict HTTP/1.1\r\nHost: x\r\nContent-Type: "
                         b"application/json\r\nContent-Length: 500\r\n\r\n{\"inst")
            reply = b""
            while chunk := sock.recv(4096):  # the server closes after its 408
                reply += chunk
        assert reply.startswith(b"HTTP/1.1 408") and b"timed out" in reply
    finally:
        srv.stop()


def test_503_504_500_map_as_in_jax(engine):
    from pytorch_mnist_ddp_tpu_torch.serving import faults

    srv = _Running(engine, linger_ms=0.0, queue_depth=1)
    try:
        body = {"instances": _raw(1, seed=24).reshape(1, -1).tolist()}
        with faults.injected("fail:launch"):
            status, resp = _post(srv.url, body)
        assert status == 500 and "FaultError" in resp["error"]
        with faults.injected("hang:launch:for=5") as injector:
            held = threading.Thread(target=_post, args=(srv.url, body))
            held.start()
            deadline = time.perf_counter() + 10
            while not injector.fired_counts()["hang:launch:for=5"]:
                assert time.perf_counter() < deadline
                time.sleep(0.005)
            # a deadline that outlives the 503 probe below but not the 5 s
            # hang: the request cannot expire (and free its slot) before
            # the probe arrives, and still times out behind the hang
            data = wire.encode_request(_raw(1, seed=25).astype(np.float32), deadline_ms=1000)
            status504 = []
            queued = threading.Thread(target=lambda: status504.append(
                _post_raw(srv.url, data, wire.WIRE_REQUEST_TYPE)[0]))
            queued.start()
            while srv.server.batcher.depth() < 1:
                time.sleep(0.005)
            status, resp = _post(srv.url, {**body, "qos": "batch"})  # the queue is full
            assert status == 503 and "queue full" in resp["error"]
            queued.join(timeout=10)
        held.join(timeout=10)
        assert status504 == [504]
        # the worker counts the expiry when it reaches the request, once the
        # hang is over: wait for it, then hold the count to exactly one
        until = time.perf_counter() + 10
        while (srv.metrics.snapshot()["requests"]["timed_out"] < 1
               and time.perf_counter() < until):
            time.sleep(0.01)
        assert srv.metrics.snapshot()["requests"]["timed_out"] == 1
    finally:
        srv.stop()
