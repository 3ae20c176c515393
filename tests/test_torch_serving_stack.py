"""The port's serving host machinery held against the JAX package's on the
CPU: the QoS queue, the adaptive linger, the deadline-aware close, the
batcher's packed segments and splits, the binary wire, the response
cache, the circuit breaker, the canary assignment and the metrics' tail
surfaces.

Host schedules are compared exactly: the same arrivals through both
packages' queues and batchers (each over a fake engine that records what
it was handed) give the same dequeue order, the same batches, the same
segment vectors and the same reassembled answers; the wire gives the same
bytes both ways and the same rejections; the cache the same outcomes.
The port's own batcher behaviours (shedding, eager expiry, the fault
points, the sink's events) are pinned as the JAX package's tests pin
them.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu.obs.export import render_prometheus as jax_render
from pytorch_mnist_ddp_tpu.serving import batcher as jbatcher
from pytorch_mnist_ddp_tpu.serving import cache as jcache
from pytorch_mnist_ddp_tpu.serving import circuit as jcircuit
from pytorch_mnist_ddp_tpu.serving import metrics as jmetrics
from pytorch_mnist_ddp_tpu.serving import qos as jqos
from pytorch_mnist_ddp_tpu.serving import rollout as jrollout
from pytorch_mnist_ddp_tpu.serving import wire as jwire
from pytorch_mnist_ddp_tpu_torch.obs.registry import render_prometheus
from pytorch_mnist_ddp_tpu_torch.serving import batcher as pbatcher
from pytorch_mnist_ddp_tpu_torch.serving import cache as pcache
from pytorch_mnist_ddp_tpu_torch.serving import circuit as pcircuit
from pytorch_mnist_ddp_tpu_torch.serving import faults
from pytorch_mnist_ddp_tpu_torch.serving import metrics as pmetrics
from pytorch_mnist_ddp_tpu_torch.serving import qos as pqos
from pytorch_mnist_ddp_tpu_torch.serving import rollout as prollout
from pytorch_mnist_ddp_tpu_torch.serving import wire as pwire

PACKAGES = {"jax": (jbatcher, jmetrics, jqos), "port": (pbatcher, pmetrics, pqos)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- fakes: an engine that records what it is handed ----------------------------


class _Out:
    """A launched batch's log-probs: column 0 the rows' request tag,
    column 1 their row index within the request."""

    def __init__(self, rows: np.ndarray, delay_s: float = 0.0):
        self._rows = rows
        self._ready = time.perf_counter() + delay_s

    def __array__(self, dtype=None, copy=None):
        wait = self._ready - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        out = np.zeros((len(self._rows), 10), np.float32)
        out[:, 0] = self._rows[:, 0, 0, 0]
        out[:, 1] = self._rows[:, 0, 1, 0]
        return out


class FakeEngine:
    default_dtype = "f32"
    dtypes = ("f32", "int8")
    metrics = None

    def __init__(self, buckets=(8,), packed=False, delay_s=0.0):
        self.buckets = tuple(buckets)
        self.packed = packed
        self.delay_s = delay_s
        self.launches: list[tuple] = []

    def variant_verified(self, dtype):
        return True

    def launch(self, staged, n, dtype=None, seg_ids=None):
        rows = np.array(staged, np.float32)  # the staging buffer is reused
        self.launches.append((
            int(n), len(rows), dtype,
            None if seg_ids is None else np.asarray(seg_ids).tolist(),
            rows[:, 0, 0, 0].tolist(), rows[:, 0, 1, 0].tolist(),
        ))
        return _Out(rows, self.delay_s)


class _ListSink:
    def __init__(self):
        self.events: list[dict] = []
        self._lock = threading.Lock()

    def emit(self, event, **fields):
        with self._lock:
            self.events.append({"event": event, **fields})

    def of(self, name):
        with self._lock:
            return [e for e in self.events if e["event"] == name]

    def __bool__(self):
        return True


def _rows(n: int, tag: float = 1.0) -> np.ndarray:
    x = np.zeros((n, 28, 28, 1), np.float32)
    x[:, 0, 0, 0] = tag
    x[:, 0, 1, 0] = np.arange(n)
    return x


def _arrivals(seed: int, count: int, max_rows: int):
    """Seeded requests: (rows, dtype, qos)."""
    rs = np.random.RandomState(seed)
    return [(int(rs.randint(1, max_rows + 1)), ("f32", "int8")[rs.randint(0, 2)]
             if rs.rand() < 0.3 else "f32", ("interactive", "batch")[rs.randint(0, 2)])
            for _ in range(count)]


def _run_batcher(pkg: str, arrivals, buckets, packed, **kwargs):
    """Queue every arrival, then start: the batches form from a full queue,
    so both packages see the same input.  Returns (launches, results)."""
    batcher_mod, metrics_mod, _ = PACKAGES[pkg]
    engine = FakeEngine(buckets, packed)
    b = batcher_mod.MicroBatcher(engine, metrics=metrics_mod.ServingMetrics(),
                                 queue_depth=256, timeout_ms=30000.0, **kwargs)
    reqs = [b.submit(_rows(n, tag=i + 1), dtype=dt, qos=q)
            for i, (n, dt, q) in enumerate(arrivals)]
    b.start()
    results = [r.result() for r in reqs]
    b.stop(drain=True)
    return engine.launches, results


# -- the QoS queue ---------------------------------------------------------------


class _Req:
    def __init__(self, i, qos, deadline=1e18):
        self.i, self.qos, self.deadline = i, qos, deadline

    def expired(self, now=None):
        return (time.perf_counter() if now is None else now) > self.deadline

    def done(self):
        return False


@pytest.mark.parametrize("weights", [None, {"interactive": 3, "batch": 2},
                                     {"interactive": 1, "batch": 1}])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_qos_dequeue_order_equals_jax(weights, seed):
    rs = np.random.RandomState(seed)
    ops = [("put", ("interactive", "batch")[rs.randint(0, 2)]) if rs.rand() < 0.6 else ("get",)
           for _ in range(200)]
    orders = {}
    for pkg, (_, _, qmod) in PACKAGES.items():
        q = qmod.QoSQueue(maxsize=64, weights=weights)
        order = []
        for i, op in enumerate(ops):
            if op[0] == "put":
                try:
                    q.put_nowait(_Req(i, op[1]))
                except queue.Full:
                    order.append(("full", i))
            else:
                try:
                    order.append(q.get_nowait().i)
                except queue.Empty:
                    order.append("empty")
        while q.qsize():
            order.append(q.get_nowait().i)
        orders[pkg] = order
    assert orders["port"] == orders["jax"]


def test_qos_shed_and_sweep_order_equals_jax():
    now = time.perf_counter()
    outs = {}
    for pkg, (_, _, qmod) in PACKAGES.items():
        q = qmod.QoSQueue(maxsize=16)
        for i in range(12):
            q.put_nowait(_Req(i, ("batch", "interactive")[i % 3 == 0],
                              deadline=now - 1 if i in (4, 7) else now + 1e9))
        expired = sorted(r.i for r in q.sweep_expired(now))
        shed = []
        while (victim := q.shed_for("interactive")) is not None:
            shed.append(victim.i)
        outs[pkg] = (expired, shed, q.shed_for("batch"), q.sizes())
        with pytest.raises(ValueError, match="unknown QoS class"):
            q.put_nowait(_Req(99, "premium"))
    assert outs["port"] == outs["jax"]
    assert outs["port"][1] == [11, 10, 8, 5, 2, 1]  # newest batch first


# -- the adaptive linger and the deadline-aware close --------------------------------


@pytest.mark.parametrize("ceiling_ms, enabled", [(2.0, True), (10.0, True), (3.0, False)])
def test_adaptive_linger_values_equal_jax(ceiling_ms, enabled):
    depths = np.random.RandomState(7).choice([0, 0, 1, 2, 3, 4, 6, 9, 20], 300)
    values = {}
    for pkg, (bmod, mmod, _) in PACKAGES.items():
        metrics = mmod.ServingMetrics()
        linger = bmod.AdaptiveLinger(ceiling_ms / 1e3, enabled=enabled, registry=metrics.registry)
        values[pkg] = [linger.update(int(d)) for d in depths]
        gauge = metrics.registry.gauge("serving_linger_seconds").value
        assert gauge == (values[pkg][-1] if enabled else ceiling_ms / 1e3)
    assert values["port"] == values["jax"]
    assert all(0.0 <= v <= ceiling_ms / 1e3 for v in values["port"])
    if enabled:
        assert 0.0 in values["port"]  # snapped to zero under a deep queue


@pytest.mark.parametrize("deadline_aware", [True, False])
def test_close_at_equals_jax_under_an_injected_clock(deadline_aware):
    rs = np.random.RandomState(3)
    cases = [(float(rs.uniform(0, 100)), float(rs.choice([0.0, 0.002, 0.5])),
              float(rs.uniform(-1, 101)), None if rs.rand() < 0.3 else float(rs.uniform(0, 0.2)))
             for _ in range(200)]
    got = {}
    for pkg, (bmod, mmod, _) in PACKAGES.items():
        b = bmod.MicroBatcher(FakeEngine(), metrics=mmod.ServingMetrics(),
                              deadline_aware=deadline_aware)
        out = []
        for now, linger, oldest, ewma in cases:
            b._service_ewma_s = ewma
            out.append(b._close_at(now, linger, oldest))
        got[pkg] = out
    assert got["port"] == got["jax"]


def test_service_ewma_feeds_from_completions():
    b = pbatcher.MicroBatcher(FakeEngine(delay_s=0.02), metrics=pmetrics.ServingMetrics(),
                              linger_ms=0.0, adaptive_linger=False).start()
    assert b._service_ewma_s is None
    b.submit(_rows(1)).result()
    deadline = time.perf_counter() + 2.0
    while b._service_ewma_s is None and time.perf_counter() < deadline:
        time.sleep(0.005)
    assert b._service_ewma_s >= 0.015
    b.stop()


def test_oldest_deadline_closes_the_batch_before_the_linger():
    aware = pbatcher.MicroBatcher(FakeEngine(), metrics=pmetrics.ServingMetrics(),
                                  linger_ms=700.0, adaptive_linger=False,
                                  deadline_aware=True).start()
    t0 = time.perf_counter()
    assert aware.submit(_rows(1), timeout_ms=150.0).result().shape == (1, 10)
    assert time.perf_counter() - t0 < 0.5
    aware.stop()
    blind = pbatcher.MicroBatcher(FakeEngine(), metrics=pmetrics.ServingMetrics(),
                                  linger_ms=700.0, adaptive_linger=False,
                                  deadline_aware=False).start()
    with pytest.raises(pbatcher.RequestTimeout):
        blind.submit(_rows(1), timeout_ms=150.0).result(grace_s=0.05)
    blind.stop()


# -- batches, segments, splits ------------------------------------------------------


@pytest.mark.parametrize(
    "buckets, packed, max_rows, seed",
    [((8,), True, 6, 0), ((8,), True, 8, 1), ((16,), True, 11, 2),
     ((1, 2, 4, 8), False, 5, 3), ((1, 2, 4, 8, 16), False, 16, 4)],
    ids=["packed8", "packed8_full_rows", "packed16", "bucketed8", "bucketed16"],
)
def test_batches_and_segments_equal_jax(buckets, packed, max_rows, seed):
    arrivals = _arrivals(seed, 40, max_rows)
    kwargs = dict(linger_ms=1.0, fill_wait_ms=1.0)
    jax_launches, jax_results = _run_batcher("jax", arrivals, buckets, packed, **kwargs)
    port_launches, port_results = _run_batcher("port", arrivals, buckets, packed, **kwargs)
    assert port_launches == jax_launches
    for i, ((n, _, _), got, want) in enumerate(zip(arrivals, port_results, jax_results)):
        np.testing.assert_array_equal(got, want)
        assert (got[:, 0] == i + 1).all() and (got[:, 1] == np.arange(n)).all()
    if packed:  # some request was split across two batches
        tags = [set(t) - {0.0} for *_, t, _ in port_launches]
        assert any(a & b for a, b in zip(tags, tags[1:]))


def test_a_split_request_is_reassembled_in_row_order():
    arrivals = [(5, "f32", "interactive"), (7, "f32", "interactive")]  # 5 + 3 | 4
    launches, results = _run_batcher("port", arrivals, (8,), True, linger_ms=1.0)
    assert [(n, seg) for n, _, _, seg, _, _ in launches] == [
        (8, [0] * 5 + [1] * 3), (4, [0] * 4 + [-1] * 4)]
    assert launches[1][5][:4] == [3.0, 4.0, 5.0, 6.0]  # the remainder's rows
    np.testing.assert_array_equal(results[1][:, 1], np.arange(7))


# -- admission under pressure ----------------------------------------------------------


def test_full_queue_sheds_the_lowest_class_newest_first():
    metrics, sink = pmetrics.ServingMetrics(), _ListSink()
    b = pbatcher.MicroBatcher(FakeEngine(), metrics=metrics, queue_depth=4, linger_ms=0.0,
                              adaptive_linger=False, sink=sink)
    batch = [b.submit(_rows(1), qos="batch") for _ in range(4)]  # not started
    with pytest.raises(pbatcher.RejectedError, match="queue full"):
        b.submit(_rows(1), qos="batch")
    inter = b.submit(_rows(1), qos="interactive")
    assert inter.qos == "interactive"
    with pytest.raises(pbatcher.RejectedError, match="shed under pressure"):
        batch[-1].result(grace_s=0.05)
    assert not any(r.done() for r in batch[:-1])
    snap = metrics.snapshot()
    assert snap["qos"]["batch"]["shed"] == 1 and metrics.admitted == 5
    assert [e["qos"] for e in sink.of("qos_shed")] == ["batch"]
    with pytest.raises(pbatcher.RejectedError, match="unknown QoS class"):
        b.submit(_rows(1), qos="premium")
    b.stop(drain=False)


def test_an_arrival_sheds_again_when_a_concurrent_one_took_the_slot():
    b = pbatcher.MicroBatcher(FakeEngine(), metrics=pmetrics.ServingMetrics(), queue_depth=2)
    batch = [b.submit(_rows(1), qos="batch") for _ in range(2)]
    real_shed = b._shed

    def shed_and_lose_the_slot(victim):
        real_shed(victim)
        b._shed = real_shed
        b._queue.put_nowait(pbatcher.PendingRequest(_rows(1), time.perf_counter() + 9,
                                                    qos="interactive"))

    b._shed = shed_and_lose_the_slot
    req = b.submit(_rows(1), qos="interactive")  # sheds both batch requests
    assert all(r.done() for r in batch) and not req.done()
    b.stop(drain=False)


def test_expired_requests_leave_the_queue_before_anything_is_shed():
    metrics, expiries = pmetrics.ServingMetrics(), []
    b = pbatcher.MicroBatcher(FakeEngine(), metrics=metrics, queue_depth=3, linger_ms=0.0,
                              adaptive_linger=False)
    b.on_expire = expiries.append
    stale = [b.submit(_rows(1), timeout_ms=10.0) for _ in range(3)]
    time.sleep(0.03)
    fresh = b.submit(_rows(1), qos="batch", timeout_ms=1000.0)
    assert not fresh.done() and expiries == [1, 1, 1] and metrics.timed_out == 3
    for req in stale:
        with pytest.raises(pbatcher.RequestTimeout):
            req.result(grace_s=0.0)
    assert metrics.snapshot()["qos"]["batch"]["shed"] == 0
    b.stop(drain=False)


def test_weighted_dequeue_lets_interactive_overtake_a_batch_backlog():
    engine = FakeEngine(buckets=(1,))
    b = pbatcher.MicroBatcher(engine, metrics=pmetrics.ServingMetrics(), linger_ms=0.0,
                              adaptive_linger=False, max_inflight=1)
    reqs = [b.submit(_rows(1, tag=1), qos="batch") for _ in range(8)]
    reqs += [b.submit(_rows(1, tag=2), qos="interactive") for _ in range(8)]
    b.start()
    for r in reqs:
        r.result()
    b.stop()
    tags = [int(t[0]) for *_, t, _ in engine.launches]
    assert tags == [2] * 4 + [1] + [2] * 4 + [1] * 7


# -- fault points, spans, events, heartbeat ---------------------------------------------


@pytest.mark.parametrize("site", ["launch", "complete"])
def test_a_fault_fails_only_the_batch_it_hits(site):
    metrics, beats = pmetrics.ServingMetrics(), []
    b = pbatcher.MicroBatcher(FakeEngine(), metrics=metrics, linger_ms=0.0,
                              adaptive_linger=False, heartbeat=lambda: beats.append(1)).start()
    with faults.injected(f"fail:{site}:count=1") as injector:
        with pytest.raises(faults.FaultError, match=f"injected fail at {site}"):
            b.submit(_rows(2)).result()
        assert b.submit(_rows(3)).result().shape == (3, 10)
    assert injector.fired_counts() == {f"fail:{site}:count=1": 1}
    assert metrics.failed == 1 and metrics.completed == 1 and beats
    b.stop()


def test_the_sink_gets_spans_and_request_and_batch_events():
    sink, metrics = _ListSink(), pmetrics.ServingMetrics()
    engine = FakeEngine(packed=True)
    b = pbatcher.MicroBatcher(engine, metrics=metrics, sink=sink, linger_ms=0.0,
                              adaptive_linger=False).start()
    b.submit(_rows(3), qos="batch").result()
    b.submit(_rows(2), dtype="int8").result()
    b.stop()
    spans = [e["span"] for e in sink.of("span_end")]
    assert spans.count("serving_pad") == spans.count("serving_dispatch") == 2
    assert spans.count("serving_complete") == 2
    requests = sink.of("serving_request")
    assert [(e["n"], e["dtype"], e.get("qos")) for e in requests] == [
        (3, "f32", "batch"), (2, "int8", None)]
    batches = sink.of("serving_batch")
    assert [(e["real"], e["bucket"], e["dtype"], e["packed"]) for e in batches] == [
        (3, 8, "f32", True), (2, 8, "int8", True)]


# -- the binary wire ----------------------------------------------------------------


WIRE_CASES = [
    dict(),
    dict(dtype="int8", qos="batch"),
    dict(dtype="bf16", qos="interactive", normalized=True, deadline_ms=250.0),
    dict(deadline_ms=0.4, model="mnist"),
    dict(model="mnist", version="v2"),
    dict(version="v10", dtype="int8"),
]


@pytest.mark.parametrize("case", WIRE_CASES, ids=[str(i) for i in range(len(WIRE_CASES))])
@pytest.mark.parametrize("shape", ["flat", "28x28", "28x28x1"])
def test_wire_request_bytes_equal_jax_both_ways(case, shape):
    rs = np.random.RandomState(len(str(case)))
    x = rs.uniform(0, 255, (3, 28, 28)).astype(np.float32)
    x = {"flat": x.reshape(3, -1), "28x28": x, "28x28x1": x[..., None]}[shape]
    body = pwire.encode_request(x, **case)
    assert body == jwire.encode_request(x, **case)
    for decode in (pwire.decode_request, jwire.decode_request):
        req = decode(body)
        np.testing.assert_array_equal(req.rows, x.reshape(3, -1))
        assert (req.dtype, req.qos, req.normalized, req.model, req.version) == (
            case.get("dtype", "f32"), case.get("qos"), case.get("normalized", False),
            case.get("model"), case.get("version"))
    port = pwire.decode_request(body)
    np.testing.assert_array_equal(pwire.to_model_input(port),
                                  jwire.to_model_input(jwire.decode_request(body)))
    assert not port.rows.flags.owndata  # a view into the body


def test_wire_response_bytes_equal_jax_both_ways():
    logits = np.random.RandomState(1).randn(5, 10).astype(np.float32)
    body = pwire.encode_response(logits)
    assert body == jwire.encode_response(logits)
    np.testing.assert_array_equal(pwire.decode_response(body), logits)
    np.testing.assert_array_equal(jwire.decode_response(body), logits)


def _malformed():
    good = jwire.encode_request(np.zeros((2, 784), np.float32))
    ext = jwire.encode_request(np.zeros((1, 784), np.float32), model="m", version="v")
    return {
        "short": good[:10],
        "magic": b"XXXX" + good[4:],
        "header_size": good[:4] + (20).to_bytes(2, "little") + good[6:],
        "flags": good[:6] + (6).to_bytes(2, "little") + good[8:],
        "reserved": good[:18] + (1).to_bytes(2, "little") + good[20:],
        "row_elems": good[:12] + (783).to_bytes(4, "little") + good[16:],
        "count": good[:8] + (0).to_bytes(4, "little") + good[12:],
        "truncated": good[:-4],
        "dtype_code": good[:16] + bytes([9]) + good[17:],
        "qos_code": good[:17] + bytes([7]) + good[18:],
        "ext_overrun": ext[:24] + (200).to_bytes(2, "little") + ext[26:],
        "ext_utf8": ext[:28] + b"\xff" + ext[29:],
    }


@pytest.mark.parametrize("name", sorted(_malformed()))
def test_wire_rejects_what_jax_rejects_with_its_message(name):
    body = _malformed()[name]
    with pytest.raises(jwire.WireError) as want:
        jwire.decode_request(body)
    with pytest.raises(pwire.WireError) as got:
        pwire.decode_request(body)
    assert str(got.value) == str(want.value)
    assert isinstance(got.value, ValueError)  # the server's 400


@pytest.mark.parametrize("kwargs", [dict(dtype="fp8"), dict(qos="premium"),
                                    dict(deadline_ms=-1.0), dict(deadline_ms=2.0**32)])
def test_wire_encode_refuses_what_jax_refuses(kwargs):
    x = np.zeros((1, 784), np.float32)
    with pytest.raises(jwire.WireError) as want:
        jwire.encode_request(x, **kwargs)
    with pytest.raises(pwire.WireError) as got:
        pwire.encode_request(x, **kwargs)
    assert str(got.value) == str(want.value)


# -- the response cache ----------------------------------------------------------------


def _cache_script(mod, metrics):
    """One fixed sequence of cache operations; the outcomes it saw."""
    c = mod.ResponseCache(2, model_digest="w1", metrics=metrics)
    log = []
    k = [c.key(np.full(4, i, np.float32).data, dtype="f32") for i in range(4)]
    assert k[0] == c.key(np.full(4, 0, np.float32).data, dtype="f32")
    assert k[0] != c.key(np.full(4, 0, np.float32).data, dtype="int8")
    out, f0 = c.claim(k[0])
    log.append(out)
    out, j0 = c.claim(k[0])
    log.append(out)
    assert j0 is f0
    c.complete(k[0], f0, "v0")
    log.append((c.claim(k[0])[0], j0.result(0.1)))
    for key in k[1:3]:  # two more fills evict k[0] (capacity 2)
        _, f = c.claim(key)
        c.complete(key, f, key[-1])
    log.append(c.claim(k[0])[0])  # a miss: evicted, and now claimed again
    _, f3 = c.claim(k[3])
    _, j3 = c.claim(k[3])
    c.fail(k[3], f3, RuntimeError("dispatch died"))
    with pytest.raises(RuntimeError, match="dispatch died"):
        j3.result(0.1)
    log.append(c.claim(k[3])[0])  # never cached: a miss again
    kg = c.key(b"g")
    _, f4 = c.claim(kg)
    with pytest.raises(mod.FlightTimeout):
        c.claim(kg)[1].result(0.01)
    c.invalidate("w2")
    c.complete(kg, f4, "stale")  # a fill racing the swap loses
    log.append(c.claim(kg)[0])
    log.append(c.claim(c.key(b"g"))[0])
    log.append(c.key(b"x")[:3])
    log.append(c.stats())
    return log


def test_cache_single_flight_and_failure_semantics_equal_jax():
    logs, snaps = {}, {}
    for pkg, mod, mmod in (("jax", jcache, jmetrics), ("port", pcache, pmetrics)):
        metrics = mmod.ServingMetrics()
        logs[pkg] = _cache_script(mod, metrics)
        snaps[pkg] = metrics.snapshot()["cache"]
    assert logs["port"] == logs["jax"]
    assert logs["port"][:3] == ["miss", "coalesced", ("hit", "v0")]
    assert snaps["port"] == snaps["jax"]
    assert pcache.payload_digest(b"ab", b"c") == jcache.payload_digest(b"ab", b"c")


# -- the circuit breaker and the canary assignment --------------------------------------


def test_circuit_transitions_equal_jax():
    rs = np.random.RandomState(4)
    script = rs.choice(["ok", "fail", "acquire", "release", "half_open", "allows"], 300)
    traces = {}
    for pkg, mod, mmod in (("jax", jcircuit, jmetrics), ("port", pcircuit, pmetrics)):
        metrics, sink = mmod.ServingMetrics(), _ListSink()
        br = mod.CircuitBreaker("canary:m@v2", failure_threshold=3, trial_limit=2,
                                trial_successes=2, registry=metrics.registry, sink=sink)
        trace = []
        for op in script:
            result = {"ok": br.record_success, "fail": br.record_failure,
                      "acquire": br.try_acquire, "release": br.release,
                      "half_open": br.half_open, "allows": br.allows}[op]()
            trace.append((br.state, result))
        traces[pkg] = (trace, [(e["src"], e["dst"], e.get("reason")) for e in
                               sink.of("circuit_transition")],
                       metrics.registry.gauge("serving_circuit_state", replica="canary:m@v2").value)
    assert traces["port"] == traces["jax"]
    assert {s for s, _ in traces["port"][0]} == {"closed", "open", "half-open"}


def test_canary_assignment_equals_jax_over_1000_payloads():
    rs = np.random.RandomState(5)
    payloads = [rs.bytes(int(rs.randint(1, 4000))) for _ in range(1000)]
    for pct, seed in ((25.0, prollout.CANARY_SEED), (5.0, 7), (100.0, 1), (0.0, 2)):
        port = [prollout.canary_assignment(p, pct, seed) for p in payloads]
        assert port == [jrollout.canary_assignment(p, pct, seed) for p in payloads]
    picked = sum(prollout.canary_assignment(p, 25.0) for p in payloads)
    assert 200 < picked < 300
    grown = [prollout.canary_assignment(p, 50.0) for p in payloads]
    assert all(g for p, g in zip(payloads, grown) if prollout.canary_assignment(p, 25.0))


# -- the metrics' tail surfaces ------------------------------------------------------------


def test_snapshot_report_and_exposition_carry_the_tail_surfaces():
    metrics = pmetrics.ServingMetrics()
    for name in pqos.QOS_CLASSES:
        metrics.ensure_qos(name)
    metrics.ensure_wire()
    metrics.record_completed(0.010, dtype="f32", qos="interactive")
    metrics.record_completed(0.050, dtype="int8", qos="batch")
    metrics.record_shed("batch")
    metrics.record_wire("binary", bytes_in=3160, bytes_out=56)
    metrics.record_cache("hit")
    metrics.record_cache("miss")
    metrics.record_model_request("mnist", "v2", 0.02)
    snap = metrics.snapshot(linger_ms=1.5, inflight=0, max_inflight=2)
    assert snap["qos"]["batch"]["shed"] == 1
    assert snap["qos"]["interactive"]["p99_ms"] == pytest.approx(10.0)
    assert snap["cache"] == {"coalesced": 0, "hit": 1, "miss": 1, "hit_rate": 0.5}
    assert snap["wire"] == {"requests": {"binary": 1, "json": 0},
                            "bytes": {"in": 3160, "out": 56}}
    assert snap["pipeline"]["linger_ms"] == 1.5
    report = metrics.report_lines(linger_ms=1.5, inflight=0, max_inflight=2)
    assert "qos [interactive]: 1 ok, 0 shed" in report
    assert "cache: 1 hit / 1 miss / 0 coalesced (hit rate 50.0%)" in report
    assert "wire: 1 binary / 0 json requests, 3160 B in / 56 B out" in report
    assert "linger 1.50 ms" in report
    prom = render_prometheus(metrics.registry)
    for line in ('serving_qos_requests_total{qos="interactive"} 1',
                 'serving_shed_total{qos="batch"} 1',
                 'serving_wire_requests_total{format="binary"} 1',
                 'serving_wire_bytes_total{direction="in"} 3160',
                 'serving_cache_total{outcome="hit"} 1',
                 'serving_model_requests_total{model="mnist",version="v2"} 1'):
        assert line in prom, line


def test_metric_families_and_labels_are_the_jax_ones():
    names = {}
    for pkg, mmod, render in (("jax", jmetrics, jax_render), ("port", pmetrics,
                                                                render_prometheus)):
        metrics = mmod.ServingMetrics()
        for name in ("interactive", "batch"):
            metrics.ensure_qos(name)
        metrics.ensure_wire()
        metrics.ensure_cache()
        metrics.ensure_model("mnist", "v1")
        metrics.record_completed(0.01, dtype="bf16", qos="batch")
        metrics.record_shed("interactive")
        names[pkg] = {line.split(" ")[0] for line in render(metrics.registry)
                      .splitlines() if line and not line.startswith("#")}
    assert names["port"] <= names["jax"]
    assert sorted(n for n in names["jax"] - names["port"]
                  if not n.startswith(("lock_", "serving_request_retries"))) == []
