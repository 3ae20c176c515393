"""The serving fleet (serving/fleet.py) against the JAX package's on the CPU.

- Behaviour: each test of tests/test_fleet.py, run against both packages'
  fleets over their own fake backends (``[jax]`` / ``[port]``).
- Parity on the same numpy-seeded inputs: the router's placement orders
  under each policy, the autoscaler's scale events, the supervisor's
  backoff delays and ejection, ``backend_argv``, the snapshot's keys and
  the ``fleet_*`` Prometheus families.
- End to end: each package's front over its own in-process server, on
  seed-1 weights carried across (``utils/convert.py``); 16 seeded requests
  in JSON and on the binary wire, f32 and int8 (f32 within 1e-5 with the
  same argmax, int8 within 5e-4), each front answer the bytes of its
  backend's direct answer; the front cache's hits and single flight.
- The CLI: ``--fleet 2 --device cpu`` with torch and jax poisoned in the
  front process; one backend SIGKILLed under a closed-loop drive.
"""

from __future__ import annotations

import json
import os
import pathlib
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu.obs.export import render_prometheus as jax_render
from pytorch_mnist_ddp_tpu.serving import circuit as jax_circuit
from pytorch_mnist_ddp_tpu.serving import fleet as jax_fleet
from pytorch_mnist_ddp_tpu.serving import metrics as jax_metrics
from pytorch_mnist_ddp_tpu.serving import wire as jax_wire
from pytorch_mnist_ddp_tpu_torch.obs.export import render_prometheus as port_render
from pytorch_mnist_ddp_tpu_torch.serving import circuit as port_circuit
from pytorch_mnist_ddp_tpu_torch.serving import fleet as port_fleet
from pytorch_mnist_ddp_tpu_torch.serving import metrics as port_metrics
from pytorch_mnist_ddp_tpu_torch.serving import wire as port_wire

pytestmark = pytest.mark.fleet

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKGS = {
    "jax": SimpleNamespace(fleet=jax_fleet, metrics=jax_metrics, circuit=jax_circuit,
                           wire=jax_wire, render=jax_render, package="pytorch_mnist_ddp_tpu",
                           free_of=("jax",)),
    "port": SimpleNamespace(fleet=port_fleet, metrics=port_metrics, circuit=port_circuit,
                            wire=port_wire, render=port_render,
                            package="pytorch_mnist_ddp_tpu_torch", free_of=("torch", "jax")),
}
F32_TOL, INT8_TOL = 1e-5, 5e-4
BODY = json.dumps({"instances": [[0.0] * 784], "normalized": True}).encode()

# Compressed supervision for interactive-speed incident drills.
FAST_SUPERVISOR = dict(
    interval_s=0.02, probe_timeout_s=0.5, probe_failures=3,
    backoff_base_s=0.02, backoff_max_s=0.1, grace_s=1.0,
    ready_timeout_s=10.0,
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def _stop_backend(backend, grace_s: float) -> None:
    """``backend.stop``, its fake's accept loop woken by connections until
    it has seen the shutdown (it polls for it twice a second)."""
    stopping = threading.Thread(target=backend.stop, args=(grace_s,))
    stopping.start()
    while stopping.is_alive():
        try:
            socket.create_connection((backend.host, backend.port), timeout=0.1).close()
        except OSError:
            pass
        stopping.join(0.01)


def stop_fleet(fleet) -> None:
    """``Fleet.stop`` with the backends stopped together: the control
    loops first, as ``Fleet.stop`` orders it, then every backend at once."""
    for loop in (fleet.autoscaler, fleet.supervisor):
        if loop is not None:
            loop.stop()
    fleet.autoscaler = fleet.supervisor = None
    backends = fleet.backends_snapshot() + list(fleet.retired)
    if backends:
        with ThreadPoolExecutor(len(backends)) as pool:
            list(pool.map(lambda b: _stop_backend(b, fleet.grace_s), backends))
    fleet.stop()


def spin_fleet(pkg, n, service_s=0.005, supervise=False, supervisor_kwargs=None,
               heartbeat_dir=None, **fleet_kwargs):
    fakes = {}
    spawn = pkg.fleet.fake_backend_spawner(
        service_s=service_s, registry=fakes, heartbeat_dir=heartbeat_dir,
    )
    fleet = pkg.fleet.Fleet(spawn, poll_s=0.05, default_timeout_s=5.0, grace_s=1.0,
                            **fleet_kwargs)
    fleet.start(n, wait_ready_s=10.0, supervise=supervise,
                supervisor_kwargs={**FAST_SUPERVISOR, **(supervisor_kwargs or {})})
    return fleet, fakes


def drive(fleet, requests, concurrency=8, timeout_s=10.0, body=BODY):
    """Closed-loop drive straight into the front router (saturating: wall
    time measures fleet capacity, not an arrival schedule)."""
    results = []
    lock = threading.Lock()
    cursor = [0]

    def worker():
        while True:
            with lock:
                if cursor[0] >= requests:
                    return
                cursor[0] += 1
            status, _data, _ctype = fleet.router.submit(body, timeout_s=timeout_s)
            with lock:
                results.append(status)

    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, time.perf_counter() - t0


def wait_for(predicate, timeout_s=10.0, interval_s=0.02):
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        if predicate():
            return True
        time.sleep(interval_s)
    return False


def restarts(fleet, name):
    return fleet.metrics.registry.counter("fleet_backend_restarts_total", backend=name).value


# ---------------------------------------------------------------------------
# Behaviour: tests/test_fleet.py, both packages


def test_roundrobin_spreads_evenly(pkg):
    fleet, _fakes = spin_fleet(pkg, 3, policy="roundrobin")
    try:
        for _ in range(30):
            status, _data, _ctype = fleet.router.submit(BODY)
            assert status == 200
        counts = [fleet.metrics.registry.counter("fleet_route_decisions_total",
                                                 backend=f"b{i}").value for i in range(3)]
        assert counts == [10, 10, 10]
    finally:
        stop_fleet(fleet)


def test_least_loaded_avoids_the_backlogged_backend(pkg):
    fleet, _fakes = spin_fleet(pkg, 2, policy="least-loaded")
    try:
        fleet.backend("b0").polled_depth = 50
        placed = [fleet.router._order(fleet.active_backends())[0].name for _ in range(6)]
        assert set(placed) == {"b1"}
    finally:
        stop_fleet(fleet)


def test_cost_policy_prefers_the_faster_backend(pkg):
    fleet, _fakes = spin_fleet(pkg, 2, policy="cost")
    try:
        fleet.backend("b0").observe_latency(0.5)
        fleet.backend("b1").observe_latency(0.01)
        assert fleet.router._order(fleet.active_backends())[0].name == "b1"
    finally:
        stop_fleet(fleet)


def test_front_http_surface_proxies_and_reports(pkg):
    fleet, _fakes = spin_fleet(pkg, 2)
    server = pkg.fleet.make_fleet_server(fleet, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        req = urllib.request.Request(url + "/predict", data=BODY,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=5) as resp:
            assert resp.status == 200
            assert json.load(resp)["predictions"] == [0]
        with urllib.request.urlopen(url + "/readyz", timeout=5) as resp:
            assert resp.status == 200
        with urllib.request.urlopen(url + "/metrics", timeout=5) as resp:
            snap = json.load(resp)
        assert set(snap["backends"]) == {"b0", "b1"}
        assert snap["fleet"]["routable"] == 2
        assert snap["compiles"] == 4  # 2 cold fakes x 2 buckets
        with urllib.request.urlopen(url + "/metrics?format=prom", timeout=5) as resp:
            assert 'fleet_backends{state="active"} 2' in resp.read().decode()
        with urllib.request.urlopen(url + "/healthz", timeout=5) as resp:
            assert json.load(resp)["backends"] == {"b0": "active", "b1": "active"}
    finally:
        server.shutdown()
        server.server_close()
        stop_fleet(fleet)


def test_breaker_trips_on_backend_500s_and_routes_away(pkg):
    fleet, fakes = spin_fleet(pkg, 2, failure_threshold=3)
    try:
        fakes["b0"].fail_predict = True
        statuses = [fleet.router.submit(BODY)[0] for _ in range(20)]
        assert statuses.count(500) <= 3
        assert statuses.count(200) >= 17
        assert fleet.backend("b0").breaker.state == "open"
        assert fleet.routable_count() == 1
    finally:
        stop_fleet(fleet)


def test_supervisor_replaces_tripped_backend_and_half_open_heals(pkg):
    fleet, fakes = spin_fleet(pkg, 2, supervise=True, failure_threshold=2)
    try:
        fakes["b0"].fail_predict = True
        for _ in range(4):
            fleet.router.submit(BODY)
        assert wait_for(lambda: restarts(fleet, "b0") >= 1)
        assert wait_for(lambda: fleet.backend("b0").state == pkg.fleet.ACTIVE)
        assert fleet.backend("b0").breaker.state in ("half-open", "closed")
        assert wait_for(lambda: [fleet.router.submit(BODY)[0] for _ in range(3)]
                        and fleet.backend("b0").breaker.state == "closed")
    finally:
        stop_fleet(fleet)


def test_backend_504_is_not_a_breaker_failure(pkg):
    fleet, _fakes = spin_fleet(pkg, 1, failure_threshold=2)
    try:
        backend = fleet.backend("b0")
        backend.request_full = lambda *a, **k: (504, b'{"error": "deadline"}',
                                                "application/json")
        for _ in range(5):
            assert fleet.router.submit(BODY)[0] == 504
        assert backend.breaker.state == "closed"
        assert fleet.metrics.timed_out == 5
        assert fleet.metrics.failed == 0
    finally:
        stop_fleet(fleet)


def test_stale_pooled_keepalive_retries_on_a_fresh_connection(pkg):
    """A keep-alive the backend closed while it sat in the pool is retried
    once on a fresh connection, not surfaced as a transport error."""
    fake = pkg.fleet.FakeBackendServer(name="s", service_s=0.0)
    backend = pkg.fleet.Backend("s", "127.0.0.1", fake.port)
    listener = socket.socket()
    try:
        status, _data = backend.request("GET", "/readyz", timeout_s=2.0)
        assert status == 200 and backend._idle  # a pooled keep-alive
        listener.bind(("127.0.0.1", 0))
        listener.listen(1)
        dead = socket.create_connection(listener.getsockname(), timeout=2.0)
        server_side, _addr = listener.accept()
        server_side.close()  # FIN
        backend._idle[0].sock.close()
        backend._idle[0].sock = dead
        status, _data = backend.request("GET", "/readyz", timeout_s=2.0)
        assert status == 200
    finally:
        listener.close()
        backend.close_connections()
        fake.shutdown()


def test_read_timeout_is_not_retried_as_stale(pkg):
    fake = pkg.fleet.FakeBackendServer(name="t", service_s=0.5)
    backend = pkg.fleet.Backend("t", "127.0.0.1", fake.port)
    try:
        status, _data = backend.request("GET", "/readyz", timeout_s=2.0)
        assert status == 200
        t0 = time.perf_counter()
        with pytest.raises(TimeoutError):
            backend.request("POST", "/predict", BODY, timeout_s=0.15)
        assert time.perf_counter() - t0 < 0.4  # one attempt, not two
    finally:
        backend.close_connections()
        fake.shutdown()


def test_fleet_front_surface_is_free_of_what_it_supervises(pkg):
    """``from <package>.serving import Fleet, ...`` in a fresh interpreter
    imports neither jax (both packages) nor torch (the port)."""
    code = (
        "import sys\n"
        f"from {pkg.package}.serving import Fleet, FleetRouter, FleetSupervisor, "
        "FleetAutoscaler, fake_backend_spawner\n"
        f"loaded = [m for m in {pkg.free_of!r} if m in sys.modules]\n"
        "assert not loaded, loaded\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT, timeout=60)


def test_exactly_one_503_on_fleet_wide_outage(pkg):
    fleet, _fakes = spin_fleet(pkg, 2)
    try:
        for b in fleet.backends_snapshot():
            fleet.set_state(b, pkg.fleet.EJECTED)
        before = fleet.metrics.rejected
        status, data, _ctype = fleet.router.submit(BODY)
        assert status == 503 and b"no active backends" in data
        assert fleet.metrics.rejected == before + 1
    finally:
        stop_fleet(fleet)


def test_transport_failure_retries_on_surviving_backend(pkg):
    fleet, fakes = spin_fleet(pkg, 2, policy="roundrobin")
    try:
        fakes["b1"].kill()  # the router still believes b1 is active
        assert [fleet.router.submit(BODY)[0] for _ in range(8)] == [200] * 8
    finally:
        stop_fleet(fleet)


def test_kill_replace_warm_start_zero_new_compiles(pkg):
    fleet, fakes = spin_fleet(pkg, 3, supervise=True)
    try:
        assert fleet.snapshot()["backends"]["b1"]["compiles"] == 2  # cold
        fakes["b1"].kill()
        assert wait_for(lambda: fleet.backend("b1").state == pkg.fleet.ACTIVE
                        and fleet.backend("b1").proc.poll() is None)
        snap = fleet.snapshot()
        assert snap["backends"]["b1"]["compiles"] == 0  # warm off the store
        assert restarts(fleet, "b1") == 1
        assert snap["fleet"]["supervisor"]["restarts_total"] == 1
        assert fleet.router.submit(BODY)[0] == 200
    finally:
        stop_fleet(fleet)


def test_kill_under_load_loses_nothing(pkg):
    fleet, fakes = spin_fleet(pkg, 3, supervise=True)
    try:
        killer = threading.Timer(0.1, fakes["b2"].kill)
        killer.start()
        results, _wall = drive(fleet, 120, concurrency=8)
        killer.join()
        assert len(results) == 120
        assert all(s == 200 for s in results), results
        assert wait_for(lambda: all(b.state == pkg.fleet.ACTIVE
                                    for b in fleet.backends_snapshot()))
    finally:
        stop_fleet(fleet)


def test_restart_budget_exhaustion_ejects(pkg):
    calls = {"n": 0}
    store: set = set()

    def dying_spawn(name):
        calls["n"] += 1
        fake = pkg.fleet.FakeBackendServer(name=name, service_s=0.001, warm_store=store)
        if calls["n"] > 1:
            fake.kill()  # every replacement is dead on arrival
        return pkg.fleet.Backend(name, "127.0.0.1", fake.port, proc=fake.proc)

    fleet = pkg.fleet.Fleet(dying_spawn, poll_s=0.05, grace_s=0.5)
    fleet.start(1, wait_ready_s=10.0, supervise=False)
    sup = pkg.fleet.FleetSupervisor(fleet, restart_budget=2, **FAST_SUPERVISOR)
    try:
        fleet.backend("b0").proc.kill()
        deadline = time.perf_counter() + 10.0
        while time.perf_counter() < deadline:
            sup.tick()
            if fleet.backend("b0").state == pkg.fleet.EJECTED:
                break
            time.sleep(0.01)
        assert fleet.backend("b0").state == pkg.fleet.EJECTED
        assert fleet.backend("b0").breaker.state == "open"
        assert sup._watch["b0"].attempts == 2  # the incident + 2 respawns
    finally:
        stop_fleet(fleet)


def test_heartbeat_hang_is_an_incident(pkg, tmp_path):
    fleet, fakes = spin_fleet(pkg, 2, supervise=True, heartbeat_dir=str(tmp_path),
                              supervisor_kwargs=dict(heartbeat_timeout_s=0.2))
    try:
        assert wait_for(lambda: fleet.backend("b0").heartbeat_age() is not None)
        fakes["b0"].stop_heartbeat()  # alive, answering HTTP, no longer beating
        assert wait_for(lambda: restarts(fleet, "b0") >= 1, timeout_s=15.0)
        assert fleet.backend("b0").state == pkg.fleet.ACTIVE
    finally:
        stop_fleet(fleet)


def test_autoscaler_scales_up_on_sustained_breach_only(pkg):
    fleet, _fakes = spin_fleet(pkg, 1)
    scaler = pkg.fleet.FleetAutoscaler(fleet, high_water=4.0, low_water=0.5, window_s=0.5,
                                       cooldown_s=0.2, min_backends=1, max_backends=3,
                                       alpha=1.0)
    try:
        t = 1000.0
        scaler.tick(now=t, raw=50.0)  # a single spike is not sustained
        scaler.tick(now=t + 0.1, raw=0.0)
        assert fleet.scalable_count() == 1
        for i in range(8):
            scaler.tick(now=t + 10 + 0.1 * i, raw=10.0)
        assert fleet.scalable_count() == 2
        assert fleet.metrics.registry.counter("fleet_scale_events_total",
                                              direction="up").value == 1
    finally:
        stop_fleet(fleet)


def test_autoscaler_no_flap_on_oscillating_signal(pkg):
    fleet, _fakes = spin_fleet(pkg, 2)
    scaler = pkg.fleet.FleetAutoscaler(fleet, high_water=4.0, low_water=0.5, window_s=0.3,
                                       cooldown_s=0.1, min_backends=1, max_backends=4,
                                       alpha=1.0)
    try:
        for i in range(50):
            scaler.tick(now=1000.0 + 0.1 * i, raw=3.5 if i % 2 else 1.0)
        assert fleet.scalable_count() == 2
        registry = fleet.metrics.registry
        assert registry.counter("fleet_scale_events_total", direction="up").value == 0
        assert registry.counter("fleet_scale_events_total", direction="down").value == 0
    finally:
        stop_fleet(fleet)


def test_autoscaler_drain_down_loses_nothing(pkg):
    fleet, _fakes = spin_fleet(pkg, 3, service_s=0.002)
    scaler = pkg.fleet.FleetAutoscaler(fleet, high_water=50.0, low_water=1.0, window_s=0.05,
                                       cooldown_s=0.05, min_backends=2, max_backends=3,
                                       alpha=1.0)
    try:
        results = []
        done = threading.Event()

        def pump():
            while not done.is_set():
                results.append(fleet.router.submit(BODY)[0])

        pumps = [threading.Thread(target=pump) for _ in range(4)]
        for p in pumps:
            p.start()
        for i in range(6):
            scaler.tick(now=1000.0 + 0.1 * i, raw=0.0)
        done.set()
        for p in pumps:
            p.join()
        assert fleet.scalable_count() == 2
        assert [b.name for b in fleet.retired] == ["b2"]
        assert results and all(s == 200 for s in results)
        assert fleet.metrics.registry.counter("fleet_scale_events_total",
                                              direction="down").value == 1
    finally:
        stop_fleet(fleet)


def test_autoscaler_respects_min_and_max_bounds(pkg):
    fleet, _fakes = spin_fleet(pkg, 1)
    scaler = pkg.fleet.FleetAutoscaler(fleet, high_water=4.0, low_water=0.5, window_s=0.1,
                                       cooldown_s=0.0, min_backends=1, max_backends=2,
                                       alpha=1.0)
    try:
        for i in range(20):
            scaler.tick(now=1000.0 + 0.1 * i, raw=100.0)
        assert fleet.scalable_count() == 2  # capped at max
        for i in range(20):
            scaler.tick(now=1050.0 + 0.1 * i, raw=0.0)
        assert fleet.scalable_count() == 1  # floored at min
    finally:
        stop_fleet(fleet)


def test_autoscaler_validates_watermarks(pkg):
    fleet, _fakes = spin_fleet(pkg, 1)
    try:
        with pytest.raises(ValueError, match="hysteresis"):
            pkg.fleet.FleetAutoscaler(fleet, high_water=2.0, low_water=2.0)
        with pytest.raises(ValueError, match="min_backends"):
            pkg.fleet.FleetAutoscaler(fleet, min_backends=3, max_backends=2)
    finally:
        stop_fleet(fleet)


def test_four_backends_beat_one_by_2p5x_wall(pkg):
    """With serial capacity a backend, 4 backends finish the same
    saturating closed-loop workload > 2.5x faster than 1."""
    walls = {}
    for n in (1, 4):
        fleet, _fakes = spin_fleet(pkg, n, service_s=0.05, policy="roundrobin")
        try:
            results, walls[n] = drive(fleet, 40, concurrency=12)
            assert all(s == 200 for s in results)
        finally:
            stop_fleet(fleet)
    assert walls[1] / walls[4] > 2.5, walls


def test_backend_argv_strips_fleet_flags(pkg):
    argv = ["--fleet", "4", "--autoscale", "--scale-high", "12", "--port", "8000",
            "--host", "0.0.0.0", "--buckets", "4,8", "--timeout-ms", "500",
            "--fleet-base-port=9000", "--telemetry-dir", "/tmp/t", "--aot-cache", "/tmp/aot"]
    assert pkg.fleet.backend_argv(argv) == ["--buckets", "4,8", "--timeout-ms", "500"]


def test_fleet_snapshot_shape(pkg):
    fleet, _fakes = spin_fleet(pkg, 2)
    try:
        snap = fleet.snapshot()
        assert snap["queue_depth"] == 0
        assert snap["fleet"]["policy"] == "cost"
        assert snap["fleet"]["autoscaler"] is None
        for name in ("b0", "b1"):
            entry = snap["backends"][name]
            assert entry["state"] == pkg.fleet.ACTIVE
            assert entry["circuit"] == "closed"
            assert entry["url"].startswith("http://127.0.0.1:")
    finally:
        stop_fleet(fleet)


def test_metrics_prom_exposition_carries_fleet_families(pkg):
    fleet, _fakes = spin_fleet(pkg, 1)
    try:
        fleet.router.submit(BODY)
        text = pkg.render(fleet.metrics.registry)
        assert 'fleet_backends{state="active"} 1' in text
        assert 'fleet_scale_events_total{direction="up"} 0' in text
        assert 'fleet_scale_events_total{direction="down"} 0' in text
        assert 'fleet_route_decisions_total{backend="b0"} 1' in text
        assert 'fleet_backend_restarts_total{backend="b0"} 0' in text
    finally:
        stop_fleet(fleet)


# ---------------------------------------------------------------------------
# Parity on the same seeded inputs


class _DeadProc:
    """A process handle that has already exited."""

    def poll(self):
        return 1

    def send_signal(self, signum):
        pass


class _Recorder:
    """An event sink that keeps what is emitted."""

    def __init__(self):
        self.events = []

    def __bool__(self):
        return True

    def emit(self, event, **fields):
        self.events.append((event, fields))


def _seeded_backends(pkg, rs, router_fleet):
    n = int(rs.randint(1, 6))
    backends = []
    for i in range(n):
        b = pkg.fleet.Backend(f"b{i}", "127.0.0.1", 1)
        b.polled_depth, b.polled_inflight, b.front_inflight = (
            int(rs.randint(0, 20)), int(rs.randint(0, 4)), int(rs.randint(0, 3)))
        latency = rs.randint(0, 3)
        if latency == 1:
            b.observe_latency(float(rs.uniform(0.001, 0.1)))
        elif latency == 2:
            b.polled_latency_ms = float(rs.uniform(1.0, 100.0))
        breaker = pkg.circuit.CircuitBreaker(b.name, registry=router_fleet.metrics.registry)
        state = ("closed", "open", "half-open")[rs.randint(0, 3)]
        if state != "closed":
            breaker.force_open("seeded")
        if state == "half-open":
            breaker.half_open()
        b.breaker = breaker
        backends.append(b)
    return backends


@pytest.mark.parametrize("policy", ["roundrobin", "least-loaded", "cost"])
def test_router_orders_equal_jax_over_seeded_states(policy):
    orders = {}
    for name, pkg in PKGS.items():
        rs = np.random.RandomState(17)
        fleet = pkg.fleet.Fleet(spawn=None, policy=policy)
        orders[name] = [[b.name for b in fleet.router._order(_seeded_backends(pkg, rs, fleet))]
                        for _ in range(200)]
    assert orders["port"] == orders["jax"]
    assert len({tuple(o) for o in orders["port"]}) > 20  # the states move the order


class _ScaleStub:
    """The autoscaler's view of a fleet: a backend count it moves."""

    def __init__(self, pkg, n):
        self.n = n
        self.metrics = pkg.metrics.ServingMetrics()
        self.sink = _Recorder()

    def scalable_count(self):
        return self.n

    def active_backends(self):
        return []

    def add_backend(self):
        self.n += 1

    def remove_backend(self, name=None):
        self.n -= 1


def test_autoscaler_scale_events_equal_jax_on_a_seeded_signal():
    raw = np.abs(np.cumsum(np.random.RandomState(3).normal(0.0, 2.5, 600)))
    timeline = {}
    for name, pkg in PKGS.items():
        stub = _ScaleStub(pkg, 2)
        scaler = pkg.fleet.FleetAutoscaler(stub, high_water=8.0, low_water=2.0,
                                           window_s=0.35, cooldown_s=0.55, min_backends=1,
                                           max_backends=5, alpha=0.4)
        counts = []
        for i, r in enumerate(raw):
            scaler.tick(now=1000.0 + 0.1 * i, raw=float(r))
            counts.append(stub.n)
        timeline[name] = (counts, stub.sink.events)
    assert timeline["port"] == timeline["jax"]
    directions = [f["direction"] for e, f in timeline["port"][1] if e == "fleet_scale"]
    assert "up" in directions and "down" in directions


def test_supervisor_backoff_and_ejection_equal_jax():
    delays = {name: [[pkg.fleet.FleetSupervisor(None, seed=seed)._ladder.delay_s(k)
                      for k in range(6)] for seed in range(5)]
              for name, pkg in PKGS.items()}
    assert delays["port"] == delays["jax"]
    ejected = {}
    for name, pkg in PKGS.items():
        ejected[name] = []
        for budget, seed in ((0, 0), (1, 1), (2, 2), (3, 3)):
            sink = _Recorder()
            spawn = lambda n, pkg=pkg: pkg.fleet.Backend(n, "127.0.0.1", 1, proc=_DeadProc())  # noqa: E731
            fleet = pkg.fleet.Fleet(spawn, sink=sink)
            fleet.set_state(fleet._spawn_next(), pkg.fleet.ACTIVE)
            sup = pkg.fleet.FleetSupervisor(fleet, restart_budget=budget, seed=seed,
                                            backoff_base_s=0.5, backoff_max_s=4.0)
            ticks = 0
            while fleet.backend("b0").state != pkg.fleet.EJECTED and ticks < 500:
                sup.tick(now=100.0 + 0.25 * ticks)
                ticks += 1
            ejected[name].append((ticks, sup._watch["b0"].attempts, sink.events))
    assert ejected["port"] == ejected["jax"]
    assert [attempts for _, attempts, _ in ejected["port"]] == [0, 1, 2, 3]


@pytest.mark.parametrize("argv", [
    ["--fleet", "2", "--device", "cpu", "--buckets", "1,2,4", "--dtypes", "f32,int8"],
    ["--fleet=3", "--autoscale", "--scale-min=1", "--scale-max", "3", "--seed", "12",
     "--aot-cache=/x", "--telemetry-dir", "t", "--response-cache", "64"],
    ["--port", "9000", "--host", "::", "--fleet-restart-budget", "0",
     "--fleet-heartbeat-timeout-s=0", "--fleet-ready-timeout-s", "30", "--scale-window-s",
     "1", "--scale-cooldown-s=2", "--scale-high", "4", "--scale-low=0.5", "--int8-impl",
     "pallas", "--router-policy", "least-loaded", "--replicas", "2"],
], ids=["cpu", "autoscale", "every_front_flag"])
def test_backend_argv_equals_jax(argv):
    assert port_fleet.backend_argv(argv) == jax_fleet.backend_argv(argv)


def _key_tree(value):
    if isinstance(value, dict):
        return {k: _key_tree(v) for k, v in value.items()}
    return None


def test_snapshot_keys_and_fleet_families_equal_jax():
    """The same drive through both packages' fleets of fakes: the front's
    /metrics JSON has the same keys, and the ``fleet_*`` Prometheus lines
    (help, type, labels and values) are the same."""
    trees, families = {}, {}
    for name, pkg in PKGS.items():
        fleet, fakes = spin_fleet(pkg, 3, supervise=True, policy="roundrobin",
                                  response_cache=4)
        try:
            for _ in range(9):
                assert fleet.router.submit(BODY)[0] == 200
            fakes["b2"].kill()
            assert wait_for(lambda: restarts(fleet, "b2") == 1
                            and fleet.backend("b2").state == pkg.fleet.ACTIVE)
            fleet.remove_backend("b1")
            trees[name] = _key_tree(fleet.snapshot())
            families[name] = sorted(
                line for line in pkg.render(fleet.metrics.registry).splitlines()
                if line.replace("# HELP ", "").replace("# TYPE ", "").startswith("fleet_"))
        finally:
            stop_fleet(fleet)
    assert trees["port"] == trees["jax"]
    assert families["port"] == families["jax"]
    assert 'fleet_backend_restarts_total{backend="b2"} 1' in families["port"]
    assert 'fleet_backends{state="retired"} 1' in families["port"]


# ---------------------------------------------------------------------------
# End to end: each package's front over its own in-process server


def _post(url, body, ctype="application/json"):
    req = urllib.request.Request(url, body, {"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read(), r.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers.get("Content-Type")


class _Front:
    """A started fleet of one backend at ``port`` (no spawn) and its
    front server."""

    def __init__(self, pkg, port, **fleet_kwargs):
        self.fleet = pkg.fleet.Fleet(lambda name: pkg.fleet.Backend(name, "127.0.0.1", port),
                                     poll_s=5.0, default_timeout_s=30.0, **fleet_kwargs)
        self.fleet.start(1, wait_ready_s=30.0, supervise=False)
        self.front = pkg.fleet.make_fleet_server(self.fleet, port=0)
        threading.Thread(target=self.front.serve_forever, daemon=True).start()
        self.url = f"http://127.0.0.1:{self.front.server_address[1]}"

    def close(self):
        self.front.shutdown()
        self.front.server_close()
        self.fleet.stop()


class _Served:
    """An engine's server and a front over it."""

    def __init__(self, pkg, make_server, engine, metrics):
        self.server = make_server(engine, metrics, linger_ms=0.0)
        threading.Thread(target=self.server.serve_forever, daemon=True).start()
        self.port = self.server.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self.front = _Front(pkg, self.port)

    def close(self):
        self.front.close()
        self.server.shutdown()
        self.server.batcher.stop(drain=True)
        self.server.server_close()


@pytest.fixture(scope="module")
def served():
    from pytorch_mnist_ddp_tpu.models.net import init_params
    from pytorch_mnist_ddp_tpu.parallel.mesh import make_mesh
    from pytorch_mnist_ddp_tpu.serving.engine import InferenceEngine as JaxEngine
    from pytorch_mnist_ddp_tpu.serving.server import make_server as jax_make_server
    from pytorch_mnist_ddp_tpu.utils.rng import root_key, split_streams
    from pytorch_mnist_ddp_tpu_torch.serving.engine import InferenceEngine
    from pytorch_mnist_ddp_tpu_torch.serving.server import make_server
    from pytorch_mnist_ddp_tpu_torch.utils.convert import torch_state_from_jax

    params = jax.device_get(init_params(split_streams(root_key(1))["init"]))
    jax_engine = JaxEngine({"params": params}, mesh=make_mesh(1, devices=jax.devices()[:1]),
                           buckets=(1, 2, 4), dtypes=("int8",))
    port_engine = InferenceEngine(torch_state_from_jax(params), device="cpu",
                                  buckets=(1, 2, 4), dtypes=("int8",))
    for engine in (jax_engine, port_engine):
        engine.warmup()
        assert engine.verify_parity()["int8"]["passed"]
    out = {"jax": _Served(PKGS["jax"], jax_make_server, jax_engine, jax_metrics.ServingMetrics()),
           "port": _Served(PKGS["port"], make_server, port_engine,
                           port_metrics.ServingMetrics())}
    yield out
    for s in out.values():
        s.close()


def _decode(pkg, body, ctype):
    if ctype.split(";")[0] == pkg.wire.WIRE_RESPONSE_TYPE:
        return pkg.wire.decode_response(body)
    return np.asarray(json.loads(body)["log_probs"], np.float32)


def test_fronts_answer_as_their_backends_and_as_each_other(served):
    """16 seeded requests of 1..4 rows, f32 and int8, JSON and binary
    wire: each front answer is its backend's direct answer byte for byte
    (content type too); the port's are within 1e-5 of JAX's in f32 with
    the same argmax, within 5e-4 in int8."""
    rs = np.random.RandomState(29)
    answers = {"jax": [], "port": []}
    kinds = []
    for i in range(16):
        rows = rs.randint(0, 256, (int(rs.randint(1, 5)), 28, 28)).astype(np.uint8)
        dtype = ("f32", "int8")[i % 2]
        binary = (i // 2) % 2 == 1
        kinds.append(dtype)
        for name, pkg in PKGS.items():
            if binary:
                body = pkg.wire.encode_request(rows.astype(np.float32), dtype=dtype)
                ctype = pkg.wire.WIRE_REQUEST_TYPE
            else:
                body = json.dumps({"instances": rows.reshape(len(rows), -1).tolist(),
                                   "dtype": dtype, "return_log_probs": True}).encode()
                ctype = "application/json"
            s = served[name]
            via_front = _post(s.front.url + "/predict", body, ctype)
            direct = _post(s.url + "/predict", body, ctype)
            assert via_front[0] == 200, (name, via_front)
            assert via_front == direct, (name, i)
            answers[name].append(_decode(pkg, via_front[1], via_front[2]))
    for dtype, got, want in zip(kinds, answers["port"], answers["jax"]):
        err = float(np.abs(got - want).max())
        assert err <= (F32_TOL if dtype == "f32" else INT8_TOL), (dtype, err)
        if dtype == "f32":
            assert (got.argmax(1) == want.argmax(1)).all()
    for name in PKGS:
        snap = served[name].front.fleet.metrics.snapshot()
        assert snap["wire"]["requests"] == {"binary": 8, "json": 8}
        assert snap["requests"]["completed"] == 16


def _recording_backend(gate: threading.Event):
    """A backend that answers fixed bytes under its own content type once
    ``gate`` is set, and records what reached it."""
    seen = []

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):
            pass

        def do_GET(self):  # noqa: N802
            body = b'{"status": "ready"}'
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):  # noqa: N802
            n = int(self.headers.get("Content-Length", 0))
            seen.append((self.rfile.read(n), self.headers.get("Content-Type")))
            gate.wait(10.0)
            body = b"\x01\x02raw-backend-reply\x03"
            self.send_response(200)
            self.send_header("Content-Type", "application/x-test-raw")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, seen


def test_front_cache_hits_and_coalesces(pkg, served):
    """As tests/test_hostpath.py holds the JAX front: a repeat body is a
    hit that never reaches the backend, the same bytes under another
    content type are another address, and concurrent identical bodies
    coalesce onto one proxied request; then the same over the real
    in-process server."""
    gate = threading.Event()
    httpd, seen = _recording_backend(gate)
    port = httpd.server_address[1]
    fleet = pkg.fleet.Fleet(lambda name: pkg.fleet.Backend(name, "127.0.0.1", port),
                            poll_s=5.0, response_cache=8, default_timeout_s=10.0)
    front = None
    try:
        fleet.start(1, wait_ready_s=10.0, supervise=False)
        front = pkg.fleet.make_fleet_server(fleet, port=0)
        threading.Thread(target=front.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{front.server_address[1]}/predict"
        body = b"identical-request-bytes"
        with ThreadPoolExecutor(4) as pool:
            flights = [pool.submit(_post, url, body, pkg.wire.WIRE_REQUEST_TYPE)
                       for _ in range(4)]
            assert wait_for(lambda: fleet.metrics.snapshot()["cache"]["coalesced"] == 3)
            gate.set()
            outcomes = [f.result() for f in flights]
        assert len(set(outcomes)) == 1 and outcomes[0][0] == 200
        assert outcomes[0][2].split(";")[0] == "application/x-test-raw"
        assert seen == [(body, pkg.wire.WIRE_REQUEST_TYPE)]
        assert _post(url, body, pkg.wire.WIRE_REQUEST_TYPE) == outcomes[0]  # a hit
        assert len(seen) == 1
        _post(url, body, "application/json")
        assert len(seen) == 2
        cache = fleet.metrics.snapshot()["cache"]
        assert (cache["hit"], cache["miss"], cache["coalesced"]) == (1, 2, 3)
    finally:
        gate.set()
        if front is not None:
            front.shutdown()
            front.server_close()
        fleet.stop()
        httpd.shutdown()
        httpd.server_close()
    s = served["jax" if pkg is PKGS["jax"] else "port"]
    cached = _Front(pkg, s.port, response_cache=8)
    try:
        raw = np.random.RandomState(31).randint(0, 256, (3, 28, 28)).astype(np.uint8)
        body = pkg.wire.encode_request(raw.astype(np.float32), dtype="int8")
        admitted = s.server.metrics.admitted
        first = _post(cached.url + "/predict", body, pkg.wire.WIRE_REQUEST_TYPE)
        again = _post(cached.url + "/predict", body, pkg.wire.WIRE_REQUEST_TYPE)
        assert first == again and first[0] == 200
        assert s.server.metrics.admitted == admitted + 1  # the hit never reached it
    finally:
        cached.close()


# ---------------------------------------------------------------------------
# The CLI: --fleet 2 --device cpu, the front poisoned against torch and jax

POISONED_FRONT = (
    "import sys\n"
    "for name in ('torch', 'jax', 'pytorch_mnist_ddp_tpu'):\n"
    "    sys.modules[name] = None  # any import of it raises\n"
    "from pytorch_mnist_ddp_tpu_torch.serving.__main__ import main\n"
    "sys.exit(main())\n"
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _free_backend_ports(k: int) -> int:
    """The first of ``k`` consecutive ports free now, below the ephemeral
    range: the backends bind them seconds later, and meanwhile any
    client connection on the host may take an ephemeral port as its
    source port."""
    low = int(pathlib.Path("/proc/sys/net/ipv4/ip_local_port_range").read_text().split()[0])
    for base in random.Random().sample(range(10000, low - k), 200):
        try:
            for p in range(base, base + k):
                with socket.socket() as s:
                    s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
    raise RuntimeError(f"no {k} consecutive free ports under {low}")


def _children(pid: int) -> dict[int, str]:
    """The processes whose parent is ``pid``: their command lines."""
    out = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            if ppid == pid:
                with open(f"/proc/{entry}/cmdline", "rb") as f:
                    out[int(entry)] = f.read().replace(b"\0", b" ").decode()
        except (OSError, ValueError, IndexError):
            continue
    return out


def test_cli_fleet_replaces_a_killed_backend_with_the_front_poisoned(tmp_path):
    """Two CPU backends behind a front that cannot import torch or jax; b1
    is SIGKILLed under 4 closed-loop clients.  Every request gets exactly
    one 200, b1 is replaced on its port (restarts 1, compiles 0), and
    SIGTERM drains the fleet with exit 0."""
    port, base = _free_port(), _free_backend_ports(2)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    tel = tmp_path / "tel"
    proc = subprocess.Popen(
        [sys.executable, "-c", POISONED_FRONT, "--fleet", "2", "--device", "cpu",
         "--buckets", "1,2,4", "--dtypes", "f32,int8", "--port", str(port),
         "--fleet-base-port", str(base), "--telemetry-dir", str(tel)],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, up = [], threading.Event()

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if line.startswith("fleet front on"):
                up.set()

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    url = f"http://127.0.0.1:{port}"
    try:
        assert up.wait(60.0), lines
        backends = {pid: cmd for pid, cmd in _children(proc.pid).items()
                    if "pytorch_mnist_ddp_tpu_torch.serving" in cmd}
        assert len(backends) == 2, backends
        [victim] = [pid for pid, cmd in backends.items() if f"--port {base + 1}" in cmd]
        rs = np.random.RandomState(7)
        bodies = [json.dumps({"instances": rs.randint(0, 256, (n, 784)).tolist(),
                              "dtype": dt}).encode()
                  for n, dt in zip(rs.randint(1, 5, 16), ["f32", "int8"] * 8)]
        statuses, stop = [], threading.Event()
        lock = threading.Lock()

        def client(c):
            j = 0
            while not stop.is_set():
                status = _post(url + "/predict", bodies[(c + j) % len(bodies)])[0]
                with lock:
                    statuses.append(status)
                j += 1

        def prom():
            return _post_get(url + "/metrics?format=prom")

        with ThreadPoolExecutor(4) as pool:
            clients = [pool.submit(client, c) for c in range(4)]
            assert wait_for(lambda: len(statuses) >= 20, timeout_s=30.0)
            os.kill(victim, signal.SIGKILL)
            assert wait_for(lambda: 'fleet_backend_restarts_total{backend="b1"} 1' in prom()
                            and 'fleet_backends{state="active"} 2' in prom(),
                            timeout_s=60.0, interval_s=0.2)
            after = len(statuses)
            assert wait_for(lambda: len(statuses) >= after + 20, timeout_s=30.0)
            stop.set()
            for c in clients:
                c.result()
        assert statuses and all(s == 200 for s in statuses), sorted(set(statuses))
        snap = json.loads(_post_get(url + "/metrics"))
        assert snap["backends"]["b1"]["state"] == "active"
        assert snap["backends"]["b1"]["compiles"] == 0
        assert snap["requests"]["completed"] == len(statuses)
        replaced = {pid for pid, cmd in _children(proc.pid).items()
                    if f"--port {base + 1}" in cmd}
        assert replaced and victim not in replaced
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        reader.join(timeout=10)
    assert rc == 0, lines
    assert "fleet: draining backends..." in lines
    assert any(ln.startswith(f"  requests: {len(statuses)} ok") for ln in lines), lines
    assert (tel / "events-fleet.jsonl").exists()
    events = [json.loads(ln)["event"] for ln in (tel / "events-fleet.jsonl").read_text()
              .splitlines()]
    assert {"backend_death", "backend_replace"} <= set(events)


def _post_get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.read().decode()
