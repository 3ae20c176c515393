"""The port's router, hedger, circuits and replica supervisor against the
JAX package's (``serving/router.py``, ``serving/pool.py``).

Part one feeds both packages' :class:`Router`, :class:`HedgeManager` and
:class:`ReplicaSupervisor` the same scripted loads, latency samples,
circuit outcomes, refusals and clock values (drawn from a numpy seed) over
scripted fake batchers, and asks for the same placement sequence, the same
hedge dispatches and outcomes, and the same quarantines, restart times and
ejections.  Part two drives the port's real :class:`MicroBatcher` over
fake engines: drain and re-add under traffic, oversize requests, hedges,
aborts, retriable launch failures and the supervisor's restart, hang and
ejection paths.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from pytorch_mnist_ddp_tpu.serving import batcher as jbatcher
from pytorch_mnist_ddp_tpu.serving import circuit as jcircuit
from pytorch_mnist_ddp_tpu.serving import metrics as jmetrics
from pytorch_mnist_ddp_tpu.serving import pool as jpool
from pytorch_mnist_ddp_tpu.serving import router as jrouter
from pytorch_mnist_ddp_tpu_torch.obs.registry import Registry
from pytorch_mnist_ddp_tpu_torch.serving import batcher as tbatcher
from pytorch_mnist_ddp_tpu_torch.serving import circuit as tcircuit
from pytorch_mnist_ddp_tpu_torch.serving import faults
from pytorch_mnist_ddp_tpu_torch.serving import metrics as tmetrics
from pytorch_mnist_ddp_tpu_torch.serving import pool as tpool
from pytorch_mnist_ddp_tpu_torch.serving import router as trouter
from pytorch_mnist_ddp_tpu_torch.serving.batcher import (
    MicroBatcher,
    RejectedError,
    ReplicaDeadError,
)
from pytorch_mnist_ddp_tpu_torch.serving.metrics import ServingMetrics
from pytorch_mnist_ddp_tpu_torch.serving.router import Replica, Router, ShardedRequest

PACKAGES = {
    "jax": (jbatcher, jcircuit, jmetrics, jrouter, jpool),
    "torch": (tbatcher, tcircuit, tmetrics, trouter, tpool),
}


# ---------------------------------------------------------------------------
# Part one: scripted fakes, both packages in lockstep


class ScriptedBatcher:
    """A batcher whose load, refusals and health signals the script sets;
    every placement lands on the shared ``log``."""

    def __init__(self, pkg, name: str, log: list, max_batch: int = 8):
        self.pkg, self.name, self.log = pkg, name, log
        self.max_batch = max_batch
        self.max_inflight = 2
        self.timeout_s = 1.0
        self.current_linger_ms = 0.0
        self.qos_classes = ("interactive", "batch")
        self.queue_depth = 0
        self.in_flight = 0
        self.refuse = False
        self.consecutive_launch_failures = 0
        self.age = 0.0
        self.hedged: list = []
        self.aborted = self.stopped = False

    def depth(self) -> int:
        return self.queue_depth

    def inflight(self) -> int:
        return self.in_flight

    def oldest_inflight_age(self, now=None) -> float:
        return self.age

    def submit(self, x, timeout_ms=None, dtype=None, qos=None, count_reject=True):
        if self.refuse:
            raise self.pkg.RejectedError(f"{self.name} refused")
        self.log.append((self.name, len(x)))
        return self.pkg.PendingRequest(np.asarray(x), deadline=time.perf_counter() + 60.0,
                                       dtype=dtype or "f32", qos=qos or "interactive")

    def submit_hedge(self, req) -> None:
        if self.refuse:
            raise self.pkg.RejectedError(f"{self.name} declined the hedge")
        self.hedged.append(req)
        self.log.append(("hedge", self.name))

    def abort(self) -> int:
        self.aborted = True
        return 0

    def stop(self, drain: bool = True) -> None:
        self.stopped = True


def scripted_router(name: str, n: int, policy: str, log: list, **kwargs):
    bat, _, met, rou, _ = PACKAGES[name]
    replicas = [rou.Replica(f"r{i}", ScriptedBatcher(bat, f"r{i}", log)) for i in range(n)]
    metrics = met.ServingMetrics()
    router = rou.Router(replicas, policy=policy, registry=metrics.registry,
                        metrics=metrics, **kwargs)
    return router, metrics


def place_script(seed: int, steps: int, n: int) -> list[dict]:
    """One step a request: every replica's load, the latency samples and
    circuit outcomes that land before it, the refusals, the rows."""
    rs = np.random.RandomState(seed)
    script = []
    for _ in range(steps):
        step = {
            "load": rs.randint(0, 5, size=(n, 2)).tolist(),
            "latency": [(int(rs.randint(n)), float(rs.uniform(0.001, 0.05)),
                         int(rs.randint(1, 9))) for _ in range(rs.randint(0, 3))],
            "refuse": [bool(v) for v in rs.rand(n) < 0.1],
            "rows": int(rs.randint(1, 9)) if rs.rand() > 0.1 else int(rs.randint(9, 8 * n + 1)),
            "circuit": None,
        }
        u = rs.rand()
        target = int(rs.randint(n))
        if u < 0.08:
            step["circuit"] = (target, "failures")
        elif u < 0.14:
            step["circuit"] = (target, "half_open")
        elif u < 0.22:
            step["circuit"] = (target, "success")
        elif u < 0.26:
            step["circuit"] = (target, "release")
        script.append(step)
    return script


def apply_step(router, step: dict) -> None:
    for r, (depth, inflight), refuse in zip(router.replicas, step["load"], step["refuse"]):
        r.batcher.queue_depth, r.batcher.in_flight, r.batcher.refuse = depth, inflight, refuse
    for i, latency, rows in step["latency"]:
        router.replicas[i].observe_latency(latency, rows)
    if step["circuit"] is not None:
        i, op = step["circuit"]
        breaker = router.replicas[i].breaker
        if op == "failures":
            for _ in range(3):
                breaker.record_failure()
        elif op == "half_open":
            breaker.force_open("scripted")
            breaker.half_open()
        elif op == "success":
            breaker.record_success()
        else:
            breaker.release()


def run_placements(name: str, policy: str, seed: int, steps: int = 120, n: int = 3):
    log: list = []
    router, metrics = scripted_router(name, n, policy, log)
    outcome = []
    for step in place_script(seed, steps, n):
        apply_step(router, step)
        mark = len(log)
        x = np.zeros((step["rows"], 28, 28, 1), np.float32)
        try:
            router.submit(x)
            outcome.append(tuple(log[mark:]))
        except Exception as e:  # both packages' RejectedError
            outcome.append(("503", type(e).__name__, tuple(log[mark:])))
        outcome.append(tuple((r.breaker.state, r.ewma_latency_s) for r in router.replicas))
    decisions = {
        r.name: metrics.registry.counter("serving_router_decisions_total",
                                         policy=policy, replica=r.name).value
        for r in router.replicas
    }
    return outcome, decisions, metrics.rejected


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("policy", ["roundrobin", "least-loaded", "cost"])
def test_placement_sequence_matches_jax(policy, seed):
    """Same loads, samples, circuits and refusals: the same replica for
    every request (oversize ones split into the same chunks), the same
    503s, the same decision counters and circuit states."""
    jax_run = run_placements("jax", policy, seed)
    port_run = run_placements("torch", policy, seed)
    assert port_run == jax_run
    outcome, decisions, _ = port_run
    placed = [o for o in outcome[::2] if o and o[0] != "503"]
    assert sum(decisions.values()) == sum(len(o) for o in placed)
    assert len({name for o in placed for name, _ in o}) > 1


@pytest.mark.parametrize("rows", [1, 3, 5, 8, 9, 64, 65, 128])
def test_shape_class_matches_jax(rows):
    assert trouter.shape_class(rows) == jrouter.shape_class(rows)


def hedge_run(name: str, seed: int, delay_ms: float = 10.0) -> list:
    """Requests placed and tracked, then ticks at scripted times with
    scripted completions (the primary's, the hedge's, or an error)."""
    rs = np.random.RandomState(seed)
    log: list = []
    router, metrics = scripted_router(name, 3, "roundrobin", log)
    rou = PACKAGES[name][3]
    router.hedger = rou.HedgeManager(router, delay_ms=delay_ms)  # never started: ticked here
    reqs = []
    for _ in range(12):
        reqs.append((router.submit(np.zeros((int(rs.randint(1, 5)), 28, 28, 1), np.float32)),
                     log[-1][0]))
    t0 = 1000.0
    for k, entry in enumerate(router.hedger._entries):
        entry.due_t = t0 + 0.01 * (k % 4)
        entry.req.deadline = t0 + 0.05 + 0.01 * (k % 5)
    trace = []
    for tick in range(10):
        for r, (depth, inflight) in zip(router.replicas, rs.randint(0, 4, size=(3, 2))):
            r.batcher.queue_depth, r.batcher.in_flight = int(depth), int(inflight)
            r.batcher.refuse = bool(rs.rand() < 0.15)
        for req, origin in reqs:
            u = rs.rand()
            hedged_on = [b.name for b in (r.batcher for r in router.replicas) if req in b.hedged]
            if req.done() or u > 0.3:
                continue
            if u < 0.1:
                req.set_result(np.zeros((req.n, 10), np.float32), by=origin)
            elif u < 0.2 and hedged_on:
                req.set_result(np.zeros((req.n, 10), np.float32), by=hedged_on[0])
            elif u < 0.23:
                req.set_error(RuntimeError("scripted"))
        mark = len(log)
        router.hedger.tick(now=t0 + 0.006 * tick)
        hedges = {o: metrics.registry.counter("serving_hedges_total", outcome=o).value
                  for o in ("won", "lost", "cancelled")}
        trace.append((tuple(log[mark:]), hedges, router.hedger.pending()))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_hedge_dispatches_and_outcomes_match_jax(seed):
    """Due hedges go to the same least-loaded closed replica (or are
    declined alike), and every entry resolves won / lost / cancelled at the
    same tick in both packages."""
    port = hedge_run("torch", seed)
    assert port == hedge_run("jax", seed)
    assert any(entries for entries, _, _ in port)
    assert sum(port[-1][1].values()) > 0


def breaker_ops(seed: int, steps: int = 200) -> list[str]:
    rs = np.random.RandomState(seed)
    ops = ["try_acquire", "release", "record_success", "record_failure", "force_open",
           "half_open", "allows"]
    return [ops[i] for i in rs.choice(len(ops), steps, p=[.25, .1, .2, .25, .05, .1, .05])]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_circuit_breaker_matches_jax(seed):
    """The same operations from the same seed: the same answers, states,
    gauge values and transition events."""
    traces = {}
    for name, pkg in PACKAGES.items():
        registry = pkg[2].ServingMetrics().registry
        events = []

        class Sink:
            def emit(self, event, **fields):
                events.append((event, fields))

            def __bool__(self):
                return True

        breaker = pkg[1].CircuitBreaker("r0", failure_threshold=3, trial_limit=2,
                                        trial_successes=2, registry=registry, sink=Sink())
        trace = []
        for op in breaker_ops(seed):
            got = getattr(breaker, op)()
            trace.append((op, got, breaker.state,
                          registry.gauge("serving_circuit_state", replica="r0").value))
        traces[name] = (trace, events)
    assert traces["torch"] == traces["jax"]


def supervisor_run(name: str, seed: int, budget: int) -> list:
    """Scripted health signals and clock ticks; restarts that fail at
    scripted attempts.  Returns the per-tick replica states, circuit
    states, scheduled restart times and restart counters."""
    rs = np.random.RandomState(seed)
    log: list = []
    router, metrics = scripted_router(name, 3, "roundrobin", log)
    bat = PACKAGES[name][0]
    fail_restart = set(rs.choice(40, 8, replace=False).tolist())
    calls = {"n": 0}

    def make_batcher(replica):
        calls["n"] += 1
        if calls["n"] in fail_restart:
            raise RuntimeError("scripted restart failure")
        return ScriptedBatcher(bat, replica.name, log)

    sup = PACKAGES[name][4].ReplicaSupervisor(
        router, make_batcher, registry=metrics.registry, interval_s=0.1,
        stall_timeout_s=0.5, failure_threshold=3, backoff_base_s=0.2, backoff_max_s=2.0,
        backoff_jitter=0.25, restart_budget=budget, seed=seed)
    trace, now = [], 50.0
    for _ in range(60):
        now += float(rs.uniform(0.05, 0.4))
        for r in router.replicas:
            u = rs.rand()
            if r.state != "active":
                continue
            if u < 0.05:
                r.batcher.consecutive_launch_failures = 3
            elif u < 0.09:
                r.batcher.age = 1.0
            elif u < 0.13:
                for _ in range(3):
                    r.breaker.record_failure()
            elif u < 0.5:
                r.breaker.record_success()
        sup.tick(now=now)
        trace.append(tuple(
            (r.state, r.breaker.state, sup._watch[r.name].next_restart_t,
             sup._watch[r.name].restarts, sup._watch[r.name].attempts)
            for r in router.replicas))
    restarts = {r.name: metrics.registry.counter("serving_replica_restarts_total",
                                                 replica=r.name).value
                for r in router.replicas}
    return [trace, restarts, sup.stats()]


@pytest.mark.parametrize("budget", [1, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_supervisor_restart_times_match_jax(seed, budget):
    """Quarantine on the same signal, restart at the same (seeded-jitter)
    times, the same failed restarts re-scheduled, the same ejections."""
    port = supervisor_run("torch", seed, budget)
    assert port == supervisor_run("jax", seed, budget)
    states = {s for tick in port[0] for s, *_ in tick}
    assert {"quarantined", "active"} <= states
    assert sum(port[1].values()) > 0


def test_router_refuses_bad_construction_like_jax():
    for pkg in (jrouter, trouter):
        with pytest.raises(ValueError, match="unknown router policy"):
            pkg.Router([pkg.Replica("r0", None)], policy="random")
        with pytest.raises(ValueError, match="at least one replica"):
            pkg.Router([])
        with pytest.raises(ValueError, match="duplicate replica names"):
            pkg.Router([pkg.Replica("r0", None), pkg.Replica("r0", None)])


# ---------------------------------------------------------------------------
# Part two: the port's MicroBatcher over fake engines


class _LazyLogits:
    """A launched batch that is ready ``delay_s`` after launch; row i's
    logit 0 is the row's first pixel (its tag)."""

    def __init__(self, rows, delay_s):
        self._rows = np.array(rows, copy=True)
        self._ready = time.perf_counter() + delay_s

    def __array__(self, dtype=None, copy=None):
        wait = self._ready - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        out = np.zeros((len(self._rows), 10), np.float32)
        out[:, 0] = self._rows.reshape(len(self._rows), -1)[:, 0]
        return out


class FakeEngine:
    def __init__(self, delay_s: float = 0.0):
        self.buckets = (8,)
        self.metrics = None
        self.delay_s = delay_s
        self.dispatches: list[int] = []

    def launch(self, staged, n):
        self.dispatches.append(n)
        return _LazyLogits(staged, self.delay_s)


def rows(n, tag=1.0):
    x = np.zeros((n, 28, 28, 1), np.float32)
    x[:, 0, 0, 0] = tag
    return x


def hooked_batcher(replica_name, engine, metrics, **kwargs):
    opts = dict(linger_ms=0.0, adaptive_linger=False, timeout_ms=5000.0)
    opts.update(kwargs)
    return MicroBatcher(engine, metrics=metrics, replica=replica_name, **opts)


def fake_pool(n, delay_s=0.0, policy="roundrobin", metrics=None, **kwargs):
    metrics = metrics if metrics is not None else ServingMetrics()
    replicas, engines = [], []
    for i in range(n):
        engine = FakeEngine(delay_s)
        replica = Replica(f"r{i}", hooked_batcher(f"r{i}", engine, metrics, **kwargs),
                          engine=engine)
        tpool.EnginePool._hook_and_start(replica, replica.batcher)
        replicas.append(replica)
        engines.append(engine)
    return Router(replicas, policy=policy, registry=metrics.registry, metrics=metrics), \
        engines, metrics


def supervise(router, metrics, **kwargs):
    opts = dict(interval_s=0.01, stall_timeout_s=0.25, backoff_base_s=0.03,
                backoff_max_s=0.2, backoff_jitter=0.0, restart_budget=5, seed=0)
    opts.update(kwargs)

    def make_batcher(replica):
        batcher = hooked_batcher(replica.name, replica.engine, metrics)
        tpool.EnginePool._hook_and_start(replica, batcher)
        return batcher

    return tpool.ReplicaSupervisor(router, make_batcher, registry=metrics.registry, **opts)


def retry(router, x, attempts=None):
    """The server's resubmission of a flushed request, distilled."""
    attempts = attempts or 1 + len(router.replicas)
    last = None
    for _ in range(attempts):
        try:
            return router.submit(x).result()
        except RejectedError as e:
            last = e
    raise last


def wait_until(predicate, timeout_s=5.0):
    deadline = time.perf_counter() + timeout_s
    while time.perf_counter() < deadline:
        if predicate():
            return True
        time.sleep(0.005)
    return predicate()


def test_roundrobin_spreads_and_counts_every_decision():
    router, engines, metrics = fake_pool(4)
    for r in [router.submit(rows(8, tag=i)) for i in range(12)]:
        r.result()
    router.stop()
    assert sorted(len(e.dispatches) for e in engines) == [3, 3, 3, 3]
    assert sum(metrics.registry.counter("serving_router_decisions_total", policy="roundrobin",
                                        replica=f"r{i}").value for i in range(4)) == 12


def test_oversize_request_reassembles_in_arrival_order():
    router, engines, _ = fake_pool(3)
    x = rows(20)
    x[:, 0, 0, 0] = np.arange(20)
    req = router.submit(x)
    assert isinstance(req, ShardedRequest) and req.n == 20
    out = req.result()
    router.stop()
    np.testing.assert_array_equal(out[:, 0], np.arange(20, dtype=np.float32))
    assert sorted(sum(e.dispatches) for e in engines) == [6, 7, 7]
    small = fake_pool(2)[0]
    with pytest.raises(RejectedError, match="pool capacity"):
        small.submit(rows(17))
    small.stop()


def test_drain_mid_stream_loses_and_duplicates_nothing_then_readds():
    router, engines, metrics = fake_pool(2, delay_s=0.002)
    reqs = [router.submit(rows(2, tag=i)) for i in range(40)]
    seconds = router.drain("r0")
    reqs += [router.submit(rows(2, tag=40 + i)) for i in range(20)]
    got = [r.result() for r in reqs]
    assert [float(g[0, 0]) for g in got] == [float(i) for i in range(60)]
    assert router.replica("r0").state == "drained" and seconds >= 0.0
    before = len(engines[0].dispatches)
    router.attach("r0", hooked_batcher("r0", engines[0], metrics).start())
    assert router.replica("r0").active
    for r in [router.submit(rows(1, tag=i)) for i in range(6)]:
        r.result()
    router.stop()
    assert len(engines[0].dispatches) > before
    assert metrics.completed == 66 and metrics.rejected == 0
    with pytest.raises(RuntimeError, match="last active replica"):
        router2 = fake_pool(1)[0]
        try:
            router2.drain("r0")
        finally:
            router2.stop()


def test_hedge_first_wins_and_counts_once():
    metrics = ServingMetrics()
    router, engines, _ = fake_pool(2, metrics=metrics)
    slow = router.replica("r0").batcher
    faults.install(faults.FaultInjector("hang:complete:r0:for=0.5").start())
    try:
        router.hedger = trouter.HedgeManager(router, delay_ms=20.0, poll_s=0.002).start()
        req = router.submit(rows(1, tag=5.0))  # round robin: r0
        out = req.result()
    finally:
        faults.uninstall()
    router.stop()
    assert out[0, 0] == 5.0 and req.completed_by == "r1"
    assert metrics.completed == 1 and slow.inflight() == 0
    assert metrics.snapshot()["hedges"] == {"cancelled": 0, "lost": 0, "won": 1}
    assert metrics.registry.counter("serving_hedge_dispatches_total", replica="r1").value == 1


def test_abort_flushes_queued_and_inflight_with_retriable_error():
    metrics = ServingMetrics()
    engine = FakeEngine(delay_s=5.0)
    batcher = hooked_batcher("r0", engine, metrics, max_inflight=1).start()
    launched = batcher.submit(rows(8))
    assert wait_until(lambda: batcher.inflight() == 1)
    queued = batcher.submit(rows(1))
    assert batcher.abort() == 2
    for req in (launched, queued):
        with pytest.raises(ReplicaDeadError):
            req.result()
    assert batcher.inflight() == 0 and batcher.oldest_inflight_age() == 0.0
    batcher.stop()  # a no-op after abort: returns without joining
    with pytest.raises(RejectedError):
        batcher.submit(rows(1))


def test_launch_failure_is_retriable_in_pool_mode_only():
    for replica, expect in (("r0", ReplicaDeadError), (None, faults.FaultError)):
        metrics = ServingMetrics()
        batcher = MicroBatcher(FakeEngine(), metrics=metrics, replica=replica,
                               linger_ms=0.0, adaptive_linger=False).start()
        with faults.injected("fail:launch"):
            req = batcher.submit(rows(1))
            with pytest.raises(expect):
                req.result()
        assert batcher.consecutive_launch_failures == 1
        assert metrics.failed == 1
        ok = batcher.submit(rows(1, tag=3.0)).result()
        assert ok[0, 0] == 3.0 and batcher.consecutive_launch_failures == 0
        batcher.stop()


def test_shed_and_flush_drop_hedged_copies_silently_until_the_last():
    metrics = ServingMetrics()
    a = MicroBatcher(FakeEngine(), metrics=metrics, replica="r0", queue_depth=1)
    b = MicroBatcher(FakeEngine(), metrics=metrics, replica="r1", queue_depth=1)
    req = a.submit(rows(1), qos="batch")
    b.submit_hedge(req)
    a.submit(rows(1), qos="interactive")  # sheds the hedged copy on a, silently
    assert not req.done() and a.depth() == 1
    other = MicroBatcher(FakeEngine(), metrics=metrics, replica="r2", queue_depth=1)
    twin = other.submit(rows(1))
    with pytest.raises(RejectedError, match="hedge declined"):
        b.submit_hedge(twin)  # b's queue is full: declined, twin untouched
    assert not twin.done()
    b.stop(drain=False)  # req's last copy: now the client's error
    with pytest.raises(RejectedError, match="shutting down"):
        req.result()
    assert metrics.snapshot()["qos"]["batch"]["shed"] == 0  # the copy was no shed
    assert metrics.rejected == 0  # pool mode: the flush is retried, not a 503
    for batcher in (a, other):
        batcher.stop(drain=False)


def test_supervisor_restarts_a_killed_replica_and_closes_its_circuit():
    router, engines, metrics = fake_pool(2)
    sup = supervise(router, metrics).start()
    try:
        with faults.injected("fail:launch:r1:count=6"):
            outs = [retry(router, rows(1, tag=i)) for i in range(20)]
        assert [o[0, 0] for o in outs] == list(range(20))
        assert wait_until(lambda: router.replica("r1").active)
        for i in range(40):
            retry(router, rows(1, tag=i))
            if router.replica("r1").breaker.state == "closed":
                break
            time.sleep(0.01)
        assert router.replica("r1").breaker.state == "closed"
    finally:
        sup.stop()
        router.stop()
    assert sup.stats()["replicas"]["r1"]["restarts"] >= 1
    assert metrics.registry.counter("serving_replica_restarts_total", replica="r1").value >= 1
    assert metrics.retried == 0  # retry() above is the test's, not the server's


def test_supervisor_quarantines_a_hung_completion_worker():
    router, engines, metrics = fake_pool(2)
    sup = supervise(router, metrics, stall_timeout_s=0.1).start()
    try:
        with faults.injected("hang:complete:r0:for=2"):
            out = retry(router, rows(1, tag=7.0))  # r0 first: hangs, aborted, retried
        assert out[0, 0] == 7.0
        assert wait_until(lambda: sup.stats()["replicas"].get("r0", {}).get("restarts", 0) >= 1)
    finally:
        sup.stop()
        router.stop()


def test_supervisor_ejects_after_the_restart_budget():
    router, engines, metrics = fake_pool(2)
    sup = supervise(router, metrics, restart_budget=1).start()
    try:
        with faults.injected("fail:launch:r1:count=inf"):
            for i in range(100):
                retry(router, rows(1, tag=i))
                if router.replica("r1").state == "ejected":
                    break
                time.sleep(0.01)
            assert wait_until(lambda: router.replica("r1").state == "ejected")
        assert router.routable_count() == 1
        assert retry(router, rows(1, tag=9.0))[0, 0] == 9.0
    finally:
        sup.stop()
        router.stop()


def test_quarantine_of_every_replica_leaves_none_routable():
    router, _, metrics = fake_pool(2)
    for name in ("r0", "r1"):
        router.quarantine(name, reason="test")
    assert router.routable_count() == 0
    with pytest.raises(RejectedError):
        router.submit(rows(1))
    assert metrics.rejected == 1
    router.stop()


def test_router_stop_drains_concurrently_and_skips_quarantined():
    router, engines, _ = fake_pool(3, delay_s=0.01)
    reqs = [router.submit(rows(1, tag=i)) for i in range(9)]
    router.quarantine("r2")
    t = threading.Thread(target=router.stop)
    t.start()
    t.join(10)
    assert not t.is_alive()
    done = [r for r in reqs if r.done()]
    assert len(done) == 9


def test_replica_stats_and_registry_families():
    registry = Registry()
    router, _, metrics = fake_pool(2, metrics=ServingMetrics(registry=registry))
    router.submit(rows(3)).result()
    stats = router.replica_stats()
    router.stop()
    assert set(stats) == {"r0", "r1"}
    assert set(stats["r0"]) == {"state", "circuit", "queue_depth", "qos_depth", "inflight",
                                "ewma_latency_ms", "class_ewma_ms"}
    assert registry.gauge("serving_replica_inflight", replica="r0").value == 0
    assert metrics.registry.counter("serving_router_shape_decisions_total",
                                    policy="roundrobin", shape_class="b4").value == 1
