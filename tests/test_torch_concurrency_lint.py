"""The port's concurrency pass (JL019-JL021), its runtime lock tracer
(``analysis/lockwatch.py``) and the CLI that ships them, against the JAX
package's.

- Every fixture of ``tests/test_concurrency_lint.py`` goes through both
  concurrency passes, which must report the same ``(rule_id, line)`` set;
  JL021's torch blocking calls (a synchronize, a tensor read back to the
  host) fire, stay silent off the lock, and waive.
- lockwatch: JAX's unit tests, the seeded deadlock caught statically and
  at run time, ``find_cycles`` equal to JAX's on seeded random graphs,
  every ``make_lock`` site of the JAX package a site of the port, and a
  witness run of the port's serving stack in a subprocess under
  ``JAXLINT_LOCKWATCH=1`` (the port's teardown assertion).
- The port's concurrency pass is clean (``-m lint``), and the modules
  whose findings were fixed need no waiver.
"""

from __future__ import annotations

import ast
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from pytorch_mnist_ddp_tpu.analysis import lockwatch as jax_lockwatch
from pytorch_mnist_ddp_tpu.analysis.concurrency import CONCURRENCY_RULES as JAX_CONCURRENCY
from pytorch_mnist_ddp_tpu.analysis.engine import LintEngine as JaxLintEngine
from pytorch_mnist_ddp_tpu_torch.analysis import LintEngine, Severity, lockwatch
from pytorch_mnist_ddp_tpu_torch.analysis.__main__ import main as lint_main
from pytorch_mnist_ddp_tpu_torch.analysis.concurrency import CONCURRENCY_RULES
from pytorch_mnist_ddp_tpu_torch.analysis.engine import Rule
from pytorch_mnist_ddp_tpu_torch.analysis.lockwatch import (
    LockOrderError,
    TracedCondition,
    TracedLock,
    find_cycles,
    make_lock,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "pytorch_mnist_ddp_tpu_torch"
ENGINE = LintEngine(CONCURRENCY_RULES)
JAX_ENGINE = JaxLintEngine(JAX_CONCURRENCY)


def _jax_tests():
    spec = importlib.util.spec_from_file_location(
        "jax_test_concurrency_lint", ROOT / "tests" / "test_concurrency_lint.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX = _jax_tests()


def findings_for(source: str, rule_id: str | None = None):
    found, _ = ENGINE.check_source(source, "fixture.py")
    return [f for f in found if rule_id is None or f.rule_id == rule_id]


def _rule_lines(engine, source: str) -> set[tuple[str, int]]:
    found, _ = engine.check_source(source, "fixture.py")
    return {(f.rule_id, f.line) for f in found}


@pytest.fixture
def traced(monkeypatch):
    """Runtime tracing ON with a clean recorder, reset afterwards so no
    fixture edges leak into other tests."""
    monkeypatch.setenv(lockwatch.ENV_FLAG, "1")
    lockwatch.watch().reset()
    yield lockwatch.watch()
    lockwatch.watch().reset()


# ---------------------------------------------------------------------------
# JL019-JL021: every JAX fixture, through both passes


def _jax_fixtures() -> dict[str, str]:
    """The JAX test file's fixture sources: its module-level constants and
    the literal sources its tests pass inline."""
    tree = ast.parse((ROOT / "tests" / "test_concurrency_lint.py").read_text())
    out = {name: getattr(JAX, name) for name in dir(JAX)
           if name.isupper() and isinstance(getattr(JAX, name), str)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.FunctionDef) and node.name.startswith("test_jl")):
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Constant) and isinstance(sub.value, str)
                        and "class " in sub.value):
                    out[f"{node.name}:{sub.lineno}"] = sub.value
    return out


FIXTURES = _jax_fixtures()


def test_the_jax_fixtures_cover_every_concurrency_rule():
    assert len(FIXTURES) >= 15
    fired = set()
    for source in FIXTURES.values():
        fired |= {r for r, _ in _rule_lines(ENGINE, source)}
    assert fired == {"JL019", "JL020", "JL021"}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_a_jax_fixture_reads_the_same_in_both_passes(name):
    source = FIXTURES[name]
    assert _rule_lines(ENGINE, source) == _rule_lines(JAX_ENGINE, source)


@pytest.mark.parametrize("rule", ["JL019", "JL020", "JL021"])
def test_each_concurrency_rule_fires_on_its_bad_fixture_and_not_its_good(rule):
    bad, good = getattr(JAX, f"{rule}_BAD"), getattr(JAX, f"{rule}_GOOD")
    assert findings_for(bad, rule)
    assert not findings_for(good, rule)


def test_jl019_is_an_error_that_names_the_cycle():
    hits = findings_for(JAX.JL019_BAD, "JL019")
    assert hits and hits[0].severity is Severity.ERROR
    assert "Transfer" in hits[0].message and "_debit" in hits[0].message


def test_jl019_to_jl021_waivers_suppress():
    for source, old, rule in (
        (JAX.JL019_BAD, "            with self._debit:\n                self.moved -= 1", "JL019"),
        (JAX.JL020_BAD, "        return self.total", "JL020"),
        (JAX.JL021_BAD, "            time.sleep(0.1)", "JL021"),
    ):
        first, rest = old.split("\n", 1) if "\n" in old else (old, None)
        new = f"{first}  # jaxlint: disable={rule} -- fixture waiver"
        src = source.replace(old, new if rest is None else f"{new}\n{rest}")
        found, suppressed = ENGINE.check_source(src, "fixture.py")
        assert suppressed >= 1
        assert _rule_lines(ENGINE, src) == _rule_lines(JAX_ENGINE, src)
        if rule != "JL021":
            assert not [f for f in found if f.rule_id == rule]


JL021_TORCH_BAD = """\
import threading
import torch

class Reader:
    def __init__(self, stream):
        self._lock = threading.Lock()
        self.stream = stream
        self.last = None

    def read(self, out, event):
        with self._lock:
            torch.cuda.synchronize()
            event.synchronize()
            self.last = out.cpu()
            value = out.item()
            rows = out.tolist()
            host = out.numpy()
        return value, rows, host
"""

JL021_TORCH_GOOD = """\
import threading
import torch

class Reader:
    def __init__(self):
        self._lock = threading.Lock()
        self.last = None

    def read(self, out):
        host = out.cpu()
        with self._lock:
            self.last = host
            moved = out.to("cpu", non_blocking=True)
        return moved
"""


def test_jl021_fires_on_torch_s_blocking_calls_under_a_lock():
    hits = findings_for(JL021_TORCH_BAD, "JL021")
    assert sorted(f.line for f in hits) == [12, 13, 14, 15, 16, 17]
    assert "device .synchronize()" in hits[0].message
    # The JAX pass knows none of them: they are the port's additions.
    assert not [f for f in JAX_ENGINE.check_source(JL021_TORCH_BAD, "fixture.py")[0]
                if f.rule_id == "JL021"]


def test_jl021_silent_on_torch_reads_off_the_lock():
    assert not findings_for(JL021_TORCH_GOOD, "JL021")


def test_jl021_torch_waiver():
    src = JL021_TORCH_BAD.replace(
        "            torch.cuda.synchronize()",
        "            torch.cuda.synchronize()  # jaxlint: disable=JL021 -- fixture waiver")
    assert 12 not in [f.line for f in findings_for(src, "JL021")]


# ---------------------------------------------------------------------------
# engine waiver edge cases (the JAX tests' test-only rules)


class _DefRule(Rule):
    rule_id = "JL998"
    severity = Severity.WARNING
    summary = "test-only: flags every function def"

    def check(self, ctx):
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.FunctionDef):
                yield self.finding(ctx, node, f"def {node.name}")


class _DefRule2(_DefRule):
    rule_id = "JL997"


@pytest.mark.parametrize("source,rules,left,suppressed", [
    ("import functools\n\n@functools.cache\ndef cached():  # jaxlint: disable=JL998 -- f\n"
     "    return 1\n", (_DefRule,), [], 1),
    ("import functools\n\n@functools.cache  # jaxlint: disable=JL998 -- f\ndef cached():\n"
     "    return 1\n", (_DefRule,), ["JL998"], 0),
    ("def both():  # jaxlint: disable=JL997,JL998 -- f\n    return 1\n",
     (_DefRule, _DefRule2), [], 2),
    ("def one():  # jaxlint: disable=JL998 -- f\n    return 1\n",
     (_DefRule, _DefRule2), ["JL997"], 1),
])
def test_waiver_edge_cases_as_in_jax(source, rules, left, suppressed):
    found, n = LintEngine(tuple(r() for r in rules)).check_source(source, "fixture.py")
    assert [f.rule_id for f in found] == left and n == suppressed


# ---------------------------------------------------------------------------
# CLI: --concurrency / --rules / --baseline


def _write(tmp_path, name, source):
    path = tmp_path / name
    path.write_text(source)
    return str(path)


def test_cli_concurrency_flag_and_rule_sets(tmp_path, capsys):
    bad = _write(tmp_path, "bad.py", JAX.JL019_BAD)
    assert lint_main([bad, "--concurrency"]) == 1
    out = capsys.readouterr().out
    assert "JL019" in out and "1 error(s)" in out
    assert lint_main([bad, "--fail-on-warning"]) == 0  # the default set ignores it
    blocking = _write(tmp_path, "blocking.py", JAX.JL021_BAD)
    assert lint_main([blocking, "--concurrency", "--rules", "JL019", "--fail-on-warning"]) == 0
    capsys.readouterr()
    assert lint_main([blocking, "--concurrency", "--rules", "JL021", "--fail-on-warning"]) == 1
    assert "JL021" in capsys.readouterr().out
    assert lint_main([bad, "--concurrency", "--rules", "JL999"]) == 2
    assert lint_main([bad, "--rules", "JL019"]) == 2  # not in the default set
    assert "unknown rule id" in capsys.readouterr().err


def test_cli_baseline(tmp_path, capsys):
    path = _write(tmp_path, "bad.py", JAX.JL020_BAD)
    assert lint_main([path, "--concurrency", "--json"]) == 0  # warnings only
    report = capsys.readouterr().out
    assert json.loads(report)["warnings"] == 1
    baseline = tmp_path / "baseline.json"
    baseline.write_text(report)
    assert lint_main([path, "--concurrency", "--baseline", str(baseline),
                      "--fail-on-warning"]) == 0
    assert "1 suppressed" in capsys.readouterr().out
    path2 = _write(tmp_path, "bad2.py", JAX.JL020_BAD.replace("total", "count"))
    assert lint_main([path2, "--concurrency", "--baseline", str(baseline),
                      "--fail-on-warning"]) == 1
    missing = str(tmp_path / "nope.json")
    assert lint_main([path, "--concurrency", "--baseline", missing]) == 2
    assert "cannot read baseline" in capsys.readouterr().err


def test_cli_list_rules_shows_the_concurrency_catalog(capsys):
    assert lint_main(["--concurrency", "--list-rules"]) == 0
    out = capsys.readouterr().out
    assert [line.split()[0] for line in out.splitlines()] == ["JL019", "JL020", "JL021"]


@pytest.mark.lint
def test_port_concurrency_pass_is_clean(capsys):
    assert lint_main([str(PORT), "--concurrency", "--fail-on-warning"]) == 0, (
        capsys.readouterr().out
    )


@pytest.mark.lint
def test_fixed_modules_need_no_waiver():
    """``resilience/preempt.py``'s timer race was fixed (the lock is taken
    in ``uninstall()``), not waived: a regression reopens the finding."""
    path = PORT / "resilience" / "preempt.py"
    found, suppressed = ENGINE.check_source(path.read_text(), str(path))
    assert not found and suppressed == 0


def test_preempt_uninstall_cancels_a_timer_armed_by_the_wakeup_side():
    from pytorch_mnist_ddp_tpu_torch.resilience.preempt import PreemptionHandler

    handler = PreemptionHandler(grace_s=60.0)
    handler._arm(15)  # what the wakeup thread does on a signal
    timer = handler._timer
    assert timer is not None and timer.is_alive()
    handler.uninstall()
    timer.join(timeout=5.0)
    assert handler._timer is None and not timer.is_alive()


# ---------------------------------------------------------------------------
# lockwatch: the runtime witness (JAX's unit tests, on the port's tracer)


def test_make_lock_returns_plain_primitives_when_off(monkeypatch):
    monkeypatch.delenv(lockwatch.ENV_FLAG, raising=False)
    assert not lockwatch.enabled()
    lock = make_lock("test.site")
    assert not isinstance(lock, (TracedLock, TracedCondition))
    with lock:
        assert lock.locked()
    assert isinstance(make_lock("test.site", kind="condition"), threading.Condition)
    with pytest.raises(ValueError):
        make_lock("test.site", kind="mutex")
    lockwatch.assert_acyclic()


def test_traced_lock_records_edges_and_counts(traced):
    a, b = make_lock("t.a"), make_lock("t.b")
    assert isinstance(a, TracedLock)
    with a:
        with b:
            pass
    assert traced.counts() == {"t.a": 1, "t.b": 1}
    assert traced.edges() == {("t.a", "t.b"): 1}
    traced.assert_acyclic()


def test_traced_lock_cycle_detected_and_named(traced):
    a, b = make_lock("t.a"), make_lock("t.b")
    with a, b:
        pass
    with b, a:
        pass
    assert traced.cycles() == [["t.a", "t.b", "t.a"]]
    with pytest.raises(LockOrderError) as exc:
        lockwatch.assert_acyclic()
    assert "t.a -> t.b -> t.a" in str(exc.value)


def test_traced_lock_same_site_nesting_is_not_a_cycle(traced):
    a1, a2 = make_lock("t.same"), make_lock("t.same")
    with a1, a2:
        pass
    assert traced.cycles() == []


def test_traced_condition_wait_releases_the_order_slot(traced):
    outer, cond = make_lock("t.outer"), make_lock("t.cond", kind="condition")
    assert isinstance(cond, TracedCondition)
    with outer:
        with cond:
            cond.wait(timeout=0.01)
    assert traced.counts()["t.cond"] == 2
    assert traced.edges()[("t.outer", "t.cond")] == 2
    traced.assert_acyclic()


def test_lockwatch_metrics_flush_on_attach(traced):
    from pytorch_mnist_ddp_tpu_torch.obs.registry import Registry, render_prometheus

    lock = make_lock("t.metrics")
    with lock:
        time.sleep(0.001)
    reg = Registry()
    lockwatch.attach(reg)
    with lock:
        pass
    text = render_prometheus(reg)
    assert 'lock_acquisitions_total{site="t.metrics"} 2' in text
    assert "lock_hold_seconds" in text


def test_lockwatch_cross_thread_edges(traced):
    a, b = make_lock("t.a"), make_lock("t.b")

    def opposite():
        with b, a:
            pass

    t = threading.Thread(target=opposite)
    with a, b:
        pass
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert set(traced.edges()) == {("t.a", "t.b"), ("t.b", "t.a")}
    with pytest.raises(LockOrderError):
        traced.assert_acyclic()


def test_find_cycles_equals_jax_s_on_seeded_graphs():
    rng = np.random.RandomState(22)
    cyclic = 0
    for _ in range(200):
        n = int(rng.randint(1, 9))
        nodes = [f"s{i}" for i in range(n)]
        graph = {a: {b for b in nodes if rng.rand() < 0.3} for a in nodes if rng.rand() < 0.9}
        got = find_cycles(graph)
        assert got == jax_lockwatch.find_cycles(graph)
        cyclic += bool(got)
    assert 20 < cyclic < 200  # both kinds of graph were drawn


def test_seeded_deadlock_caught_statically_and_at_run_time(traced):
    source = JAX.DEADLOCK_FIXTURE.replace("pytorch_mnist_ddp_tpu.", "pytorch_mnist_ddp_tpu_torch.")
    hits = findings_for(source, "JL019")
    assert hits and hits[0].severity is Severity.ERROR
    namespace: dict = {}
    exec(compile(source, "deadlock_fixture.py", "exec"), namespace)
    ledger = namespace["Ledger"]()
    ledger.move_in()
    assert traced.cycles() == []
    ledger.move_out()
    with pytest.raises(LockOrderError) as exc:
        lockwatch.assert_acyclic()
    assert "fixture.credit" in str(exc.value) and "fixture.debit" in str(exc.value)


def _make_lock_sites(pkg: pathlib.Path) -> dict[str, str]:
    """``site -> kind`` of every ``make_lock("site", kind=...)`` call."""
    sites = {}
    for path in pkg.rglob("*.py"):
        if path.parent.name == "analysis":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "make_lock"
                    and node.args and isinstance(node.args[0], ast.Constant)):
                kind = next((kw.value.value for kw in node.keywords if kw.arg == "kind"), "lock")
                sites[node.args[0].value] = kind
    return sites


def test_every_jax_lock_site_is_a_port_site():
    jax_sites = _make_lock_sites(ROOT / "pytorch_mnist_ddp_tpu")
    port_sites = _make_lock_sites(PORT)
    assert len(jax_sites) == 17
    assert {s: port_sites.get(s) for s in jax_sites} == jax_sites
    assert set(port_sites) - set(jax_sites) == {"pool.rung", "engine.late_build", "native.build"}
    # The obs registry's lock stays plain: attach() must not trace itself.
    assert "make_lock" not in (PORT / "obs" / "registry.py").read_text()


WITNESS = """\
import time
import numpy as np
import torch
torch.set_num_threads(1)
from pytorch_mnist_ddp_tpu_torch.analysis import lockwatch
from pytorch_mnist_ddp_tpu_torch.obs.registry import render_prometheus
from pytorch_mnist_ddp_tpu_torch.serving.metrics import ServingMetrics
from pytorch_mnist_ddp_tpu_torch.serving.pool import EnginePool

assert lockwatch.enabled()
metrics = ServingMetrics()
pool = EnginePool.from_seed(1, replicas=2, device="cpu", buckets=(4, 8), metrics=metrics)
pool.warmup()
router = pool.start(router_policy="cost", hedge=True, hedge_delay_ms=0.5,
                    linger_ms=1.0, timeout_ms=30000.0)
x = np.random.RandomState(0).rand(3, 28, 28, 1).astype(np.float32)

def burst(n):
    for r in [router.submit(x) for _ in range(n)]:
        assert r.result(grace_s=30.0).shape == (3, 10)

burst(12)
pool.drain("r1")
burst(6)
assert pool.add("r1") == "r1"
burst(12)
pool.stop()
lockwatch.assert_acyclic()
text = render_prometheus(metrics.registry)
counts = {}
for line in text.splitlines():
    if line.startswith("lock_acquisitions_total{"):
        site = line.split('site="', 1)[1].split('"', 1)[0]
        counts[site] = float(line.rsplit(" ", 1)[1])
hedges = sum(float(l.rsplit(" ", 1)[1]) for l in text.splitlines()
             if l.startswith("serving_hedge_dispatches_total{"))
print("COUNTS", sorted(counts.items()), "HEDGES", hedges)
for site in ("batcher.pending", "router.replicas", "pool.add", "router.hedge"):
    assert counts.get(site, 0) > 0, (site, counts)
assert hedges > 0
"""


def test_witness_run_of_the_serving_stack_is_acyclic(tmp_path):
    """A two-replica pool under the cost router, with hedging, a drain and
    a re-add, traced in its own process: the observed lock order is
    acyclic and the pool's sites count acquisitions."""
    proc = subprocess.run(
        [sys.executable, "-c", WITNESS], cwd=tmp_path, capture_output=True, text=True,
        timeout=240,
        env={**os.environ, "PYTHONPATH": str(ROOT), lockwatch.ENV_FLAG: "1",
             "XDG_CACHE_HOME": str(tmp_path)},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "COUNTS" in proc.stdout
