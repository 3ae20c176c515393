"""The port's fault injector (``serving/faults.py``), loss guard, backoff
ladder and the loader's ``data_next`` fault point, held against the JAX
package on the CPU.

The grammar is the JAX package's: its docstring examples parse to the
same fields in both packages and its invalid specs to the same
``ValueError`` text; with the same seed the same spec fires on the same
events (``p=`` included).  ``LossGuard`` classifies a loss stream as
JAX's does, and ``BackoffLadder`` gives JAX's delays for a seed.  The
loader retries a failed assembly on its prefetch thread, carries a
failure past the budget to the consumer with the JAX loader's text, and
a ``kill`` there ends the process with 137.
"""

from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu import liveness as jax_liveness
from pytorch_mnist_ddp_tpu.resilience import guard as jax_guard
from pytorch_mnist_ddp_tpu.serving import faults as jax_faults
from pytorch_mnist_ddp_tpu_torch import liveness
from pytorch_mnist_ddp_tpu_torch.data.loader import DataLoader
from pytorch_mnist_ddp_tpu_torch.obs import Registry
from pytorch_mnist_ddp_tpu_torch.resilience import guard
from pytorch_mnist_ddp_tpu_torch.serving import faults

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]
FIELDS = ("op", "site", "replica", "rank", "count", "after", "at_s", "hang_s", "p", "source")


def _doc_examples(module=jax_faults) -> list[str]:
    """The clauses of a module docstring's Examples block."""
    doc = module.__doc__.split("Examples::", 1)[1].split("\n\n")[1]
    clauses = (line.split("#")[0].strip() for line in doc.splitlines())
    return [c for c in clauses if c]


def test_the_examples_block_is_the_jax_one():
    assert _doc_examples(faults) == _doc_examples()
    assert len(_doc_examples()) == 10


@pytest.mark.parametrize("clause", _doc_examples())
def test_docstring_examples_parse_to_the_same_fields(clause):
    port, ref = faults.FaultSpec.parse(clause), jax_faults.FaultSpec.parse(clause)
    assert [getattr(port, f) for f in FIELDS] == [getattr(ref, f) for f in FIELDS]


@pytest.mark.parametrize("clause", [
    "fail", "boom:step", "fail:nowhere", "fail:step:xyz=1", "fail:step:count=0",
    "nan:launch", "nan:data_next", "fail:aot_load:r1", "fail:step:r0", "kill:ckpt_save:r2",
    "fail:step:rank=-1", "fail:launch:rank=1", "hang:complete:r0:p=x",
])
def test_invalid_specs_raise_the_jax_text(clause):
    with pytest.raises(ValueError) as ref:
        jax_faults.FaultSpec.parse(clause)
    with pytest.raises(ValueError) as port:
        faults.FaultSpec.parse(clause)
    assert str(port.value) == str(ref.value)


def _fires(module, spec: str, seed: int, site: str, events: int, rank: int = 0,
           replica: str | None = None) -> list[str]:
    """What each of ``events`` fault-point events did: '' (nothing),
    'fail' or 'nan'."""
    injector = module.FaultInjector(spec, seed=seed, rank=rank)
    out = []
    for _ in range(events):
        try:
            injector.fire(site, replica)
            out.append("")
        except module.FaultError as e:
            out.append(e.op)
    assert injector.fired_counts() == {s.source: s.fired for s in injector.specs}
    return out


@pytest.mark.parametrize("spec,site,rank,replica", [
    ("fail:step:p=0.3,count=inf", "step", 0, None),
    ("fail:data_next:p=0.5,count=7,after=3", "data_next", 0, None),
    ("nan:step:after=5;fail:step:after=8,count=2", "step", 0, None),
    ("fail:step:rank=1:after=2", "step", 1, None),
    ("fail:step:rank=1:after=2", "step", 0, None),
    ("fail:launch:r1:p=0.25,count=inf;fail:launch:count=3", "launch", 0, "r1"),
], ids=["p", "p_after_count", "nan_then_fail", "rank_match", "rank_other", "replica"])
@pytest.mark.parametrize("seed", [0, 7])
def test_same_spec_and_seed_fire_on_the_same_events(spec, site, rank, replica, seed):
    got = _fires(faults, spec, seed, site, 60, rank, replica)
    assert got == _fires(jax_faults, spec, seed, site, 60, rank, replica)
    assert any(got) != (spec.startswith("fail:step:rank=1") and rank == 0)


def test_injector_reads_its_rank_from_the_launcher_env(monkeypatch):
    monkeypatch.setenv("RANK", "3")
    assert faults.FaultInjector("fail:step:rank=3").rank == 3
    with faults.injected("fail:step:rank=3") as injector:
        assert faults.active() and faults.active_sites() == {"step"}
        with pytest.raises(faults.FaultError, match=r"injected fail at step \(fail:step:rank=3\)"):
            faults.fault_point("step")
        assert injector.fired_counts() == {"fail:step:rank=3": 1}
    assert not faults.active() and faults.active_sites() == frozenset()
    faults.fault_point("step")  # dormant again


def test_hang_releases_on_uninstall():
    import threading
    import time

    faults.install(faults.FaultInjector("hang:step:for=30")).start()
    done = threading.Event()
    t = threading.Thread(target=lambda: (faults.fault_point("step"), done.set()))
    t.start()
    time.sleep(0.1)
    t0 = time.monotonic()
    faults.uninstall()
    assert done.wait(5) and time.monotonic() - t0 < 5
    t.join()


LOSS_STREAM = [2.3, 2.2, float("nan"), 2.1, 30.0, 1.9, float("inf"), 1.8, 1.7, 25.0, 1.6,
               -float("inf"), 1.5, 16.0, 1.4]


@pytest.mark.parametrize("spike_factor", [10.0, 0.0, 8.0])
def test_loss_guard_classifies_a_stream_as_jax_does(spike_factor):
    port = guard.LossGuard(spike_factor=spike_factor, retry_budget=2, lr_backoff=0.25)
    ref = jax_guard.LossGuard(spike_factor=spike_factor, retry_budget=2, lr_backoff=0.25)
    for loss in LOSS_STREAM:
        kind = port.classify(loss)
        assert kind == ref.classify(loss), loss
        if kind is None:
            port.record_healthy(loss)
            ref.record_healthy(loss)
        assert port.ewma == ref.ewma
    assert [port.lr_scale(a) for a in range(1, 5)] == [ref.lr_scale(a) for a in range(1, 5)]
    assert guard.EXIT_ANOMALY == jax_guard.EXIT_ANOMALY == 70
    for bad in ({"retry_budget": 0}, {"lr_backoff": 0.0}, {"lr_backoff": 1.5}):
        with pytest.raises(ValueError) as ref_err:
            jax_guard.LossGuard(**bad)
        with pytest.raises(ValueError) as port_err:
            guard.LossGuard(**bad)
        assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("seed", [0, 1, 42])
def test_backoff_ladder_gives_the_jax_delays(seed):
    port = liveness.BackoffLadder(base_s=0.5, max_s=4.0, jitter=0.25, seed=seed)
    ref = jax_liveness.BackoffLadder(base_s=0.5, max_s=4.0, jitter=0.25, seed=seed)
    got = [port.delay_s(a) for a in range(8)]
    assert got == [ref.delay_s(a) for a in range(8)]
    assert all(min(4.0, 0.5 * 2 ** a) <= d <= 1.25 * min(4.0, 0.5 * 2 ** a)
               for a, d in enumerate(got))


# -- the loader's data_next fault point ---------------------------------------

def _loader(depth: int, registry=None, sink=None, retries: int = 3) -> DataLoader:
    rng = np.random.RandomState(0)
    return DataLoader(rng.randint(0, 256, (40, 28, 28)).astype(np.uint8),
                      rng.randint(0, 10, 40), 8, torch.device("cpu"), seed=1,
                      prefetch_depth=depth, registry=registry, sink=sink, pipeline="train",
                      data_retries=retries, data_backoff_s=0.0)


class _ListSink:
    def __init__(self):
        self.events = []

    def emit(self, event, **fields):
        self.events.append((event, fields))

    def __bool__(self):
        return True


@pytest.mark.parametrize("depth", [0, 2])
def test_data_next_faults_are_retried_to_the_same_batches(depth):
    clean = [tuple(t.clone() for t in b) for b in _loader(depth).epoch(1)]
    reg, sink = Registry(), _ListSink()
    with faults.injected("fail:data_next:after=1,count=2"):
        got = list(_loader(depth, reg, sink).epoch(1))
    assert len(got) == len(clean) == 5
    assert all(torch.equal(a, b) for x, y in zip(got, clean) for a, b in zip(x, y))
    assert reg.counter("data_retries_total", pipeline="train").value == 2
    retries = [f for e, f in sink.events if e == "data_retry"]
    assert [(r["batch"], r["attempt"]) for r in retries] == [(1, 1), (1, 2)]
    assert retries[0]["error"].startswith("FaultError: injected fail at data_next")
    [epoch] = [f for e, f in sink.events if e == "prefetch_epoch"]
    assert (epoch["pipeline"], epoch["epoch"], epoch["depth"], epoch["batches"]) == (
        "train", 1, depth, 5)


@pytest.mark.parametrize("depth", [0, 2])
def test_a_failure_past_the_budget_reaches_the_consumer(depth):
    loader = _loader(depth, retries=2)
    seen = []
    with faults.injected("fail:data_next:after=2,count=inf"):
        with pytest.raises(RuntimeError) as err:
            for batch in loader.epoch(1):
                seen.append(batch)
    assert len(seen) == 2
    message = str(err.value)
    assert message.startswith("data pipeline [train] failed assembling batch 2 of epoch 1 "
                              "after 3 attempt(s): injected fail at data_next")
    jax_loader = (ROOT / "pytorch_mnist_ddp_tpu" / "data" / "loader.py").read_text()
    assert 'f"data pipeline [{self.pipeline}] failed "' in jax_loader
    assert re.search(r'assembling batch \{b\} of epoch \{epoch\} after "', jax_loader)


def test_kill_on_the_prefetch_thread_ends_the_process_137():
    code = (
        "import numpy as np, torch\n"
        "from pytorch_mnist_ddp_tpu_torch.data.loader import DataLoader\n"
        "from pytorch_mnist_ddp_tpu_torch.serving import faults\n"
        "faults.install(faults.FaultInjector('kill:data_next:after=2'))\n"
        "x = np.zeros((40, 28, 28), np.uint8)\n"
        "loader = DataLoader(x, np.zeros(40), 8, torch.device('cpu'), prefetch_depth=2)\n"
        "for i, _ in enumerate(loader.epoch(1)):\n"
        "    print(i, flush=True)\n"
        "print('survived', flush=True)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=ROOT,
                          env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 137, proc.stderr
    assert "survived" not in proc.stdout
