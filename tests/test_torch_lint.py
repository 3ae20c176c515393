"""The port lint (``pytorch_mnist_ddp_tpu_torch/analysis``) against the
JAX package's analyzer: its pattern rules, engine and CLI.

- The JAX fixtures that make no JAX call (``tests/test_jaxlint.py``'s
  JL012-JL018 and JL022-JL024 fixtures without ``jax.*``) go through both
  analyzers, which must report the same ``(rule_id, line)`` set.
- Every ported rule has a fires, a silent and a waiver case in torch's
  idiom: the launch targets (``torch.compile``, ``make_*_step``
  builders, ``Program``, CUDA graphs, kernel wrappers, ``.launch``) where
  the JAX fixtures use ``jax.jit``.
- The engine's waiver syntax and JL000, the CLI's exit codes and report,
  and the repo gate: the port lints clean (``-m lint``).

Everything here is AST work: no test builds a model.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import subprocess
import sys

import pytest

from pytorch_mnist_ddp_tpu.analysis import ALL_RULES as JAX_RULES
from pytorch_mnist_ddp_tpu.analysis import LintEngine as JaxLintEngine
from pytorch_mnist_ddp_tpu_torch.analysis import ALL_RULES, LintEngine, Severity, rule_by_id
from pytorch_mnist_ddp_tpu_torch.analysis.__main__ import main as lint_main

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENGINE = LintEngine(ALL_RULES)
JAX_ENGINE = JaxLintEngine(JAX_RULES)
PORT_RULE_IDS = {rule.rule_id for rule in ALL_RULES}
SERVING_PATH = "pytorch_mnist_ddp_tpu_torch/serving/fixture.py"


def _jax_tests():
    spec = importlib.util.spec_from_file_location("jax_test_jaxlint", ROOT / "tests" / "test_jaxlint.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX = _jax_tests()


def findings_for(source: str, rule_id: str | None = None, path: str = "fixture.py"):
    found, _ = ENGINE.check_source(source, path)
    return [f for f in found if rule_id is None or f.rule_id == rule_id]


def assert_fires(source: str, rule_id: str, line: int | None = None,
                 path: str = "fixture.py"):
    hits = findings_for(source, rule_id, path)
    assert hits, f"{rule_id} did not fire on its bad fixture"
    if line is not None:
        assert line in [f.line for f in hits], (
            f"{rule_id} fired at {[f.line for f in hits]}, expected {line}"
        )


def assert_silent(source: str, rule_id: str, path: str = "fixture.py"):
    hits = findings_for(source, rule_id, path)
    assert not hits, f"{rule_id} false-positive: {[f.format() for f in hits]}"


def waived(source: str, old: str, rule_id: str) -> str:
    assert source.count(old) == 1, old
    return source.replace(old, f"{old}  # jaxlint: disable={rule_id} -- fixture waiver")


# ---------------------------------------------------------------------------
# The JAX fixtures that make no JAX call, through both analyzers

SHARED = {
    "JL012": ["JL012_BAD_CTOR", "JL012_GOOD_SINGLE"],
    "JL013": ["JL013_BAD_LAUNCH", "JL013_GOOD_BOUNDED_RETRY", "JL013_GOOD_RERAISES",
              "JL013_GOOD_BACKOFF", "JL013_GOOD_SPECIFIC_TYPE"],
    "JL014": ["JL014_BAD_RAW_PATH", "JL014_BAD_JOINED_PATH", "JL014_BAD_UNCADENCED_LOOP",
              "JL014_GOOD_MODULO_CADENCE", "JL014_GOOD_DUE_GATE",
              "JL014_GOOD_HELPER_OUTSIDE_LOOP", "JL014_GOOD_BYTESIO_BUFFER"],
    "JL015": ["JL015_BAD_UNSUPERVISED_CALL", "JL015_BAD_UNSUPERVISED_POPEN",
              "JL015_GOOD_SIGNAL_AWARE_LAUNCH", "JL015_GOOD_SUPERVISED_LAUNCH",
              "JL015_GOOD_NON_SCRIPT_SUBPROCESS"],
    "JL016": ["JL016_BAD_CONST_SLEEP", "JL016_BAD_LINGER_NAME", "JL016_GOOD_DEADLINE_CLOSE",
              "JL016_GOOD_EXPIRY_CHECK", "JL016_GOOD_NO_DISPATCH", "JL016_GOOD_BOUNDED_REPLAY"],
    "JL017": ["JL017_BAD_URLOPEN", "JL017_BAD_CREATE_CONNECTION", "JL017_BAD_RAW_RECV",
              "JL017_GOOD_URLOPEN_TIMEOUT", "JL017_GOOD_URLOPEN_POSITIONAL",
              "JL017_GOOD_RECV_WITH_SETTIMEOUT", "JL017_GOOD_RECV_WITH_DEADLINE",
              "JL017_GOOD_BOUNDED_RETRY"],
    "JL018": ["JL018_BAD_SERVE_LOOP", "JL018_BAD_FOR_OVER_REQUESTS", "JL018_BAD_KWARG",
              "JL018_GOOD_BINARY_WIRE", "JL018_GOOD_ONESHOT_REPORT",
              "JL018_GOOD_BOUNDED_REPLAY", "JL018_GOOD_NO_ARRAY"],
    "JL022": ["JL022_BAD_DIRECT_LOAD", "JL022_BAD_STATE_DICT", "JL022_BAD_DIGEST_WRITE",
              "JL022_GOOD_REGISTRY_SURFACE", "JL022_GOOD_SELF_STATE"],
    "JL023": ["JL023_BAD_PAD_TO_BUCKET", "JL023_BAD_INLINE_POW2", "JL023_GOOD_CONSTANT_PAD",
              "JL023_GOOD_BOUNDED_REPLAY", "JL023_GOOD_OUTSIDE_LOOP"],
    "JL024": ["JL024_BAD_INLINE_MESH", "JL024_BAD_LOOP_ASSIGNED_MESH", "JL024_BAD_MESH_KWARG",
              "JL024_GOOD_THREADED_MESH", "JL024_GOOD_MESH_OUTSIDE_LOOP",
              "JL024_GOOD_MODULE_MESH"],
}
SHARED_CASES = [(rule, name) for rule, names in SHARED.items() for name in names]


def _rule_lines(engine, source: str, path: str) -> set[tuple[str, int]]:
    found, _ = engine.check_source(source, path)
    return {(f.rule_id, f.line) for f in found}


@pytest.mark.parametrize("rule,name", SHARED_CASES, ids=[n for _, n in SHARED_CASES])
def test_a_jax_fixture_without_jax_reads_the_same_in_both(rule, name):
    source = getattr(JAX, name)
    assert "jax" not in source.replace("pytorch_mnist_ddp_tpu", "")  # no JAX call
    path = SERVING_PATH if rule == "JL022" else "fixture.py"
    port = _rule_lines(ENGINE, source, path)
    assert port == _rule_lines(JAX_ENGINE, source, path)
    assert bool({r for r, _ in port} & {rule}) == ("_BAD_" in name)


def test_the_rule_scopes_read_as_in_jax():
    """JL022's serving/ gate and JL023's bucket-module exemption."""
    for path in ("pytorch_mnist_ddp_tpu_torch/trainer.py", "serving.py",
                 *(f"pytorch_mnist_ddp_tpu_torch/serving/{m}"
                   for m in ("registry.py", "rollout.py", "engine.py"))):
        assert not findings_for(JAX.JL022_BAD_DIRECT_LOAD, "JL022", path)
        assert not [f for f in JAX_ENGINE.check_source(JAX.JL022_BAD_DIRECT_LOAD, path)[0]
                    if f.rule_id == "JL022"]
    assert len(findings_for(JAX.JL022_BAD_DIRECT_LOAD, "JL022", SERVING_PATH)) == 2
    assert not findings_for(JAX.JL023_BAD_PAD_TO_BUCKET, "JL023",
                            "pytorch_mnist_ddp_tpu_torch/serving/buckets.py")
    assert findings_for(JAX.JL023_BAD_PAD_TO_BUCKET, "JL023", "buckets.py")


def test_the_rule_catalog_is_jax_s_minus_what_does_not_apply():
    jax_rules = {rule.rule_id: rule for rule in JAX_RULES}
    not_ported = {f"JL00{i}" for i in range(1, 9)} | {"JL010"}
    assert PORT_RULE_IDS == set(jax_rules) - not_ported
    for rule in ALL_RULES:
        assert rule.severity.value == jax_rules[rule.rule_id].severity.value
        assert rule_by_id(rule.rule_id.lower()) is rule
    doc = sys.modules[type(ALL_RULES[0]).__module__].__doc__
    for rule_id in ("JL001-JL008", "JL010", "sentinel.py"):
        assert rule_id in doc


# ---------------------------------------------------------------------------
# JL009 — blocking host read of a launch output inside its dispatch loop

JL009_BAD_CPU = """\
import torch

predict = torch.compile(lambda x: x)

def serve(batches):
    outs = []
    for b in batches:
        logits = predict(b)
        outs.append(logits.cpu())
    return outs
"""

JL009_BAD_ASARRAY = """\
import numpy as np
from pytorch_mnist_ddp_tpu_torch.serving.predict import make_predict_step

def serve(params, batches):
    step = make_predict_step()
    out = []
    for b in batches:
        out.append(np.asarray(step(params, b)))
    return out
"""

JL009_BAD_SYNC = """\
import torch
from pytorch_mnist_ddp_tpu_torch.ops.int8_head import fused_int8_head

def serve(qparams, batches):
    for b in batches:
        fused_int8_head(b, *qparams)
        torch.cuda.synchronize()
"""

JL009_BAD_WAIT = """\
def serve(engine, batches):
    out = []
    for b in batches:
        result = engine.launch(b, len(b))
        out.append(result.wait())
    return out
"""

JL009_BAD_ATTR_ITEM = """\
from pytorch_mnist_ddp_tpu_torch.parallel.ddp import make_train_step

class Trainer:
    def __init__(self):
        self._step = make_train_step()

    def run(self, model, state, batches):
        losses = []
        for x, y in batches:
            loss = self._step(model, state, x, y)
            losses.append(loss.item())
        return losses
"""

JL009_BAD_GRAPH = """\
import torch

def replay(n, out):
    graph = torch.cuda.CUDAGraph()
    seen = []
    for _ in range(n):
        graph.replay()
        torch.cuda.current_stream().synchronize()
        seen.append(out.tolist())
    return seen
"""

JL009_GOOD_READ_AFTER_LOOP = """\
import numpy as np
import torch

predict = torch.compile(lambda x: x)

def serve(batches):
    handles = []
    for b in batches:
        handles.append(predict(b))
    return [h.cpu().numpy() for h in handles]
"""

JL009_GOOD_HOST_ARRAYS = """\
import numpy as np

def summarize(rows):
    out = []
    for r in rows:
        out.append(np.asarray(r).tolist())
    return out
"""

JL009_GOOD_PREFETCHED = """\
import torch

predict = torch.compile(lambda x: x)

def serve(x, rounds):
    logits = predict(x)
    for _ in range(rounds):
        print(logits.cpu().sum())
"""


def test_jl009_fires_on_host_reads_of_a_launch_output():
    assert_fires(JL009_BAD_CPU, "JL009", line=9)
    assert_fires(JL009_BAD_ASARRAY, "JL009", line=8)
    assert_fires(JL009_BAD_GRAPH, "JL009", line=8)
    assert_fires(JL009_BAD_SYNC, "JL009", line=7)
    assert_fires(JL009_BAD_WAIT, "JL009", line=5)
    assert_fires(JL009_BAD_ATTR_ITEM, "JL009", line=11)


def test_jl009_reports_a_chained_read_once():
    # out.tolist() reads a tensor no launch in the loop bound: only the
    # synchronize fires.  A chained read of a launch output is one finding.
    assert [f.line for f in findings_for(JL009_BAD_GRAPH, "JL009")] == [8]
    chained = JL009_BAD_CPU.replace("logits.cpu()", "logits.cpu().numpy()")
    assert [f.line for f in findings_for(chained, "JL009")] == [9]


def test_jl009_silent_on_the_pipelined_and_host_shapes():
    assert_silent(JL009_GOOD_READ_AFTER_LOOP, "JL009")
    assert_silent(JL009_GOOD_HOST_ARRAYS, "JL009")
    assert_silent(JL009_GOOD_PREFETCHED, "JL009")
    # A synchronize in a loop that launches nothing waits on nothing new.
    assert_silent(JL009_BAD_SYNC.replace("fused_int8_head(b, *qparams)", "print(b)"), "JL009")


def test_jl009_waiver():
    assert_silent(waived(JL009_BAD_CPU, "outs.append(logits.cpu())", "JL009"), "JL009")
    assert_silent(waived(JL009_BAD_WAIT, "out.append(result.wait())", "JL009"), "JL009")


# ---------------------------------------------------------------------------
# JL011 — host-blocking data feeds between launched step calls

JL011_BAD_NEXT = """\
import numpy as np
from pytorch_mnist_ddp_tpu_torch.parallel.ddp import make_train_step

step = make_train_step()

def train(model, state, it, n):
    for _ in range(n):
        batch = np.asarray(next(it))
        loss = step(model, state, batch)
    return state
"""

JL011_BAD_DIRECT_ARG = """\
import torch

step = torch.compile(lambda x: x)

def train(it):
    while True:
        step(next(it))
"""

JL011_BAD_ATTR = """\
import numpy as np
from pytorch_mnist_ddp_tpu_torch.parallel.ddp import make_train_step

class Trainer:
    def __init__(self):
        self._step = make_train_step()

    def run(self, model, state, host_batches):
        for _ in range(3):
            x = np.asarray(next(host_batches))
            self._step(model, state, x)
        return state
"""

JL011_GOOD_PREFETCHER = """\
import torch

step = torch.compile(lambda x: x)

def train(prefetcher):
    for x in prefetcher:
        step(x)
"""

JL011_GOOD_NEXT_ON_PREFETCHER = """\
import torch

step = torch.compile(lambda x: x)

def train(prefetcher, n):
    for _ in range(n):
        x = next(prefetcher)
        step(x)
"""

JL011_GOOD_UNRELATED_NEXT = """\
import numpy as np
import torch

step = torch.compile(lambda x: x)

def train(it, xs):
    for x in xs:
        meta = np.asarray(next(it))
        step(x)
        record(meta)
"""


def test_jl011_fires_on_materialized_feeds():
    assert_fires(JL011_BAD_NEXT, "JL011", line=8)
    assert_fires(JL011_BAD_DIRECT_ARG, "JL011", line=7)
    assert_fires(JL011_BAD_ATTR, "JL011", line=10)


def test_jl011_silent_on_prefetch_and_unrelated_feeds():
    assert_silent(JL011_GOOD_PREFETCHER, "JL011")
    assert_silent(JL011_GOOD_NEXT_ON_PREFETCHER, "JL011")
    assert_silent(JL011_GOOD_UNRELATED_NEXT, "JL011")
    # No launch target in the loop: a plain host loop.
    assert_silent(JL011_BAD_NEXT.replace("step = make_train_step()", "step = print"), "JL011")


def test_jl011_waiver():
    assert_silent(waived(JL011_BAD_NEXT, "batch = np.asarray(next(it))", "JL011"), "JL011")


# ---------------------------------------------------------------------------
# JL012 — per-replica engine construction without shared warm state

JL012_BAD_FACTORY = """\
import torch
from pytorch_mnist_ddp_tpu_torch.serving import InferenceEngine

engines = []
for i in range(torch.cuda.device_count()):
    engines.append(InferenceEngine.from_seed(buckets=(8,)))
"""


def test_jl012_fires_on_a_factory_in_a_loop():
    assert_fires(JL012_BAD_FACTORY, "JL012", line=6)
    assert_fires(JAX.JL012_BAD_CTOR, "JL012", line=6)


def test_jl012_silent_with_a_sharing_kwarg_or_outside_a_loop():
    for kwarg in ("aot_cache=store", "device=f'cuda:{i}'", "devices=[i]", "mesh=m"):
        assert_silent(JL012_BAD_FACTORY.replace("buckets=(8,)", f"buckets=(8,), {kwarg}"),
                      "JL012")
    assert_silent(JAX.JL012_GOOD_SINGLE, "JL012")


def test_jl012_waiver():
    assert_silent(waived(JL012_BAD_FACTORY,
                         "engines.append(InferenceEngine.from_seed(buckets=(8,)))", "JL012"),
                  "JL012")


# ---------------------------------------------------------------------------
# JL013 — swallowed dispatch errors in an unbounded retry loop

JL013_BAD_KERNEL = """\
from pytorch_mnist_ddp_tpu_torch.ops.flash_attention import flash_attention

def drive(stream):
    for q, k, v in stream:
        try:
            flash_attention(q, k, v)
        except:
            pass
"""

JL013_BAD_PROGRAM = """\
from pytorch_mnist_ddp_tpu_torch.compile import Program

class Rebuilder:
    def __init__(self):
        self._prog = Program("rung", ("int8_head",))

    def run_forever(self):
        while True:
            try:
                self._prog.build()
            except Exception:
                continue
"""


def test_jl013_fires_on_swallowed_launches():
    assert_fires(JAX.JL013_BAD_LAUNCH, "JL013", line=6)
    assert_fires(JL013_BAD_KERNEL, "JL013", line=7)
    assert_fires(JL013_BAD_PROGRAM, "JL013", line=11)


def test_jl013_silent_on_bounded_reraised_or_specific():
    assert_silent(JL013_BAD_KERNEL.replace("for q, k, v in stream:",
                                           "for attempt in range(3):"), "JL013")
    assert_silent(JL013_BAD_KERNEL.replace("pass", "raise"), "JL013")
    assert_silent(JL013_BAD_KERNEL.replace("except:", "except ValueError:"), "JL013")
    assert_silent(JL013_BAD_KERNEL.replace("flash_attention(q, k, v)", "process(q)"), "JL013")


def test_jl013_waiver():
    assert_silent(waived(JL013_BAD_KERNEL, "except:", "JL013"), "JL013")


# ---------------------------------------------------------------------------
# JL014 — non-atomic / uncadenced checkpoint writes

JL014_BAD_TORCH_SAVE = """\
import torch

def export(model):
    torch.save(model.state_dict(), "model.pt")
"""

JL014_BAD_UNCADENCED = """\
from pytorch_mnist_ddp_tpu_torch.utils.checkpoint import save_vit_train_state

def train(steps, state, path):
    for step in range(steps):
        state = update(state)
        save_vit_train_state(state, path)
"""


def test_jl014_fires_on_torn_and_uncadenced_writes():
    assert_fires(JL014_BAD_TORCH_SAVE, "JL014", line=4)
    assert_fires(JL014_BAD_UNCADENCED, "JL014", line=6)


def test_jl014_silent_on_the_atomic_helper_and_a_cadence():
    assert_silent(JL014_BAD_TORCH_SAVE.replace('"model.pt"', "buf"), "JL014")
    assert_silent(JL014_BAD_UNCADENCED.replace(
        "        save_vit_train_state(state, path)",
        "        if step % every == 0:\n            save_vit_train_state(state, path)"), "JL014")


def test_jl014_waiver():
    assert_silent(waived(JL014_BAD_TORCH_SAVE, 'torch.save(model.state_dict(), "model.pt")',
                         "JL014"), "JL014")


# ---------------------------------------------------------------------------
# JL015 — unbounded rendezvous / unsupervised training-script launches

JL015_BAD_INIT = """\
import torch.distributed as dist

def form_world(addr, n, rank):
    dist.init_process_group(
        "nccl", init_method=addr, world_size=n, rank=rank)
"""

JL015_GOOD_BOUNDED_RETRY = """\
import torch.distributed as dist

def form_world(addr, n, rank):
    for attempt in range(3):
        try:
            dist.init_process_group("nccl", init_method=addr, world_size=n, rank=rank)
            return
        except RuntimeError:
            continue
"""


def test_jl015_fires_on_a_bare_init_process_group_and_a_script_launch():
    assert_fires(JL015_BAD_INIT, "JL015", line=4)
    assert_fires(JAX.JL015_BAD_UNSUPERVISED_POPEN, "JL015", line=5)


def test_jl015_silent_with_a_timeout_or_a_bounded_retry():
    assert_silent(JL015_BAD_INIT.replace("rank=rank)", "rank=rank, timeout=td)"), "JL015")
    assert_silent(JL015_GOOD_BOUNDED_RETRY, "JL015")
    assert_silent(JAX.JL015_GOOD_SIGNAL_AWARE_LAUNCH, "JL015")


def test_jl015_waiver():
    assert_silent(waived(JL015_BAD_INIT, "rank=rank)", "JL015"), "JL015")


# ---------------------------------------------------------------------------
# JL016 — deadline-blind fixed linger in a dispatch loop

JL016_BAD_GRAPH_REPLAY = """\
import time
import torch

def serve(queue):
    graph = torch.cuda.CUDAGraph()
    while True:
        queue.get()
        time.sleep(0.002)
        graph.replay()
"""


def test_jl016_fires_on_a_fixed_linger():
    assert_fires(JAX.JL016_BAD_CONST_SLEEP, "JL016", line=6)
    assert_fires(JL016_BAD_GRAPH_REPLAY, "JL016", line=8)


def test_jl016_silent_when_deadline_aware_or_not_dispatching():
    assert_silent(JL016_BAD_GRAPH_REPLAY.replace("queue.get()", "req = queue.get()\n"
                                                 "        req.expired()"), "JL016")
    assert_silent(JL016_BAD_GRAPH_REPLAY.replace("graph.replay()", "print()"), "JL016")


def test_jl016_waiver():
    assert_silent(waived(JL016_BAD_GRAPH_REPLAY, "time.sleep(0.002)", "JL016"), "JL016")


# ---------------------------------------------------------------------------
# JL017, JL018 — network and JSON hot loops (the JAX fixtures, no JAX call)


def test_jl017_fires_silent_and_waives():
    assert_fires(JAX.JL017_BAD_RAW_RECV, "JL017", line=3)
    assert_silent(JAX.JL017_GOOD_RECV_WITH_SETTIMEOUT, "JL017")
    assert_silent(waived(JAX.JL017_BAD_RAW_RECV, "chunk = sock.recv(4096)", "JL017"), "JL017")


def test_jl018_fires_silent_and_waives():
    tensor_loop = JAX.JL018_BAD_SERVE_LOOP.replace("logits.tolist()", "logits.cpu().tolist()")
    assert_fires(tensor_loop, "JL018", line=6)
    assert_silent(JAX.JL018_GOOD_BINARY_WIRE, "JL018")
    assert_silent(waived(tensor_loop, 'body = json.dumps({"log_probs": logits.cpu().tolist()})',
                         "JL018"), "JL018")


# ---------------------------------------------------------------------------
# JL022 — weights loaded behind the registry (serving modules)

JL022_BAD_TORCH_LOAD = """\
import torch

def hot_reload(engine, path):
    state = torch.load(path)
    return engine.publish_weights(state)
"""

JL022_BAD_PORT_LOADER = """\
from ..utils.checkpoint import load_inference_state

def refresh(path):
    return load_inference_state(path)
"""


def test_jl022_fires_on_the_port_s_loaders():
    assert_fires(JL022_BAD_TORCH_LOAD, "JL022", line=4, path=SERVING_PATH)
    assert_fires(JL022_BAD_PORT_LOADER, "JL022", line=4, path=SERVING_PATH)


def test_jl022_silent_outside_serving_and_on_the_registry_idiom():
    assert_silent(JL022_BAD_TORCH_LOAD, "JL022", path="pytorch_mnist_ddp_tpu_torch/trainer.py")
    assert_silent(JAX.JL022_GOOD_REGISTRY_SURFACE, "JL022", path=SERVING_PATH)


def test_jl022_waiver():
    assert_silent(waived(JL022_BAD_PORT_LOADER, "return load_inference_state(path)", "JL022"),
                  "JL022", path=SERVING_PATH)


# ---------------------------------------------------------------------------
# JL023 — pow2 padding in a dispatch loop

JL023_BAD_F_PAD = """\
import torch.nn.functional as F
from pytorch_mnist_ddp_tpu_torch.serving.buckets import bucket_for

def serve(requests, predict, buckets):
    for x in requests:
        padded = F.pad(
            x, (0, 0, 0, bucket_for(len(x), buckets) - len(x))
        )
        predict(padded)
"""


def test_jl023_fires_on_an_inline_bucket_pad():
    assert_fires(JL023_BAD_F_PAD, "JL023", line=6)
    assert_fires(JAX.JL023_BAD_INLINE_POW2, "JL023", line=7)


def test_jl023_silent_on_a_constant_pad_or_a_bounded_replay():
    assert_silent(JL023_BAD_F_PAD.replace("bucket_for(len(x), buckets) - len(x)", "1"), "JL023")
    assert_silent(JL023_BAD_F_PAD.replace("for x in requests:", "for x in range(4):"), "JL023")


def test_jl023_waiver():
    assert_silent(JL023_BAD_F_PAD.replace(
        "        )\n        predict",
        "        )  # jaxlint: disable=JL023 -- fixture waiver\n        predict"), "JL023")


# ---------------------------------------------------------------------------
# JL024 — a sharded predict step over a mesh built in the loop

JL024_BAD_LOCKSTEP = """\
from pytorch_mnist_ddp_tpu_torch.parallel.mesh import Lockstep
from pytorch_mnist_ddp_tpu_torch.parallel.tp import make_tp_predict_step

def warm(devices, buckets, probe, params):
    for bucket in buckets:
        step = make_tp_predict_step(Lockstep(devices))
        step(params, probe[:bucket])
"""

JL024_BAD_BUILD_PREDICT_FN = """\
from pytorch_mnist_ddp_tpu_torch.serving import sharded
from pytorch_mnist_ddp_tpu_torch.serving.devices import ReplicaMesh

def warm(devices, kinds):
    for kind in kinds:
        mesh = ReplicaMesh(kind, 2, devices)
        fn = sharded.build_predict_fn(kind, lock=mesh)
"""


def test_jl024_fires_on_the_port_s_mesh_builders():
    assert_fires(JL024_BAD_LOCKSTEP, "JL024", line=6)
    assert_fires(JL024_BAD_BUILD_PREDICT_FN, "JL024", line=7)


def test_jl024_silent_on_a_threaded_mesh():
    assert_silent(JL024_BAD_LOCKSTEP.replace("make_tp_predict_step(Lockstep(devices))",
                                             "make_tp_predict_step(lock)"), "JL024")
    assert_silent(JAX.JL024_GOOD_MESH_OUTSIDE_LOOP, "JL024")


def test_jl024_waiver():
    assert_silent(waived(JL024_BAD_LOCKSTEP, "step = make_tp_predict_step(Lockstep(devices))",
                         "JL024"), "JL024")
    doc = type(rule_by_id("JL024")).__doc__
    assert "placed on their devices again" in doc and "streams" in doc


# ---------------------------------------------------------------------------
# Engine behaviour: waivers, overlapping paths, JL000, findings


def test_inline_waiver_is_counted_and_rule_specific():
    found, suppressed = ENGINE.check_source(waived(JL009_BAD_CPU, "outs.append(logits.cpu())",
                                                   "JL009"), "fixture.py")
    assert not found and suppressed == 1
    wrong = JL009_BAD_CPU.replace("outs.append(logits.cpu())",
                                  "outs.append(logits.cpu())  # jaxlint: disable=JL014 -- no")
    assert_fires(wrong, "JL009")


def test_waiver_all_file_wide_and_strings():
    assert_silent(JL009_BAD_CPU.replace("outs.append(logits.cpu())",
                                        "outs.append(logits.cpu())  # jaxlint: disable=ALL -- x"),
                  "JL009")
    assert_silent("# jaxlint: disable-file=JL009\n" + JL009_BAD_CPU, "JL009")
    assert_fires(JL009_BAD_CPU + '\nNOTE = "# jaxlint: disable=JL009"\n', "JL009")


def test_waiver_on_the_closing_line_of_a_multiline_call():
    src = JL015_BAD_INIT.replace("rank=rank)", "rank=rank)  # jaxlint: disable=JL015 -- fixture")
    found, suppressed = ENGINE.check_source(src, "fixture.py")
    assert not found and suppressed == 1


def test_overlapping_paths_lint_each_file_once(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(JL009_BAD_CPU)
    found, _ = ENGINE.run([str(bad), str(tmp_path), str(bad)])
    assert [f.rule_id for f in found] == ["JL009"]


def test_syntax_error_reports_jl000():
    found, _ = ENGINE.check_source("def broken(:\n", "bad.py")
    assert [f.rule_id for f in found] == ["JL000"]
    assert found[0].severity is Severity.ERROR


def test_findings_carry_location_and_serialize():
    d = findings_for(JL009_BAD_CPU, "JL009")[0].to_dict()
    assert d["path"] == "fixture.py" and d["rule"] == "JL009"
    assert d["line"] == 9 and d["col"] > 0 and d["severity"] == "warning"


# ---------------------------------------------------------------------------
# The CLI and the repo gate


@pytest.mark.lint
def test_cli_json_and_exit_codes(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(JL009_BAD_CPU)

    def run(*argv):
        return subprocess.run(
            [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.analysis", *argv],
            capture_output=True, text=True, cwd=ROOT, timeout=120,
        )

    proc = run(str(bad), "--json")
    assert proc.returncode == 0  # a warning passes without --fail-on-warning
    report = json.loads(proc.stdout)
    assert report["errors"] == 0 and report["warnings"] == 1 and report["suppressed"] == 0
    assert report["findings"][0]["rule"] == "JL009"
    assert run(str(bad), "--fail-on-warning").returncode == 1
    syntax = tmp_path / "syntax.py"
    syntax.write_text("def broken(:\n")
    assert run(str(syntax)).returncode == 1  # JL000 is an error
    assert run(str(tmp_path / "missing.py")).returncode == 2


def test_cli_list_and_select_rules(capsys):
    assert lint_main(["--list-rules"]) == 0
    listed = [line.split()[0] for line in capsys.readouterr().out.splitlines()]
    assert listed == [rule.rule_id for rule in ALL_RULES]
    assert lint_main(["--rules", "JL001"]) == 2  # not a rule of the port
    assert "unknown rule id" in capsys.readouterr().err


@pytest.mark.lint
def test_port_lints_clean():
    """``python -m pytorch_mnist_ddp_tpu_torch.analysis --fail-on-warning``
    exits 0: every finding in the port is fixed or carries a waiver with
    its reason."""
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.analysis", "--fail-on-warning"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.lint
def test_every_waiver_in_the_port_gives_its_reason():
    pkg = ROOT / "pytorch_mnist_ddp_tpu_torch"
    waivers = [(p, line) for p in pkg.rglob("*.py") for line in p.read_text().splitlines()
               if "# jaxlint: disable" in line and p.parent.name != "analysis"]
    assert waivers
    for path, line in waivers:
        reason = line.split("# jaxlint: disable", 1)[1].partition(" -- ")[2]
        assert len(reason.split()) >= 3, f"{path.relative_to(ROOT)}: {line.strip()}"
