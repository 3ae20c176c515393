"""The port's model registry and rollout controller held against the JAX
package's on the CPU.

- A registry directory written by either package loads in the other: the
  manifests are byte for byte the same for the same publishes, every
  entry's digest is re-verified on load by both, and a checkpoint swapped
  behind the manifest is refused by both.
- The same transitions (route, canary, swap, rollback, the canary's
  breaker, the drift probe) on both packages' controllers, each over its
  own engine of the same weights, give the same descriptions, the same
  routes for the same payloads and the same events; refusals read alike.
"""

from __future__ import annotations

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu.models.net import init_params, init_variables
from pytorch_mnist_ddp_tpu.parallel.mesh import make_mesh
from pytorch_mnist_ddp_tpu.serving import registry as jreg
from pytorch_mnist_ddp_tpu.serving import rollout as jroll
from pytorch_mnist_ddp_tpu.serving.cache import ResponseCache as JaxCache
from pytorch_mnist_ddp_tpu.serving.engine import InferenceEngine as JaxEngine
from pytorch_mnist_ddp_tpu.serving.metrics import ServingMetrics as JaxMetrics
from pytorch_mnist_ddp_tpu.utils import checkpoint as jckpt
from pytorch_mnist_ddp_tpu.utils.rng import root_key, split_streams
from pytorch_mnist_ddp_tpu_torch.serving import registry as preg
from pytorch_mnist_ddp_tpu_torch.serving import rollout as proll
from pytorch_mnist_ddp_tpu_torch.serving.cache import ResponseCache
from pytorch_mnist_ddp_tpu_torch.serving.engine import InferenceEngine, weights_digest
from pytorch_mnist_ddp_tpu_torch.serving.metrics import ServingMetrics
from pytorch_mnist_ddp_tpu_torch.utils import checkpoint as pckpt


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(seed: int):
    return jax.device_get(init_params(split_streams(root_key(seed))["init"]))


def _bn_variables():
    return jax.device_get(init_variables(jax.random.PRNGKey(5), use_bn=True))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """JAX-written checkpoints: v1 a torch .pt, v2 an npz, bn a --syncbn .pt."""
    d = tmp_path_factory.mktemp("ckpts")
    paths = {"v1": str(d / "v1.pt"), "v2": str(d / "v2.npz"), "bn": str(d / "bn.pt")}
    jckpt.save_state_dict(jckpt.model_state_dict(_params(1)), paths["v1"])
    jckpt.save_state_dict(jckpt.model_state_dict(_params(2)), paths["v2"], format="npz")
    bn = _bn_variables()
    jckpt.save_state_dict(jckpt.model_state_dict(bn["params"], batch_stats=bn["batch_stats"],
                                                 num_batches=3), paths["bn"])
    return paths


def _publish(mod, directory, checkpoints):
    """The same publishes into a fresh registry directory: files copied in,
    so the manifest records them relative."""
    os.makedirs(directory, exist_ok=True)
    reg = mod.ModelRegistry(directory)
    for name, model, version in (("v1", "mnist", "v1"), ("v2", "mnist", "v2"),
                                 ("bn", "mnist_bn", "v1")):
        path = os.path.join(directory, os.path.basename(checkpoints[name]))
        shutil.copyfile(checkpoints[name], path)
        reg.publish(model, version, path, parity={"int8": {"passed": True}}
                    if name == "v1" else None)
    return reg


def test_manifests_are_byte_equal_and_cross_load(tmp_path, checkpoints):
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    _publish(jreg, jax_dir, checkpoints)
    _publish(preg, port_dir, checkpoints)
    manifest = lambda d: open(jckpt.registry_manifest_path(d), "rb").read()  # noqa: E731
    assert manifest(port_dir) == manifest(jax_dir)
    for reader, writer in ((preg, jax_dir), (jreg, port_dir), (preg, port_dir)):
        reg = reader.ModelRegistry(writer)
        assert reg.models() == ["mnist", "mnist_bn"] and reg.versions("mnist") == ["v1", "v2"]
        entry = reg.resolve()
        assert (entry.model, entry.version) == ("mnist", "v1")
        for model, version in (("mnist", "v1"), ("mnist", "v2"), ("mnist_bn", "v1")):
            reg.load(reg.resolve(model, version))  # the digest re-verified
    port = preg.ModelRegistry(jax_dir)
    for model, version in (("mnist", "v2"), ("mnist_bn", "v1")):
        entry = port.resolve(model, version)
        assert weights_digest(port.load(entry)) == entry.digest
    assert port.describe()["models"] == jreg.ModelRegistry(jax_dir).describe()["models"]


def test_manifest_bytes_and_refusals_equal_jax(tmp_path):
    manifest = {"default_model": "m", "models": {"m": {"default_version": "a", "versions": {}}}}
    for mod, d in ((jckpt, tmp_path / "j"), (pckpt, tmp_path / "p")):
        os.makedirs(d)
        mod.save_registry_manifest(manifest, str(d))
    assert (tmp_path / "p" / "registry.json").read_bytes() == \
        (tmp_path / "j" / "registry.json").read_bytes()
    for payload, match in ((b"{not json", "not valid JSON"), (b"[1]", "JSON object"),
                           (json.dumps({"format": 2}).encode(), "format-2")):
        (tmp_path / "p" / "registry.json").write_bytes(payload)
        with pytest.raises(ValueError, match=match):
            pckpt.load_registry_manifest(str(tmp_path / "p"))
        with pytest.raises(ValueError, match=match):
            jckpt.load_registry_manifest(str(tmp_path / "p"))
    with pytest.raises(FileNotFoundError):
        pckpt.load_registry_manifest(str(tmp_path))


def test_a_checkpoint_swapped_behind_the_manifest_is_refused(tmp_path, checkpoints):
    d = str(tmp_path / "reg")
    _publish(jreg, d, checkpoints)
    # Overwrite v1's file with v2's weights, keeping the manifest.
    jckpt.save_state_dict(jckpt.model_state_dict(_params(2)), os.path.join(d, "v1.pt"))
    for mod in (jreg, preg):
        reg = mod.ModelRegistry(d)
        with pytest.raises(mod.RegistryError, match="changed behind the manifest"):
            reg.load(reg.resolve())
        reg.load(reg.resolve("mnist", "v2"))


def test_publish_and_resolve_refusals_read_as_jax(tmp_path, checkpoints):
    d = str(tmp_path / "reg")
    regs = {"jax": _publish(jreg, d + "j", checkpoints), "port": _publish(preg, d + "p",
                                                                          checkpoints)}
    messages = {}
    for name, reg in regs.items():
        out = []
        for call in (lambda r: r.publish("mnist", "v@3", checkpoints["v1"]),
                     lambda r: r.publish("", "v3", checkpoints["v1"]),
                     lambda r: r.resolve("nope"),
                     lambda r: r.resolve("mnist", "v9"),
                     lambda r: r.versions("nope"),
                     lambda r: r.set_default("mnist", "v9")):
            with pytest.raises(ValueError) as err:
                call(reg)
            out.append(str(err.value))
        messages[name] = out
    assert messages["port"] == messages["jax"]


# -- rollout: the same transitions on both packages' controllers ---------------------


class _Sink:
    def __init__(self):
        self.events = []

    def emit(self, event, **fields):
        self.events.append((event, fields))

    def __bool__(self):
        return True


@pytest.fixture()
def stacks(tmp_path, checkpoints):
    """(registry, engine, controller, cache, sink) per package over copies of
    one registry directory; engines at bucket 4, f32 + int8."""
    out = {}
    jax_dir = str(tmp_path / "jax")
    _publish(jreg, jax_dir, checkpoints)
    port_dir = str(tmp_path / "port")
    shutil.copytree(jax_dir, port_dir)
    mesh = make_mesh(1, devices=jax.devices()[:1])
    for name, reg_mod, roll_mod, d in (("jax", jreg, jroll, jax_dir),
                                       ("port", preg, proll, port_dir)):
        reg, sink = reg_mod.ModelRegistry(d), _Sink()
        entry = reg.resolve()
        if name == "jax":
            metrics = JaxMetrics()
            engine = JaxEngine(reg.load(entry), mesh=mesh, buckets=(4,), dtypes=("int8",),
                               int8_impl="dot", metrics=metrics, version=entry.version)
            cache = JaxCache(8, model_digest=engine.weights_digest)
        else:
            metrics = ServingMetrics()
            engine = InferenceEngine(reg.load(entry), device="cpu", buckets=(4,),
                                     dtypes=("int8",), metrics=metrics, version=entry.version)
            cache = ResponseCache(8, model_digest=engine.weights_digest)
        engine.warmup()
        engine.verify_parity()
        ctl = roll_mod.RolloutController(reg, engine, cache=cache, metrics=metrics, sink=sink)
        out[name] = (reg, engine, ctl, cache, sink)
    return out


def _payloads(n=200):
    rs = np.random.RandomState(9)
    return [rs.bytes(64) for _ in range(n)]


def _routes(ctl, payloads):
    return [(r.model, r.version, r.canary, r.pinned, r.dtype_key("f32"))
            for r in (ctl.route(payload=p) for p in payloads)]


def test_canary_swap_rollback_transitions_equal_jax(stacks):
    payloads = _payloads()
    seen = {}
    for name, (reg, engine, ctl, cache, sink) in stacks.items():
        log = [ctl.describe(), _routes(ctl, payloads[:20])]
        log.append(ctl.start_canary("v2", 25.0))
        log.append(_routes(ctl, payloads))
        log.append(sorted(engine.dtypes))
        pinned = ctl.route(version="v2")
        log.append((pinned.canary, pinned.pinned, pinned.dtype_key("int8")))
        log.append(ctl.set_canary_pct(50.0))
        log.append(ctl.rollback(reason="operator"))
        log.append((sorted(engine.dtypes), cache.stats()["generation"]))
        log.append(ctl.swap("v2"))
        log.append((reg.resolve().version, cache.model_digest == engine.weights_digest,
                    cache.stats()["generation"]))
        log.append(ctl.start_canary("v1", 10.0))
        log.append(ctl.swap("v1"))  # promotes the live canary
        log.append(sorted(engine.dtypes))
        log.append([(e, {k: v for k, v in f.items() if k != "digest"}) for e, f in sink.events
                    if e != "canary_divergence"])
        seen[name] = log
    assert seen["port"] == seen["jax"]
    assert any(route[2] for route in seen["port"][3])  # some payloads took the canary


def test_the_canary_breaker_and_the_drift_probe_roll_back_as_jax(stacks):
    outs = {}
    for name, (reg, engine, ctl, cache, sink) in stacks.items():
        ctl.start_canary("v2", 100.0)
        route = ctl.route(payload=b"x")
        for _ in range(3):
            ctl.observe(route, ok=False, latency_s=0.01)
        after = ctl.describe()
        ctl.divergence_budget = 0.0
        ctl.start_canary("v2", 5.0)
        outs[name] = (after, ctl.describe(),
                      [f.get("reason") for e, f in sink.events if e == "rollback"],
                      [(f["drifted"], f["argmax_identical"]) for e, f in sink.events
                       if e == "canary_divergence"])
    assert outs["port"] == outs["jax"]
    assert outs["port"][2] == ["canary_error_budget", "parity_drift"]


def test_rollout_refusals_read_as_jax(stacks):
    messages = {}
    for name, (reg, engine, ctl, cache, sink) in stacks.items():
        out = []
        for call in (lambda: ctl.rollback(), lambda: ctl.start_canary("v2", 0.0),
                     lambda: ctl.start_canary("v1", 5.0), lambda: ctl.route(version="v2"),
                     lambda: ctl.swap("v1", model="mnist_bn"),
                     lambda: ctl.route(model="mnist_bn"), lambda: ctl.set_canary_pct(5.0)):
            with pytest.raises(ValueError) as err:
                call()
            out.append(str(err.value))
        messages[name] = out
    assert messages["port"] == messages["jax"]


def test_divergence_and_digests_after_a_swap_match_jax(stacks):
    probes = {}
    for name, (reg, engine, ctl, cache, sink) in stacks.items():
        ctl.start_canary("v2", 25.0)
        probe = ctl.check_divergence()
        ctl.swap("v2")
        probes[name] = (probe, engine.weights_digest, reg.resolve().digest)
    (jp, jd, je), (pp, pd, pe) = probes["jax"], probes["port"]
    assert pd == jd == pe == je
    assert pp["argmax_identical"] == jp["argmax_identical"] and pp["rows"] == jp["rows"]
    assert abs(pp["max_abs_logit_diff"] - jp["max_abs_logit_diff"]) <= 1e-5
