"""Sharded serving replicas (``serving/sharded.py``): the port against the
JAX package's, on the CPU.

The JAX replicas run over conftest's 8 virtual devices, one ``shard_map``
a replica; the port's over a list of 8 ``cpu`` entries, one controller
stepping ``k`` shards.  The weights are the JAX package's seed-init trees
carried across (``utils/convert.py``), the inputs seeded numpy rows.  At
JAX's kinds (``tests/test_sharded.py`` ``KINDS``):

- every kind's logits within 1e-5 of JAX's sharded forward, argmax
  identical, at the edge shapes (1, 16 and 40 rows over buckets 8 and 16);
- the gate's own comparison at the bucket shape on the port's side at
  ``SHARDED_PARITY_TOL`` (pp exactly 0.0, against the single-device
  forward run a microbatch at a time), and the edge rows within 1e-5 of
  the reference on the raw rows;
- EP's ``expert_load`` equal to JAX's, with headroom and at the capacity
  edge, where the gate must breach visibly (and the same tokens drop as in
  JAX); the refusal while unverified; the packed mask;
- the pool's plans, refusals (JAX's words), ladder floor and topology.

``test_predict_config_carries_shard_kind`` and
``test_sharded_warm_start_is_pure_aot_hits`` of tests/test_sharded.py have
no counterpart here: the port's store holds kernel libraries, not
per-rung executables, and this path launches none.

One intra-op thread.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu.parallel import mesh as jmesh
from pytorch_mnist_ddp_tpu.serving import sharded as jshard
from pytorch_mnist_ddp_tpu.serving.engine import InferenceEngine as JaxEngine
from pytorch_mnist_ddp_tpu.serving.pool import EnginePool as JaxPool
from pytorch_mnist_ddp_tpu.utils.rng import root_key, split_streams
from pytorch_mnist_ddp_tpu_torch.serving import sharded
from pytorch_mnist_ddp_tpu_torch.serving.devices import (
    parse_replica_shapes,
    plan_replica_meshes,
    replica_mesh,
)
from pytorch_mnist_ddp_tpu_torch.serving.engine import (
    InferenceEngine,
    ParityError,
    UnverifiedVariantError,
)
from pytorch_mnist_ddp_tpu_torch.serving.metrics import ServingMetrics
from pytorch_mnist_ddp_tpu_torch.serving.pool import EnginePool
from pytorch_mnist_ddp_tpu_torch.utils.convert import torch_state_from_jax, torch_vit_state_from_jax

KINDS = [("tp", 4), ("vtp", 4), ("ep", 2), ("pp", 2)]
CPU8 = [torch.device("cpu")] * 8
BUCKETS = (8, 16)
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rows(n: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed).rand(n, 28, 28, 1).astype(np.float32)


def _port_cfg(kind, capacity_factor=None):
    cfg = sharded.default_vit_cfg(kind) if kind in ("vtp", "ep") else None
    if cfg is not None and capacity_factor is not None:
        cfg = cfg._replace(capacity_factor=capacity_factor)
    return cfg


def _jax_cfg(kind, capacity_factor=None):
    cfg = jshard.default_vit_cfg(kind) if kind in ("vtp", "ep") else None
    if cfg is not None and capacity_factor is not None:
        cfg = cfg._replace(capacity_factor=capacity_factor)
    return cfg


@pytest.fixture(scope="module")
def weights():
    """Per family, the JAX seed-1 tree and the port's state dict of it."""
    key = split_streams(root_key(1))["init"]
    out = {}
    for kind in ("tp", "vtp", "ep"):
        params = jax.device_get(jshard.seed_params(kind, key, _jax_cfg(kind)))
        state = (torch_vit_state_from_jax(params) if kind != "tp"
                 else torch_state_from_jax(params))
        out[kind] = (params, state)
    out["pp"] = out["tp"]
    return out


def _jax_engine(weights, kind, k, buckets=BUCKETS, capacity_factor=None, **kw):
    eng = JaxEngine({"params": weights[kind][0]}, mesh=jmesh.replica_mesh(kind, k, jax.devices()[:k]),
                    buckets=buckets, shard_kind=kind, vit_cfg=_jax_cfg(kind, capacity_factor), **kw)
    eng.warmup()  # the rungs compile concurrently
    return eng


def _port_engine(weights, kind, k, buckets=BUCKETS, capacity_factor=None, **kw):
    eng = InferenceEngine(weights[kind][1], mesh=replica_mesh(kind, k, CPU8), buckets=buckets,
                          shard_kind=kind, vit_cfg=_port_cfg(kind, capacity_factor), **kw)
    eng.warmup()
    return eng


@pytest.fixture(scope="module")
def engines(weights):
    """(jax, port) gated engines per kind."""
    def gated_jax(kind, k):
        eng = _jax_engine(weights, kind, k)
        eng.verify_sharded_parity(raise_on_failure=True)
        return eng

    with ThreadPoolExecutor(len(KINDS)) as pool:  # XLA compiles outside the GIL
        jax_engines = [pool.submit(gated_jax, kind, k) for kind, k in KINDS]
        out = {}
        for (kind, k), jax_eng in zip(KINDS, jax_engines):
            port_eng = _port_engine(weights, kind, k)
            port_eng.verify_sharded_parity(raise_on_failure=True)
            out[kind] = (jax_eng.result(), port_eng)
    return out


# -- replica meshes and plans ---------------------------------------------------


@pytest.mark.parametrize("kind, k", [("dp", 1), *KINDS])
def test_replica_mesh_axes_match_jax(kind, k):
    cards = [torch.device("cuda", i) for i in range(8)]
    want = jmesh.replica_mesh(kind, k, jax.devices()[:k])
    got = replica_mesh(kind, k, cards)
    assert (got.data, got.model) == (want.shape["data"], want.shape["model"])
    assert [d.index for d in got.devices] == [d.id for d in want.devices.flat]
    assert got.kind == kind and got.k == len(got.devices) == k


@pytest.mark.parametrize("args", [("pp", 3, 8), ("tp", 4, 2), ("zz", 2, 8)])
def test_replica_mesh_refusals_are_jax_words(args):
    kind, k, n = args
    with pytest.raises(ValueError) as want:
        jmesh.replica_mesh(kind, k, jax.devices()[:n])
    with pytest.raises(ValueError) as got:
        replica_mesh(kind, k, CPU8[:n])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec, n", [("tp4,dp,dp,dp,dp", 8), ("ep2,pp2,dp", 5),
                                     ("dp,dp,dp", 2), ("tp4,tp4,dp", 8), ("vtp2,dp", 2)])
def test_plans_take_jax_blocks(spec, n):
    cards = [torch.device("cuda", i) for i in range(n)]
    try:
        want = [(kind, k, [d.id for d in m.devices.flat])
                for kind, k, m in jmesh.plan_replica_meshes(jmesh.parse_replica_shapes(spec),
                                                            jax.devices()[:n])]
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            plan_replica_meshes(parse_replica_shapes(spec), cards)
        assert str(got.value) == str(e)
        return
    got = [(kind, k, [d.index for d in m.devices])
           for kind, k, m in plan_replica_meshes(parse_replica_shapes(spec), cards)]
    assert got == want


# -- the forwards against JAX's, and the gate -----------------------------------


@pytest.mark.parametrize("kind", [kind for kind, _ in KINDS])
def test_sharded_logits_match_jax_at_edge_shapes(engines, kind):
    jax_eng, port_eng = engines[kind]
    for n, seed in ((1, 1), (16, 2), (40, 3)):
        x = _rows(n, seed)
        want = jax_eng.predict_logits(x)
        got = port_eng.predict_logits(x)
        assert np.max(np.abs(got - want)) <= TOL, (kind, n)
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


@pytest.mark.parametrize("kind", [kind for kind, _ in KINDS])
def test_gate_at_the_bucket_and_edges_against_the_reference(engines, kind):
    jax_eng, port_eng = engines[kind]
    rep = port_eng.verify_sharded_parity(raise_on_failure=True)
    assert rep["passed"] and rep["argmax_identical"] and rep["rows"] == 16
    assert rep["max_abs_logit_diff"] <= sharded.SHARDED_PARITY_TOL[kind]
    assert rep["tolerance"] == jshard.SHARDED_PARITY_TOL[kind]
    if kind == "pp":
        assert rep["max_abs_logit_diff"] == 0.0
        assert jax_eng.parity_report["f32"]["max_abs_logit_diff"] == 0.0
    ref = sharded.reference_fn(kind, port_eng._vit_cfg)
    for n, seed in ((1, 4), (16, 5), (40, 6)):
        x = _rows(n, seed)
        got = port_eng.predict_logits(x)
        want = ref(port_eng._host_served, torch.from_numpy(x)).numpy()
        assert np.max(np.abs(got - want)) <= TOL, (kind, n)
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_pp_full_batch_anchor_is_within_the_edge_bound(engines):
    """The gate holds pp to the single-device forward a microbatch at a time
    (0.0); the same forward over the whole bucket differs from it only in
    the last bits where a GEMM's answer moves with the row count."""
    _, eng = engines["pp"]
    x, _ = eng._parity_slice()
    xt = torch.from_numpy(x)
    micro = sharded.reference_fn("pp", None, eng.pp_microbatches)(eng._host_served, xt).numpy()
    whole = sharded.reference_fn("pp", None)(eng._host_served, xt).numpy()
    got = eng._run_variant(eng._variants["f32"], x).numpy()
    assert np.array_equal(got, micro)
    assert np.max(np.abs(whole - micro)) <= TOL
    np.testing.assert_array_equal(whole.argmax(1), micro.argmax(1))


@pytest.mark.parametrize("capacity_factor", [None, 1.0])
def test_expert_load_and_drops_equal_jax(weights, engines, capacity_factor):
    """EP's per-expert kept-token counts equal JAX's exactly, and so do the
    tokens dropped at the capacity edge (the logits agree there too)."""
    if capacity_factor is None:
        jax_eng, port_eng = engines["ep"]
    else:
        jax_eng = _jax_engine(weights, "ep", 2, buckets=(16,), capacity_factor=capacity_factor)
        port_eng = _port_engine(weights, "ep", 2, buckets=(16,), capacity_factor=capacity_factor)
    x = _rows(16, 7)
    want = np.asarray(jax_eng._run_variant(jax_eng._variants["f32"], x))
    got = port_eng._run_variant(port_eng._variants["f32"], x).numpy()
    want_load = np.asarray(jax_eng._pending_expert_load)
    got_load = port_eng._pending_expert_load.wait()
    assert got_load.dtype == np.float32 and got_load.shape == (4,)
    np.testing.assert_array_equal(got_load, want_load)
    assert np.max(np.abs(got - want)) <= TOL
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
    if capacity_factor is not None:  # tokens dropped: fewer kept than routed
        assert got_load.sum() < 2 * 16 * 16


def test_ep_capacity_edge_is_a_visible_parity_breach(weights):
    eng = _port_engine(weights, "ep", 2, buckets=(16,), capacity_factor=1.0)
    rep = eng.verify_sharded_parity()
    assert not rep["passed"]
    with pytest.raises(UnverifiedVariantError):
        eng.predict_logits(_rows(4, 8))


def test_unverified_sharded_engine_refuses_to_serve(weights):
    eng = _port_engine(weights, "tp", 4, buckets=(8,))
    with pytest.raises(UnverifiedVariantError):
        eng.predict_logits(_rows(4, 9))
    rep = eng.verify_sharded_parity(raise_on_failure=True)
    assert rep["passed"] and rep["argmax_identical"]
    assert eng.predict_logits(_rows(4, 9)).shape == (4, 10)


def test_parity_gate_bites(engines):
    _, eng = engines["tp"]
    try:
        with pytest.raises(ParityError):
            eng.verify_sharded_parity(tol=-1.0, raise_on_failure=True)
        with pytest.raises(UnverifiedVariantError):
            eng.predict_logits(_rows(4, 10))
    finally:
        eng.verify_sharded_parity(raise_on_failure=True)


def test_ep_expert_load_metrics(weights):
    metrics = ServingMetrics()
    eng = _port_engine(weights, "ep", 2, buckets=(16,), metrics=metrics)
    eng.verify_sharded_parity(raise_on_failure=True)
    eng.flush_expert_load()
    for seed in (11, 12, 13):
        eng.predict_logits(_rows(16, seed))
    eng.flush_expert_load()
    loads = [metrics.registry.gauge("serving_expert_load", expert=str(e)).value
             for e in range(eng._vit_cfg.num_experts)]
    assert sum(loads) == 16 * 16 * 2  # the last batch's tokens over both blocks, none dropped
    assert sharded.expert_imbalance(np.array(loads)) >= 1.0


@pytest.mark.parametrize("kind, k", KINDS)
def test_packed_sharded_engine_masks_padding(weights, kind, k):
    eng = _port_engine(weights, kind, k, buckets=(8, 32), packed=True)
    eng.verify_sharded_parity(raise_on_failure=True)
    assert eng.buckets == (32,)
    x = np.zeros((32, 28, 28, 1), np.float32)
    x[:5] = _rows(5, 14)
    seg = np.full(32, -1, np.int32)
    seg[:3], seg[3:5] = 0, 1
    out = eng.launch(x, 5, seg_ids=seg).wait()
    assert np.all(out[5:] == 0.0)
    want = sharded.reference_fn(kind, eng._vit_cfg)(eng._host_served,
                                                    torch.from_numpy(x[:5])).numpy()
    assert np.max(np.abs(out[:5] - want)) <= TOL


# -- engine refusals (JAX's words) ----------------------------------------------


REFUSALS = {
    "dtypes": ("tp", 4, "tp", dict(dtypes=("bf16",))),
    "bn": ("tp", 4, "bn", {}),
    "conv_impl": ("tp", 4, "tp", dict(conv_impl="im2col")),
    "family_tp": ("tp", 4, "vtp", {}),
    "family_vtp": ("vtp", 4, "tp", {}),
    "family_ep_dense": ("ep", 2, "vtp", {}),
    "family_vtp_moe": ("vtp", 4, "ep", {}),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_engine_refusals_are_jax_words(weights, case):
    kind, k, family, kw = REFUSALS[case]
    jax_params, state = weights["tp" if family == "bn" else family]
    if family == "bn":
        from pytorch_mnist_ddp_tpu.models.net import init_variables

        variables = jax.device_get(init_variables(jax.random.PRNGKey(0), use_bn=True))
        state = dict(state, **{f"bn{i}.{leaf}": torch.ones(c) for i, c in ((1, 32), (2, 64))
                               for leaf in ("weight", "bias")})
    else:
        variables = {"params": jax_params}
    with pytest.raises(ValueError) as want:
        JaxEngine(variables, mesh=jmesh.replica_mesh(kind, k, jax.devices()[:k]), buckets=(8,),
                  shard_kind=kind, **kw)
    with pytest.raises(ValueError) as got:
        InferenceEngine(state, mesh=replica_mesh(kind, k, CPU8), buckets=(8,), shard_kind=kind, **kw)
    assert str(got.value) == str(want.value)


def test_sharded_replica_refuses_a_weight_publish(engines, weights):
    _, eng = engines["tp"]
    with pytest.raises(ValueError, match="weight publish into a sharded"):
        eng.publish_weights(weights["tp"][1])


# -- heterogeneous pools ----------------------------------------------------------


def test_pool_plans_shapes_and_gates_sharded_replicas():
    m = ServingMetrics()
    pool = EnginePool.from_seed(replicas=5, replica_shapes="tp4,dp,dp,dp,dp", devices=CPU8,
                                buckets=(8,), metrics=m)
    assert [e.shard_kind for e in pool.engines] == ["tp", "dp", "dp", "dp", "dp"]
    pool.warmup(parallel=False)
    assert pool.engines[0].predict_logits(_rows(4, 15)).shape == (4, 10)
    assert m.registry.gauge("serving_shard_devices", replica="r0").value == 4
    assert m.registry.gauge("serving_shard_devices", replica="r1").value == 1


POOL_REFUSALS = [
    dict(replicas=2, replica_shapes="tp4,vtp4"),
    dict(replicas=2, replica_shapes="vtp4,ep2"),
    dict(replicas=3, replica_shapes="dp,dp"),
    dict(replicas=2, replica_shapes="tp4,dp", dtypes=("bf16",)),
    dict(replicas=1, replica_shapes="pp2", buckets=(5,)),
    dict(replica_shapes="tp4,tp4,dp"),
]


@pytest.mark.parametrize("kw", POOL_REFUSALS, ids=[kw["replica_shapes"] for kw in POOL_REFUSALS])
def test_pool_refusals_are_jax_words(kw):
    with pytest.raises(ValueError) as want:
        JaxPool.from_seed(**kw)
    with pytest.raises(ValueError) as got:
        EnginePool.from_seed(devices=CPU8, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec, kw", [("ep2", {}), ("ep4,ep4", {}), ("pp2,dp", {}),
                                      ("pp2", dict(pp_microbatches=4)),
                                      ("ep2", dict(packed=True, max_bucket=16))])
def test_pool_ladder_floor_matches_jax(spec, kw):
    jax_pool = JaxPool.from_seed(replica_shapes=spec, **kw)
    pool = EnginePool.from_seed(replica_shapes=spec, devices=CPU8, **kw)
    assert pool.buckets == tuple(jax_pool.buckets)
    assert all(e.buckets == pool.buckets for e in pool.engines)


def test_pool_topology_event_and_router():
    class Sink:
        def __init__(self):
            self.events = []

        def emit(self, name, **fields):
            self.events.append((name, fields))

    sink, m = Sink(), ServingMetrics()
    pool = EnginePool.from_seed(replicas=2, replica_shapes="tp4,dp", devices=CPU8, buckets=(8,),
                                metrics=m)
    pool.warmup(parallel=False, sink=sink)
    assert [f["shard_kind"] for n, f in sink.events if n == "parity_gate"] == ["tp"]
    router = pool.start(router_policy="cost", sink=sink, linger_ms=1.0)
    try:
        topo = [f for n, f in sink.events if n == "pool_topology"]
        assert topo[0]["replicas"] == {
            "r0": {"shard_kind": "tp", "devices": 4},
            "r1": {"shard_kind": "dp", "devices": 1},
        }
        for seed in range(4):
            assert router.submit(_rows(3, 20 + seed)).result().shape == (3, 10)
    finally:
        pool.stop()


def test_ep_pool_reports_expert_load_at_stop():
    class Sink:
        def __init__(self):
            self.events = []

        def emit(self, name, **fields):
            self.events.append((name, fields))

    sink, m = Sink(), ServingMetrics()
    pool = EnginePool.from_seed(replica_shapes="ep2", devices=CPU8, buckets=(8,), metrics=m)
    assert set(m.expert_load_snapshot()) == {"0", "1", "2", "3"}  # registered up front
    pool.warmup(parallel=False, sink=sink)
    router = pool.start(router_policy="cost", sink=sink, linger_ms=1.0)
    try:
        assert router.submit(_rows(8, 30)).result().shape == (8, 10)
    finally:
        pool.stop()
    [(_, event)] = [(n, f) for n, f in sink.events if n == "expert_load"]
    assert sum(event["loads"].values()) == 2 * 8 * 16
    assert event["imbalance"] == sharded.expert_imbalance(list(event["loads"].values()))
