"""The port's InferenceEngine on the CPU, held against the JAX reference.

Carried-across JAX seed-1 weights, buckets (1, 2, 4, 8), f32 + int8,
bucketed and packed.  f32 log-probs match JAX ``Net().apply`` within 1e-5;
int8 ones match JAX ``int8_forward`` within 1e-5 (chunks of at most 8
rows, where the two frameworks' convolutions flip no int8 code on these
inputs; see tests/test_torch_quant.py for larger batches).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from pytorch_mnist_ddp_tpu.data.transforms import normalize as jax_normalize
from pytorch_mnist_ddp_tpu.models import quant as jq
from pytorch_mnist_ddp_tpu.models.net import Net as JaxNet
from pytorch_mnist_ddp_tpu.models.net import init_params
from pytorch_mnist_ddp_tpu.serving import buckets as jax_buckets
from pytorch_mnist_ddp_tpu.utils.checkpoint import model_state_dict, save_state_dict
from pytorch_mnist_ddp_tpu.utils.rng import root_key, split_streams
from pytorch_mnist_ddp_tpu_torch.models.net import INPUT_SHAPE
from pytorch_mnist_ddp_tpu_torch.serving import buckets
from pytorch_mnist_ddp_tpu_torch.serving.buckets import segment_ids
from pytorch_mnist_ddp_tpu_torch.serving.engine import (
    PARITY_SEED,
    InferenceEngine,
    UnverifiedVariantError,
)
from pytorch_mnist_ddp_tpu_torch.serving.metrics import ServingMetrics
from pytorch_mnist_ddp_tpu_torch.utils.convert import torch_state_from_jax

BUCKETS = (1, 2, 4, 8)
TOL = 1e-5
MAX_N = 20


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(init_params(split_streams(root_key(1))["init"]))


@pytest.fixture(scope="module")
def state(jax_params):
    return torch_state_from_jax(jax_params)


@pytest.fixture(scope="module")
def engines(state):
    out = {}
    for packed in (False, True):
        engine = InferenceEngine(
            state, device="cpu", buckets=BUCKETS, dtypes=("int8",),
            packed=packed, metrics=ServingMetrics(),
        )
        engine.warmup()
        engine.verify_parity()
        out[packed] = engine
    return out


@pytest.fixture(scope="module")
def inputs():
    raw = np.random.RandomState(11).randint(0, 256, (MAX_N, 28, 28)).astype(np.uint8)
    return jax_normalize(raw)


@pytest.fixture(scope="module")
def jax_outputs(jax_params, inputs):
    """JAX log-probs per row, computed in the engine's chunk sizes (rows
    are independent, so a chunk's rows equal the whole batch's)."""
    qparams = jq.quantize_params(jax_params)
    f32 = np.asarray(JaxNet().apply({"params": jax_params}, inputs))
    int8 = np.concatenate([
        np.asarray(jq.int8_forward(qparams, inputs[i : i + 8]))
        for i in range(0, MAX_N, 8)
    ])
    return {"f32": f32, "int8": int8}


@pytest.mark.parametrize("packed", [False, True], ids=["bucketed", "packed"])
def test_warmup_runs_every_rung(engines, packed):
    engine = engines[packed]
    assert engine.warmed
    assert engine.buckets == ((8,) if packed else BUCKETS)
    assert engine.dtypes == ("f32", "int8")


@pytest.mark.parametrize("packed", [False, True], ids=["bucketed", "packed"])
def test_parity_gate_passes_with_jax_numbers(engines, jax_params, packed):
    report = engines[packed].parity_report["int8"]
    assert report["passed"] and report["argmax_identical"] and report["rows"] == 8
    raw = np.random.RandomState(PARITY_SEED).randint(0, 256, (8, 28, 28))
    x = jax_normalize(raw.astype(np.uint8))
    ref = np.asarray(JaxNet().apply({"params": jax_params}, x))
    q = np.asarray(jq.int8_forward(jq.quantize_params(jax_params), x))
    want = float(np.abs(q - ref).max())
    assert abs(report["max_abs_logit_diff"] - want) <= TOL


@pytest.mark.parametrize("n", range(1, MAX_N + 1))
@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("packed", [False, True], ids=["bucketed", "packed"])
def test_predict_logits_matches_jax(engines, inputs, jax_outputs, packed, dtype, n):
    got = engines[packed].predict_logits(inputs[:n], dtype=dtype)
    want = jax_outputs[dtype][:n]
    assert got.shape == (n, 10) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert (got.argmax(1) == want.argmax(1)).all()


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_packed_equals_bucketed(engines, inputs, dtype):
    a = engines[False].predict_logits(inputs, dtype=dtype)
    b = engines[True].predict_logits(inputs, dtype=dtype)
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    assert (a.argmax(1) == b.argmax(1)).all()


def test_packed_launch_masks_padding_segments(engines, inputs):
    engine = engines[True]
    staged = np.zeros((8, *INPUT_SHAPE), np.float32)
    staged[:5] = inputs[:5]
    out = engine.launch(staged, 5, seg_ids=segment_ids([2, 3], 8)).wait()
    assert not out[5:].any()
    np.testing.assert_array_equal(out[:5], engine.predict_logits(inputs[:5]))


def test_unverified_variant_is_refused(state, inputs):
    engine = InferenceEngine(state, device="cpu", buckets=(1, 2), dtypes=("int8",))
    assert not engine.variant_verified("int8")
    with pytest.raises(UnverifiedVariantError):
        engine.predict_logits(inputs[:2], dtype="int8")
    assert engine.predict_logits(inputs[:2]).shape == (2, 10)  # f32 serves
    report = engine.verify_parity(tol={"int8": 0.0})["int8"]
    assert not report["passed"] and report["tolerance"] == 0.0
    assert not engine.variant_verified("int8")
    with pytest.raises(UnverifiedVariantError):
        engine.launch(np.zeros((2, *INPUT_SHAPE), np.float32), 2, dtype="int8")


@pytest.mark.parametrize(
    "kwargs, match",
    [
        ({"dtypes": ("fp8",)}, "unknown serving dtype"),
        ({"buckets": (3,)}, "power of two"),
        ({"buckets": (2,), "max_bucket": 4}, "not both"),
    ],
)
def test_engine_rejects_bad_config(state, kwargs, match):
    with pytest.raises(ValueError, match=match):
        InferenceEngine(state, device="cpu", **kwargs)


def test_launch_validates_its_batch(engines):
    engine = engines[False]
    with pytest.raises(ValueError, match="not a warmed bucket"):
        engine.launch(np.zeros((3, *INPUT_SHAPE), np.float32), 3)
    with pytest.raises(ValueError, match="bucketed engine"):
        engine.launch(np.zeros((2, *INPUT_SHAPE), np.float32), 2, seg_ids=np.zeros(2))
    with pytest.raises(ValueError, match="expected"):
        engine.predict_logits(np.zeros((2, 28, 28), np.float32))


def test_from_checkpoint_and_digest(engines, state, jax_params, tmp_path):
    path = str(tmp_path / "m.npz")
    save_state_dict(model_state_dict(jax_params), path, format="npz")
    engine = InferenceEngine.from_checkpoint(path, device="cpu", buckets=(1,))
    assert engine.weights_digest == engines[False].weights_digest
    changed = dict(state)
    changed["fc2.bias"] = state["fc2.bias"] + 1.0
    other = InferenceEngine(changed, device="cpu", buckets=(1,))
    assert other.weights_digest != engine.weights_digest


def test_from_seed_is_deterministic():
    a = InferenceEngine.from_seed(3, device="cpu", buckets=(1,))
    b = InferenceEngine.from_seed(3, device="cpu", buckets=(1,))
    c = InferenceEngine.from_seed(4, device="cpu", buckets=(1,))
    assert a.weights_digest == b.weights_digest != c.weights_digest


def test_metrics_record_dispatch_occupancy(state, inputs):
    metrics = ServingMetrics()
    engine = InferenceEngine(state, device="cpu", buckets=(4,), metrics=metrics)
    engine.predict_logits(inputs[:3])
    snap = metrics.snapshot()
    assert snap["batches"] == 1
    assert snap["samples"] == {"real": 3, "dispatched": 4}
    assert snap["batch_occupancy_pct"] == pytest.approx(75.0)


@pytest.mark.parametrize(
    "name, args",
    [
        ("pow2_buckets", (128,)),
        ("pow2_buckets", (100,)),
        ("validate_buckets", ((8, 1, 4, 4, 2),)),
        ("packed_capacities", (128,)),
        ("packed_capacities", (100,)),
        ("segment_ids", ((2, 3, 1), 8)),
        ("bucket_for", (5, (1, 2, 4, 8))),
        ("pad_to_bucket", (np.arange(6, dtype=np.float32).reshape(3, 2), 4)),
    ],
)
def test_bucket_helpers_match_jax(name, args):
    jax_args = ((1, *args) if name == "pow2_buckets" else args)
    want = getattr(jax_buckets, name)(*jax_args)
    got = getattr(buckets, name)(*args)
    assert np.array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize(
    "name, args",
    [("validate_buckets", ((3,),)), ("validate_buckets", ((),)),
     ("segment_ids", ((5, 5), 8)), ("bucket_for", (9, (1, 2, 4, 8))),
     ("pad_to_bucket", (np.zeros((5, 2)), 4))],
)
def test_bucket_helpers_reject_like_jax(name, args):
    with pytest.raises(ValueError):
        getattr(jax_buckets, name)(*args)
    with pytest.raises(ValueError):
        getattr(buckets, name)(*args)


def test_an_answer_moves_with_its_bucket_no_more_than_in_jax(jax_params, state):
    """Does an answer depend on the bucket it is served in?  The same 16
    seeded rows through each package's engine at bucket 16, and at bucket
    128 both zero-padded and beside 112 other rows; the port's spread
    between the two buckets, f32 and int8, stays within JAX's own.  (On
    this CPU both spreads are 0.0: the card's cuDNN sums differ by batch
    shape, which the CPU cannot show.)"""
    from pytorch_mnist_ddp_tpu.parallel.mesh import make_mesh
    from pytorch_mnist_ddp_tpu.serving.engine import InferenceEngine as JaxEngine

    jax_engine = JaxEngine({"params": jax_params}, mesh=make_mesh(1, devices=jax.devices()[:1]),
                           buckets=(16, 128), dtypes=("int8",))
    port = InferenceEngine(state, device="cpu", buckets=(16, 128), dtypes=("int8",))
    for engine in (jax_engine, port):
        engine.warmup()
        engine.verify_parity()
    raw = np.random.RandomState(5).randint(0, 256, (128, 28, 28)).astype(np.uint8)
    x = jax_normalize(raw)
    padded = np.zeros_like(x)
    padded[:16] = x[:16]

    def served(engine, staged, dtype):
        out = engine.launch(staged.copy(), 16, dtype=dtype)
        return np.asarray(out.wait() if hasattr(out, "wait") else out)[:16]

    for dtype in ("f32", "int8"):
        spread = {}
        for name, engine in (("jax", jax_engine), ("port", port)):
            small = served(engine, x[:16], dtype)
            spread[name] = max(float(np.abs(served(engine, big, dtype) - small).max())
                               for big in (padded, x))
        assert spread["port"] <= spread["jax"], (dtype, spread)
