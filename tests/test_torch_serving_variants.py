"""The port's serving variants held against the JAX package's engine on the
CPU: bf16 (the ``--dtypes`` variant and the ``--bf16`` default), int8
under both ``--int8-impl`` heads, ``--conv-impl``, BatchNorm checkpoints,
the weights digest, versioned weights (publish, install, remove,
divergence), and the serving CLI's flag refusals and lines.

Tolerances: f32 logits within 1e-5 (the frameworks' convolutions differ
in the last ulp); bf16 within 1e-2 with identical argmax (measured on
the 10 seeded rows: 5.5e-4, the two frameworks rounding their bf16
convolutions apart; f32 2.4e-7); int8 log-probs of both heads within 5e-4
of JAX's (measured 2.4e-7), their head outputs bit-exact given the same
features (the int32 products are exact).  The digest, the refusals' texts and the CLI's
error lines are equal.  JAX engines sit on a one-device mesh at buckets
1, 2, 4, built once a module.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu.data.transforms import normalize as jax_normalize
from pytorch_mnist_ddp_tpu.models import quant as jq
from pytorch_mnist_ddp_tpu.models.net import init_params, init_variables
from pytorch_mnist_ddp_tpu.parallel.mesh import make_mesh
from pytorch_mnist_ddp_tpu.serving.engine import InferenceEngine as JaxEngine
from pytorch_mnist_ddp_tpu.utils.rng import root_key, split_streams
from pytorch_mnist_ddp_tpu_torch.models.quant import (
    int8_head_dot,
    quantize_params,
)
from pytorch_mnist_ddp_tpu_torch.obs.events import read_events
from pytorch_mnist_ddp_tpu_torch.ops.int8_head import fused_int8_head
from pytorch_mnist_ddp_tpu_torch.serving.__main__ import main as cli_main
from pytorch_mnist_ddp_tpu_torch.serving.engine import VERSION_SEP, InferenceEngine
from pytorch_mnist_ddp_tpu_torch.utils.checkpoint import _torch_stats
from pytorch_mnist_ddp_tpu_torch.utils.convert import (
    nchw_to_nhwc_feature_perm,
    torch_state_from_jax,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BUCKETS = (1, 2, 4)
F32_TOL, BF16_TOL, INT8_TOL = 1e-5, 1e-2, 5e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(1, devices=jax.devices()[:1])


def _params(seed: int):
    return jax.device_get(init_params(split_streams(root_key(seed))["init"]))


@pytest.fixture(scope="module")
def jax_params():
    return _params(1)


@pytest.fixture(scope="module")
def state(jax_params):
    return torch_state_from_jax(jax_params)


@pytest.fixture(scope="module")
def x():
    raw = np.random.RandomState(14).randint(0, 256, (10, 28, 28)).astype(np.uint8)
    return jax_normalize(raw)


@pytest.fixture(scope="module")
def jax_engine(jax_params, mesh):
    engine = JaxEngine({"params": jax_params}, mesh=mesh, buckets=BUCKETS,
                       dtypes=("bf16", "int8"), int8_impl="dot")
    engine.warmup()
    assert all(r["passed"] for r in engine.verify_parity().values())
    return engine


@pytest.fixture(scope="module")
def engines(state):
    out = {}
    for impl in ("pallas", "dot"):
        engine = InferenceEngine(state, device="cpu", buckets=BUCKETS,
                                 dtypes=("bf16", "int8"), int8_impl=impl)
        engine.warmup()
        assert all(r["passed"] for r in engine.verify_parity().values())
        out[impl] = engine
    return out


def test_weights_digest_equals_jax(engines, jax_engine):
    assert engines["pallas"].weights_digest == jax_engine.weights_digest
    assert engines["dot"].weights_digest == jax_engine.weights_digest


def test_gates_read_what_jax_reads(engines, jax_engine):
    port, jax_report = engines["pallas"].parity_report, jax_engine.parity_report
    for dtype in ("bf16", "int8"):
        assert port[dtype]["rows"] == jax_report[dtype]["rows"] == 4
        assert port[dtype]["tolerance"] == jax_report[dtype]["tolerance"]
        assert port[dtype]["argmax_identical"] and jax_report[dtype]["argmax_identical"]


def test_bf16_within_1e2_of_jax_with_identical_argmax(engines, jax_engine, x):
    want = jax_engine.predict_logits(x, dtype="bf16")
    got = engines["pallas"].predict_logits(x, dtype="bf16")
    assert np.abs(got - want).max() <= BF16_TOL
    assert (got.argmax(1) == want.argmax(1)).all()
    np.testing.assert_allclose(engines["pallas"].predict_logits(x),
                               jax_engine.predict_logits(x), rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("impl", ["pallas", "dot"])
def test_int8_log_probs_within_5e4_of_jax(engines, jax_engine, x, impl):
    want = jax_engine.predict_logits(x, dtype="int8")
    got = engines[impl].predict_logits(x, dtype="int8")
    assert np.abs(got - want).max() <= INT8_TOL
    assert (got.argmax(1) == want.argmax(1)).all()


def test_dot_and_pallas_engines_agree_bit_for_bit(engines, x):
    np.testing.assert_array_equal(engines["dot"].predict_logits(x, dtype="int8"),
                                  engines["pallas"].predict_logits(x, dtype="int8"))


@pytest.mark.parametrize("n", [1, 3, 17, 40])
def test_both_heads_bit_exact_to_jax_on_the_same_features(jax_params, state, n):
    """JAX's conv features (NHWC flatten) through JAX's ``_int8_dense``
    head, and the same features in NCHW order through the port's ``dot``
    head and the kernel's plain version."""
    feats = np.random.RandomState(n).uniform(0, 3, (n, 9216)).astype(np.float32)
    feats[:, ::7] = 0.0  # relu zeros
    jqp = jq.quantize_params(jax_params)
    want = np.asarray(jq._int8_dense(jax.nn.relu(jq._int8_dense(feats, jqp["fc1"])),
                                     jqp["fc2"]))
    q = quantize_params(state)
    port_feats = torch.from_numpy(feats[:, nchw_to_nhwc_feature_perm()])
    for head in (int8_head_dot, fused_int8_head):
        got = head(q["fc1"], q["fc2"], port_feats).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("conv_impl", ["im2col_c1", "im2col"])
def test_conv_impl_engines_match_jax(jax_params, state, mesh, x, conv_impl):
    jax_engine = JaxEngine({"params": jax_params}, mesh=mesh, buckets=(4,), conv_impl=conv_impl)
    port = InferenceEngine(state, device="cpu", buckets=(4,), conv_impl=conv_impl)
    np.testing.assert_allclose(port.predict_logits(x), jax_engine.predict_logits(x),
                               rtol=0, atol=F32_TOL)


def test_bf16_default_forward_matches_jax(jax_params, state, mesh, x):
    jax_engine = JaxEngine({"params": jax_params}, mesh=mesh, buckets=(4,),
                           compute_dtype=jnp.bfloat16)
    port = InferenceEngine(state, device="cpu", buckets=(4,), compute_dtype=torch.bfloat16)
    want, got = jax_engine.predict_logits(x), port.predict_logits(x)
    assert np.abs(got - want).max() <= BF16_TOL and (got.argmax(1) == want.argmax(1)).all()
    assert port.dtypes == ("f32",)  # the default variant, in bf16


def _bn_variables():
    variables = jax.device_get(init_variables(jax.random.PRNGKey(3), use_bn=True))
    rs = np.random.RandomState(3)
    stats = {layer: {"mean": rs.normal(0, 0.1, v["mean"].shape).astype(np.float32),
                     "var": rs.uniform(1, 1.5, v["var"].shape).astype(np.float32)}
             for layer, v in variables["batch_stats"].items()}
    return {"params": variables["params"], "batch_stats": stats}


def test_batchnorm_checkpoints_serve_at_f32_and_bf16(mesh, x):
    variables = _bn_variables()
    state = {**torch_state_from_jax(variables["params"]),
             **_torch_stats(variables["batch_stats"])}
    jax_engine = JaxEngine(variables, mesh=mesh, buckets=(4,), dtypes=("bf16",))
    port = InferenceEngine(state, device="cpu", buckets=(4,), dtypes=("bf16",))
    assert port.use_bn and port.weights_digest == jax_engine.weights_digest
    jax_engine.verify_parity()
    assert port.verify_parity()["bf16"]["passed"]
    np.testing.assert_allclose(port.predict_logits(x), jax_engine.predict_logits(x),
                               rtol=0, atol=F32_TOL)
    want, got = jax_engine.predict_logits(x, dtype="bf16"), port.predict_logits(x, dtype="bf16")
    assert np.abs(got - want).max() <= BF16_TOL and (got.argmax(1) == want.argmax(1)).all()
    with pytest.raises(ValueError) as jax_err:
        JaxEngine(variables, mesh=mesh, buckets=(4,), dtypes=("int8",))
    with pytest.raises(ValueError) as port_err:
        InferenceEngine(state, device="cpu", buckets=(4,), dtypes=("int8",))
    assert str(port_err.value) == str(jax_err.value)


def test_missing_running_averages_start_where_jax_starts(mesh, x):
    params = _bn_variables()["params"]
    jax_engine = JaxEngine({"params": params}, mesh=mesh, buckets=(4,))
    port = InferenceEngine(torch_state_from_jax(params), device="cpu", buckets=(4,))
    assert port.weights_digest == jax_engine.weights_digest
    np.testing.assert_allclose(port.predict_logits(x), jax_engine.predict_logits(x),
                               rtol=0, atol=F32_TOL)


def test_refusals_read_as_jax_reads_them(jax_params, state, mesh):
    cases = [
        (dict(dtypes=("int8",), compute_dtype=jnp.bfloat16),
         dict(dtypes=("int8",), compute_dtype=torch.bfloat16)),
        (dict(int8_impl="tensorrt"), dict(int8_impl="tensorrt")),
    ]
    for jax_kwargs, port_kwargs in cases:
        with pytest.raises(ValueError) as want:
            JaxEngine({"params": jax_params}, mesh=mesh, buckets=(1,), **jax_kwargs)
        with pytest.raises(ValueError) as got:
            InferenceEngine(state, device="cpu", buckets=(1,), **port_kwargs)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="conv_impl"):
        InferenceEngine(state, device="cpu", buckets=(1,), conv_impl="winograd")


def test_versioned_weights_match_jax(jax_params, state, mesh, x):
    """publish_weights, install_version, version_divergence and
    remove_version on both packages' engines, from the same weights."""
    v2 = _params(2)
    jax_engine = JaxEngine({"params": jax_params}, mesh=mesh, buckets=(4,), dtypes=("int8",),
                           int8_impl="dot")
    port = InferenceEngine(state, device="cpu", buckets=(4,), dtypes=("int8",))
    for engine in (jax_engine, port):
        engine.warmup()
        engine.verify_parity()
    old_model = port._variants["f32"].params
    old_weight = old_model.fc2.weight.clone()
    digest = port.install_version("v2", torch_state_from_jax(v2))
    assert digest == jax_engine.install_version("v2", {"params": v2})
    assert port.dtypes == jax_engine.dtypes == ("f32", "int8", "f32@v2", "int8@v2")
    jax_div, port_div = jax_engine.version_divergence("v2"), port.version_divergence("v2")
    assert port_div["argmax_identical"] == jax_div["argmax_identical"]
    assert abs(port_div["max_abs_logit_diff"] - jax_div["max_abs_logit_diff"]) <= F32_TOL
    np.testing.assert_allclose(port.predict_logits(x, dtype="f32@v2"),
                               jax_engine.predict_logits(x, dtype="f32@v2"),
                               rtol=0, atol=F32_TOL)
    assert port.remove_version("v2") == jax_engine.remove_version("v2") == 2
    digest = port.publish_weights(torch_state_from_jax(v2), version="v2")
    assert digest == jax_engine.publish_weights({"params": v2}, version="v2")
    assert port.weights_digest == digest and port.version == "v2"
    # A swap replaces references: the tensors a batch in flight reads stay.
    assert port._variants["f32"].params is not old_model
    assert torch.equal(old_model.fc2.weight, old_weight)
    for dtype in ("f32", "int8"):
        np.testing.assert_allclose(port.predict_logits(x, dtype=dtype),
                                   jax_engine.predict_logits(x, dtype=dtype),
                                   rtol=0, atol=F32_TOL if dtype == "f32" else INT8_TOL)
    bn = _bn_variables()
    with pytest.raises(ValueError) as want:
        jax_engine.publish_weights(bn)
    with pytest.raises(ValueError) as got:
        port.publish_weights({**torch_state_from_jax(bn["params"]),
                              **_torch_stats(bn["batch_stats"])})
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="free of '@'"):
        port.install_version(f"v{VERSION_SEP}3", state)


# -- the CLI -----------------------------------------------------------------------


CLI_ERRORS = [
    ["--bf16", "--dtypes", "f32,int8"],
    ["--qos-weights", "interactive=0,premium=2"],
    ["--qos-weights", "bogus"],
    ["--registry", "r", "--checkpoint", "c.pt"],
    ["--canary", "5"],
    ["--registry", "r", "--canary", "150"],
    ["--response-cache", "0"],
]


def test_cli_refusals_print_the_jax_lines(capsys):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": "", "PYTHONPATH": str(ROOT)}
    procs = [subprocess.Popen([sys.executable, "-m", "pytorch_mnist_ddp_tpu.serving", *argv],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.DEVNULL, text=True) for argv in CLI_ERRORS]
    for argv, proc in zip(CLI_ERRORS, procs):
        out = proc.communicate(timeout=300)[0]
        want = [line for line in out.splitlines() if line.startswith("error:")]
        assert cli_main(["--device", "cpu", *argv]) == proc.returncode == 2
        got = [line for line in capsys.readouterr().out.splitlines()
               if line.startswith("error:")]
        assert got == want and len(want) == 1, argv


def test_cli_warmup_only_gates_every_variant_with_telemetry(tmp_path):
    tel = tmp_path / "tel"
    proc = subprocess.run(
        [sys.executable, "-m", "pytorch_mnist_ddp_tpu_torch.serving", "--device", "cpu",
         "--warmup-only", "--buckets", "1,2,4", "--dtypes", "f32,bf16,int8",
         "--int8-impl", "dot", "--conv-impl", "im2col", "--telemetry-dir", str(tel)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert "warming buckets [1, 2, 4] x dtypes ['f32', 'bf16', 'int8'] serially on cpu" in lines
    assert sum(" ready (" in line for line in lines) == 9
    assert any(line.startswith("parity gate [bf16]: PASS") for line in lines)
    assert any(line.startswith("parity gate [int8]: PASS") for line in lines)
    assert any(line.startswith("serving telemetry: ") for line in lines)
    events = read_events(next(tel.glob("*.jsonl")))
    assert any(e["event"] == "span_end" and e["span"] == "warmup" for e in events)
    assert sorted(e["dtype"] for e in events if e["event"] == "parity_gate") == ["bf16", "int8"]
    assert json.dumps(events)  # plain JSON throughout
