"""The int8 head kernel's split of K over a thread-block cluster, on the CPU.

The kernel (``csrc/int8_head.cu``) gives each block of a cluster one
K-slice of fc1: it forms each row's max|x| from the slices' maxima,
quantizes its slice, takes an int32 partial product, and the partials are
summed across the cluster before fc1's epilogue.  No kernel runs here:

- (a) the launch plan (``_launch_plan``) covers every row and every K
  column exactly once, with clusters of at most 16 blocks and every K-slice
  but a ragged last one a whole number of 32-column chunks;
- (b) a numpy model of the split, driven by the plan, is bit-equal to the
  plain version and to JAX's ``_int8_dense`` -> relu -> ``_int8_dense``,
  with the partials summed in rank order and in reverse.  ``fmaxf`` is
  order-free and int32 sums of int8 products are exact, which is why.

The kernel itself is held to the plain version bit for bit by
``chip_smoke.py`` on the card.
"""

from __future__ import annotations

import re

import jax
import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu.models import quant as jq
from pytorch_mnist_ddp_tpu.models.net import init_params
from pytorch_mnist_ddp_tpu.utils.rng import root_key, split_streams
from pytorch_mnist_ddp_tpu_torch.models import quant as tq
from pytorch_mnist_ddp_tpu_torch.ops import _build
from pytorch_mnist_ddp_tpu_torch.ops import int8_head as ih
from pytorch_mnist_ddp_tpu_torch.utils.convert import (
    nchw_to_nhwc_feature_perm,
    torch_state_from_jax,
)

PERM = nchw_to_nhwc_feature_perm()
# Clusters the card runs at once, per cluster size: 16 and 8 as an H100
# SXM reports them at the model's shape (the smaller sizes, which fit only
# smaller shapes, assumed), and a card that refuses the non-portable 16.
OCCUPANCY = {
    "h100": {16: 7, 8: 15, 4: 33, 2: 66, 1: 132},
    "portable_only": {16: 0, 8: 15, 4: 33, 2: 66, 1: 132},
}
QMAX = np.float32(127.0)


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(init_params(split_streams(root_key(1))["init"]))


@pytest.fixture(scope="module")
def jax_q(jax_params):
    return jq.quantize_params(jax_params)


@pytest.fixture(scope="module")
def port_q(jax_params):
    return tq.quantize_params(torch_state_from_jax(jax_params))


# ---------------------------------------------------------------- (a) plan


@pytest.mark.parametrize("occupancy", sorted(OCCUPANCY))
@pytest.mark.parametrize("k", [9216, 1040])
@pytest.mark.parametrize("n", [1, 2, 8, 16, 17, 64, 128, 130, 300])
def test_launch_plan_covers_rows_and_columns_once(n, k, occupancy):
    plan = ih._launch_plan(n, k, 128, 10, OCCUPANCY[occupancy])
    c, tiles = plan["grid"]
    assert c == plan["cluster"] <= 16 and OCCUPANCY[occupancy][c] >= 1
    assert plan["rows"] == ih.ROWS == 16
    assert (tiles - 1) * ih.ROWS < n <= tiles * ih.ROWS  # every row, one tile each
    slices = ih._k_slices(k, c)
    covered = np.concatenate([np.arange(c0, c1) for c0, c1 in slices])
    assert np.array_equal(covered, np.arange(k))  # every column once, in order
    for c0, c1 in slices[:-1]:
        assert c0 % 32 == 0 and (c1 - c0) % 32 == 0 and c1 > c0
    c0, c1 = slices[-1]
    assert c0 % 32 == 0 and (c1 - c0) % 16 == 0 and c1 > c0
    assert max(c1 - c0 for c0, c1 in slices) <= plan["slice"] <= ih.MAX_SLICE
    assert plan["smem"] == ih._smem_bytes(k, 128, 10, c) <= ih.SMEM_LIMIT


def test_launch_plan_model_shape_fills_the_card_once():
    """At the model's shape a cluster of 16 blocks owns 576 columns, and at
    n = 128 the eight row tiles run in one wave where 8 clusters fit."""
    plan = ih._launch_plan(128, 9216, 128, 10, {16: 8, 8: 16})
    assert plan["cluster"] == 16 and plan["slice"] == 576 and plan["waves"] == 1
    plan = ih._launch_plan(8, 9216, 128, 10, OCCUPANCY["h100"])
    assert plan["grid"] == (16, 1)
    # Without the non-portable size the plan takes 8, two slices' worth each.
    plan = ih._launch_plan(8, 9216, 128, 10, OCCUPANCY["portable_only"])
    assert plan["cluster"] == 8 and plan["slice"] == 1152


@pytest.mark.parametrize("k, h", [(4 * 9216, 128), (9216, 2048)])
def test_launch_plan_raises_beyond_the_kernel(k, h):
    """A K-slice must fit the registers (1152 columns at 16 rows) and a
    block its 227 KB of shared memory; beyond that the wrapper raises."""
    with pytest.raises(ValueError, match="no cluster size"):
        ih._launch_plan(8, k, h, 10, OCCUPANCY["h100"])


def test_plan_constants_match_the_kernel_source():
    src = (_build.CSRC / "int8_head.cu").read_text()
    const = {m.group(1): int(m.group(2))
             for m in re.finditer(r"constexpr int (\w+) = (\d+);", src)}
    assert const["R"] == ih.ROWS
    assert const["HEADER"] == ih._HEADER
    assert const["MAX_CLUSTER"] == max(ih.CLUSTER_SIZES)
    assert 4 * 32 * const["MAXC"] == ih.MAX_SLICE


# ------------------------------------------------------- (b) split model


def _act_scale(a_max: np.ndarray) -> np.ndarray:
    return np.where(a_max > 0, a_max / QMAX, np.float32(1.0)).astype(np.float32)


def _quant(x: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(x / scale), -QMAX, QMAX).astype(np.int8)


def _split_head(fc1: dict, fc2: dict, x: np.ndarray, reverse: bool) -> np.ndarray:
    """The kernel's arithmetic in numpy, f32 step by step: per row tile, per
    K-slice row maxima and codes and int32 partials, summed over the ranks
    (in reverse when asked); rank 0's fc2 on the whole hidden row."""
    w1, s1, b1 = (np.asarray(fc1[key]) for key in ("weight_q", "scale", "bias"))
    w2, s2, b2 = (np.asarray(fc2[key]) for key in ("weight_q", "scale", "bias"))
    n, k = x.shape
    plan = ih._launch_plan(n, k, w1.shape[0], w2.shape[0], OCCUPANCY["h100"])
    slices = ih._k_slices(k, plan["cluster"])
    out = np.empty((n, w2.shape[0]), np.float32)
    for t in range(plan["grid"][1]):
        tile = np.zeros((ih.ROWS, k), np.float32)  # rows past n are zero
        rows = x[t * ih.ROWS:(t + 1) * ih.ROWS]
        tile[:len(rows)] = rows
        maxima = [np.abs(tile[:, c0:c1]).max(axis=1) for c0, c1 in slices]
        a1 = _act_scale(np.maximum.reduce(maxima[::-1] if reverse else maxima))[:, None]
        partials = [_quant(tile[:, c0:c1], a1).astype(np.int32)
                    @ w1[:, c0:c1].astype(np.int32).T for c0, c1 in slices]
        acc = np.zeros_like(partials[0])
        for p in partials[::-1] if reverse else partials:
            acc += p
        hid = np.maximum(acc.astype(np.float32) * (a1 * s1) + b1, np.float32(0.0))
        a2 = _act_scale(np.abs(hid).max(axis=1))[:, None]
        acc2 = _quant(hid, a2).astype(np.int32) @ w2.astype(np.int32).T
        y = acc2.astype(np.float32) * (a2 * s2) + b2
        out[t * ih.ROWS:(t + 1) * ih.ROWS] = y[:len(rows)]
    return out


def _features(n: int, seed: int) -> np.ndarray:
    """Post-relu/maxpool-like features (non-negative) in JAX (NHWC) order."""
    return np.abs(np.random.RandomState(seed).randn(n, 9216)).astype(np.float32)


def _edge_case(case: str) -> np.ndarray:
    """``tests/test_torch_quant.py``'s edge cases, in JAX (NHWC) order."""
    x = _features(4, seed=7)
    if case == "zero_row":
        x[1] = 0.0
    else:
        sign = -1.0 if case == "negative_ties" else 1.0
        x[:, 0] = 127.0
        x[:, 1:] = sign * (np.arange(9215) % 100 + 0.5).astype(np.float32)
    return x


def _check_split(jax_q, port_q, x_jax: np.ndarray) -> None:
    x = np.ascontiguousarray(x_jax[:, PERM])  # the port's NCHW column order
    plain = ih.int8_head_reference(port_q["fc1"], port_q["fc2"], torch.from_numpy(x)).numpy()
    want = np.asarray(jq._int8_dense(jax.nn.relu(jq._int8_dense(x_jax, jax_q["fc1"])),
                                     jax_q["fc2"]))
    assert plain.tobytes() == want.tobytes()
    for reverse in (False, True):
        got = _split_head(port_q["fc1"], port_q["fc2"], x, reverse)
        assert got.shape == want.shape
        assert got.tobytes() == plain.tobytes()


@pytest.mark.parametrize("n", [1, 3, 16, 17, 130])
def test_split_model_bit_equal(jax_q, port_q, n):
    _check_split(jax_q, port_q, _features(n, seed=500 + n))


@pytest.mark.parametrize("case", ["zero_row", "ties", "negative_ties"])
def test_split_model_edge_cases_bit_equal(jax_q, port_q, case):
    _check_split(jax_q, port_q, _edge_case(case))


@pytest.mark.parametrize("n", [5, 130])
def test_split_model_ragged_last_slice(n):
    """k = 1040 ends inside a 32-column chunk: the last rank's slice is 80
    columns.  Random int8 weights; JAX's _int8_dense on the same layers."""
    rng = np.random.RandomState(n)
    k, h, o = 1040, 128, 10
    layers = []
    for out_w, in_w in ((h, k), (o, h)):
        layers.append({
            "weight_q": torch.from_numpy(rng.randint(-127, 128, (out_w, in_w)).astype(np.int8)),
            "scale": torch.from_numpy((rng.rand(out_w) * 1e-2).astype(np.float32)),
            "bias": torch.from_numpy(rng.randn(out_w).astype(np.float32)),
        })
    fc1, fc2 = layers
    assert ih._k_slices(k, 16)[-1] == (960, 1040)
    x = rng.randn(n, k).astype(np.float32)
    plain = ih.int8_head_reference(fc1, fc2, torch.from_numpy(x)).numpy()
    jl = [{"kernel_q": np.asarray(layer["weight_q"]).T, "scale": np.asarray(layer["scale"]),
           "bias": np.asarray(layer["bias"])} for layer in layers]
    want = np.asarray(jq._int8_dense(jax.nn.relu(jq._int8_dense(x, jl[0])), jl[1]))
    assert plain.tobytes() == want.tobytes()
    for reverse in (False, True):
        assert _split_head(fc1, fc2, x, reverse).tobytes() == plain.tobytes()


def _quant_fast(v: np.ndarray, scale: np.float32) -> np.ndarray:
    """The kernel's ``quant4_fast``: multiply by the rounded reciprocal,
    round half to even, and take the IEEE division only within 2^-14 of a
    rounding tie (or where the product is not finite)."""
    y = v * (np.float32(1.0) / scale)
    d = y - np.rint(y)
    with np.errstate(invalid="ignore"):
        near_tie = ~(np.abs(np.abs(d) - np.float32(0.5)) >= 2.0**-14)
    fast = np.clip(np.rint(y), -QMAX, QMAX)
    return np.where(near_tie, np.clip(np.rint(v / scale), -QMAX, QMAX), fast).astype(np.int8)


@pytest.mark.parametrize("kind", ["gaussian", "relu", "near_ties", "ties"])
def test_quantize_shortcut_equals_division(kind):
    """The reciprocal multiply gives the division's codes on every value:
    away from a tie both round alike, near one the division decides."""
    rng = np.random.RandomState(11)
    rows = rng.randn(64, 4096).astype(np.float32) * np.float32(10.0) ** rng.randint(-3, 4, (64, 1))
    if kind == "relu":
        rows = np.maximum(rows, 0)
    elif kind == "near_ties":  # values one to a few ulps from a tie of v / scale
        half = (rng.randint(-127, 127, rows.shape) + np.float32(0.5)).astype(np.float32)
        a = np.abs(rows).max(axis=1, keepdims=True)
        scale = _act_scale(a)
        rows = half * scale
        rows = np.nextafter(rows, rng.choice([-np.inf, np.inf], rows.shape).astype(np.float32))
        rows[:, 0] = a[:, 0]  # keep each row's max, and so its scale
    elif kind == "ties":
        rows[:, 0] = 127.0
        rows[:, 1:] = (np.arange(rows.shape[1] - 1) % 254 - 126.5).astype(np.float32)
    scale = _act_scale(np.abs(rows).max(axis=1))[:, None]
    assert np.array_equal(_quant_fast(rows, scale), _quant(rows, scale))
