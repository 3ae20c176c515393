"""The int8 head kernel's split of K over a thread-block cluster, on the CPU.

The kernel (``csrc/int8_head.cu``) gives each block of a cluster one
K-slice of fc1, taken in K-passes of at most 1152 columns: it forms each
row's max|x| from the passes' and slices' maxima, quantizes each pass,
takes int32 partial products per h-tile of at most 128 fc1 columns, and
the partials are summed over the passes and across the cluster before
fc1's epilogue.  No kernel runs here:

- (a) the launch plan (``_launch_plan``) covers every row and every K
  column exactly once, with clusters of at most 16 blocks, every K-slice
  but a ragged last one a whole number of 32-column chunks, every K-pass
  within the registers and every block within its shared memory, at every
  shape the JAX kernel takes (it asks hidden % 128 == 0 and nothing of in);
- (b) a numpy model of the split, driven by the plan, is bit-equal to the
  plain version and to JAX's ``_int8_dense`` -> relu -> ``_int8_dense``,
  with the partials summed in rank-and-pass order and in reverse.
  ``fmaxf`` is order-free and int32 sums of int8 products are exact, which
  is why.

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
@pytest.mark.parametrize("k", [9216, 1040, 100, 9215, 20000])
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
    assert c0 % 32 == 0 and c1 > c0 and (c1 - c0) % 16 == k % 16
    assert max(c1 - c0 for c0, c1 in slices) <= plan["slice"]
    # Each slice's K-passes cover it once, in order, within the registers.
    for (c0, c1), passes in zip(slices, ih._k_passes(k, c)):
        assert len(passes) == plan["passes"]
        assert np.array_equal(np.concatenate([np.arange(*p) for p in passes]), np.arange(c0, c1))
        assert all(p0 % 32 == 0 and p1 - p0 <= plan["pass_width"] <= ih.MAX_PASS
                   for p0, p1 in passes if p1 > p0)
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
    """These shapes once had no cluster size (a K-slice past the 1152
    register columns, h past rank 0's shared memory) and now plan: k in
    K-passes, h through device memory.  The plan raises only where the
    card runs no cluster at all; the JAX kernel's own refusal (hidden %
    128) is the wrapper's (hidden % 16)."""
    plan = ih._launch_plan(8, k, h, 10, OCCUPANCY["h100"])
    assert plan["cluster"] == 16 and plan["smem"] <= ih.SMEM_LIMIT
    assert plan["passes"] == (2 if k > 18432 else 1)
    assert plan["hid_smem"] is (h <= 1024) and plan["h_tiles"] == -(-h // ih.H_TILE)
    with pytest.raises(ValueError, match="runs no cluster"):
        ih._launch_plan(8, k, h, 10, {c: 0 for c in ih.CLUSTER_SIZES})


@pytest.mark.parametrize("k, h, passes, h_tiles, hid_smem", [
    (100, 128, 1, 1, True), (9215, 128, 1, 1, True), (20000, 128, 2, 1, True),
    (9216, 384, 1, 3, True), (9216, 144, 1, 2, True), (9216, 4096, 1, 32, False),
    (200000, 256, 11, 2, True),
])
def test_launch_plan_takes_every_shape(k, h, passes, h_tiles, hid_smem):
    """in needs no multiple of 16 and has no upper limit; hidden none but
    a multiple of 16.  The shared memory always fits: one step's W1 tile,
    the partials, and h only while it fits."""
    plan = ih._launch_plan(8, k, h, 10, OCCUPANCY["h100"])
    assert (plan["passes"], plan["h_tiles"], plan["hid_smem"]) == (passes, h_tiles, hid_smem)
    for n in (1, 8, 130):  # other row counts take other cluster sizes
        plan = ih._launch_plan(n, k, h, 10, OCCUPANCY["h100"])
        assert plan["smem"] <= ih.SMEM_LIMIT and plan["cluster"] <= -(-k // 32)


def test_plan_constants_match_the_kernel_source():
    src = (_build.CSRC / "int8_head.cu").read_text()
    const = {m.group(1): int(m.group(2))
             for m in re.finditer(r"constexpr int (\w+) = (\d+);", src)}
    assert const["R"] == ih.ROWS
    assert const["HEADER"] == ih._HEADER
    assert const["MAX_CLUSTER"] == max(ih.CLUSTER_SIZES)
    assert 4 * 32 * const["MAXC"] == ih.MAX_PASS
    assert const["H_TILE"] == ih.H_TILE


# ------------------------------------------------------- (b) split model


def _act_scale(a_max: np.ndarray) -> np.ndarray:
    return np.where(a_max > 0, a_max / QMAX, np.float32(1.0)).astype(np.float32)


def _quant(x: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return np.clip(np.rint(x / scale), -QMAX, QMAX).astype(np.int8)


def _split_head(fc1: dict, fc2: dict, x: np.ndarray, reverse: bool) -> np.ndarray:
    """The kernel's arithmetic in numpy, f32 step by step: per row tile, per
    K-pass of each rank's K-slice the row maxima; per h-tile, per pass the
    codes and int32 partials, summed over the ranks and passes (in reverse
    when asked); rank 0's fc2 on the whole hidden row."""
    w1, s1, b1 = (np.asarray(fc1[key]) for key in ("weight_q", "scale", "bias"))
    w2, s2, b2 = (np.asarray(fc2[key]) for key in ("weight_q", "scale", "bias"))
    n, k = x.shape
    h = w1.shape[0]
    plan = ih._launch_plan(n, k, h, w2.shape[0], OCCUPANCY["h100"])
    passes = [p for rank in ih._k_passes(k, plan["cluster"]) for p in rank]
    order = passes[::-1] if reverse else passes
    out = np.empty((n, w2.shape[0]), np.float32)
    for t in range(plan["grid"][1]):
        tile = np.zeros((ih.ROWS, k), np.float32)  # rows past n are zero
        rows = x[t * ih.ROWS:(t + 1) * ih.ROWS]
        tile[:len(rows)] = rows
        maxima = [np.abs(tile[:, p0:p1]).max(axis=1, initial=0.0) for p0, p1 in order]
        a1 = _act_scale(np.maximum.reduce(maxima))[:, None]
        hid = np.empty((ih.ROWS, h), np.float32)
        for h0, h1 in ih._h_tiles(h):
            acc = np.zeros((ih.ROWS, h1 - h0), np.int32)
            for p0, p1 in order:
                acc += (_quant(tile[:, p0:p1], a1).astype(np.int32)
                        @ w1[h0:h1, p0:p1].astype(np.int32).T)
            hid[:, h0:h1] = np.maximum(acc.astype(np.float32) * (a1 * s1[h0:h1]) + b1[h0:h1],
                                       np.float32(0.0))
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


def _random_layers(rng, k: int, h: int, o: int) -> tuple[dict, dict]:
    layers = []
    for out_w, in_w in ((h, k), (o, h)):
        layers.append({
            "weight_q": torch.from_numpy(rng.randint(-127, 128, (out_w, in_w)).astype(np.int8)),
            "scale": torch.from_numpy((rng.rand(out_w) * 1e-2).astype(np.float32)),
            "bias": torch.from_numpy(rng.randn(out_w).astype(np.float32)),
        })
    return tuple(layers)


def _jax_layers(layers) -> list[dict]:
    return [{"kernel_q": np.asarray(layer["weight_q"]).T, "scale": np.asarray(layer["scale"]),
             "bias": np.asarray(layer["bias"])} for layer in layers]


def _check_random_split(k: int, h: int, n: int, seed: int) -> None:
    """Random int8 layers and x: plain == JAX's _int8_dense chain == the
    split model, partials summed in order and reversed."""
    rng = np.random.RandomState(seed)
    fc1, fc2 = _random_layers(rng, k, h, 10)
    x = rng.randn(n, k).astype(np.float32)
    plain = ih.int8_head_reference(fc1, fc2, torch.from_numpy(x)).numpy()
    jl = _jax_layers((fc1, fc2))
    want = np.asarray(jq._int8_dense(jax.nn.relu(jq._int8_dense(x, jl[0])), jl[1]))
    assert plain.tobytes() == want.tobytes()
    for reverse in (False, True):
        assert _split_head(fc1, fc2, x, reverse).tobytes() == plain.tobytes()


@pytest.mark.parametrize("n", [5, 130])
def test_split_model_ragged_last_slice(n):
    """k = 1040 ends inside a 32-column chunk: the last rank's slice is 80
    columns.  Random int8 weights; JAX's _int8_dense on the same layers."""
    assert ih._k_slices(1040, 16)[-1] == (960, 1040)
    _check_random_split(1040, 128, n, seed=n)


@pytest.mark.parametrize("k, h", [(100, 128), (9215, 128), (20000, 128), (9216, 384),
                                  (9216, 2048), (40000, 256)],
                         ids=["k100", "k9215", "k20000", "h384", "h2048", "k40000_h256"])
@pytest.mark.parametrize("n", [3, 17])
def test_split_model_passes_and_h_tiles_bit_equal(k, h, n):
    """Shapes past one pass and one h-tile: in not a multiple of 16 (or of
    32), slices in two or more K-passes, hidden in several 128-column
    tiles (through device memory at 2048)."""
    _check_random_split(k, h, n, seed=k + h + n)


@pytest.mark.parametrize("k, h", [(100, 128), (9216, 384)], ids=["k100", "h384"])
def test_plain_head_equals_jax_fused_kernel(k, h):
    """The port's plain head (the kernel's yardstick on the card) against
    JAX's fused_int8_head in interpret mode at shapes the JAX kernel takes
    and the port's kernel took only from this slice on."""
    from pytorch_mnist_ddp_tpu.ops.pallas_infer import fused_int8_head

    rng = np.random.RandomState(k + h)
    fc1, fc2 = _random_layers(rng, k, h, 10)
    x = rng.randn(9, k).astype(np.float32)
    plain = ih.int8_head_reference(fc1, fc2, torch.from_numpy(x)).numpy()
    jl1, jl2 = _jax_layers((fc1, fc2))
    want = np.asarray(fused_int8_head(jl1, jl2, jax.numpy.asarray(x), interpret=True))
    # The JAX kernel's f32 epilogue may fuse into an FMA: the last ulp, as
    # tests/test_torch_quant.py holds it (atol 1e-6 at the model's logits
    # of ~1; these random layers' reach ~10, hence rtol 1e-6 too).
    np.testing.assert_allclose(plain, want, rtol=1e-6, atol=1e-6)
    assert (plain.argmax(1) == want.argmax(1)).all()


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
