"""The port's MoE layer (``models/moe.py``) and the MoE ViT held against the
JAX package's on the CPU, on the same numpy inputs and converted weights.

Gates:
- routing: the slot and kept vectors equal, gate probabilities and the
  balance loss within 1e-6;
- scatter, gather and the experts' MLP within 1e-6 (rtol and atol);
- the scatter form against both packages' one-hot einsum oracle, with
  and without capacity drops (capacity_factor 4.0, 0.5, 0.25, 0.01);
- the MoE ViT's log-probs within 1e-5 with equal argmax, aux within 1e-6;
- ``--bf16``: the dtypes of JAX's promotion (bf16 tokens in, the gate and
  both expert matmuls in float32, bf16 out), and equal routing for every
  token whose top-1/top-2 logit margin exceeds the bound on how far the
  two packages' bf16 tokens can move a logit (stated per token below);
  the tokens under it are reported, not gated.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_mnist_ddp_tpu.models import moe as jmoe
from pytorch_mnist_ddp_tpu.models import vit as jvit
from pytorch_mnist_ddp_tpu_torch.models import moe
from pytorch_mnist_ddp_tpu_torch.models.vit import ViT, ViTConfig, vit_moe_forward
from pytorch_mnist_ddp_tpu_torch.utils.convert import (
    jax_vit_tree_from_torch,
    torch_vit_state_from_jax,
)

TOL = dict(rtol=1e-6, atol=1e-6)


def _moe_params(num_experts, seed=0):
    cfg = jvit.ViTConfig(num_experts=num_experts)
    return jax.device_get(jmoe.init_moe_params(jax.random.PRNGKey(seed), cfg)), cfg


def _port_moe(mp, num_experts) -> moe.MoE:
    layer = moe.MoE(64, 128, num_experts)
    layer.load_state_dict(torch_vit_state_from_jax(mp))
    return layer


def _tokens(g, seed=1, dtype=np.float32):
    return np.random.RandomState(seed).randn(g, 64).astype(dtype)


@pytest.mark.parametrize("num_experts, cf", [(8, 2.0), (4, 4.0), (2, 0.5), (2, 0.01)])
def test_route_matches_jax(num_experts, cf):
    mp, cfg = _moe_params(num_experts)
    cfg = cfg._replace(capacity_factor=cf)
    g = 96
    cap = jmoe.capacity_for(g, cfg)
    assert moe.capacity_for(g, num_experts, cf) == cap
    x = _tokens(g)
    slot, kept, prob, aux = (np.asarray(a) for a in jmoe.route(mp["gate"], jnp.asarray(x),
                                                               cfg, cap))
    got = moe.route(_port_moe(mp, num_experts).gate, torch.from_numpy(x), num_experts, cap)
    assert np.array_equal(got[0].numpy(), slot) and np.array_equal(got[1].numpy(), kept)
    np.testing.assert_allclose(got[2].detach().numpy(), prob, **TOL)
    np.testing.assert_allclose(float(got[3]), aux, **TOL)
    if cf < 1:
        assert not kept.all()  # the case really drops tokens


@pytest.mark.parametrize("num_experts, cf", [(8, 2.0), (2, 0.5), (2, 0.01)])
def test_scatter_experts_gather_match_jax(num_experts, cf):
    mp, cfg = _moe_params(num_experts, seed=3)
    cfg = cfg._replace(capacity_factor=cf)
    g = 64
    cap = jmoe.capacity_for(g, cfg)
    x = _tokens(g, seed=4)
    layer = _port_moe(mp, num_experts)
    slot, kept, prob, _ = jmoe.route(mp["gate"], jnp.asarray(x), cfg, cap)
    xin = jmoe.scatter_to_slots(jnp.asarray(x), slot, kept, cfg, cap)
    out = jmoe.expert_ffn(mp, xin)
    y = jmoe.gather_from_slots(out, slot, kept, prob)
    t_slot, t_kept, t_prob, _ = moe.route(layer.gate, torch.from_numpy(x), num_experts, cap)
    with torch.no_grad():
        t_xin = moe.scatter_to_slots(torch.from_numpy(x), t_slot, t_kept, num_experts, cap)
        t_out = moe.expert_ffn(layer, t_xin)
        t_y = moe.gather_from_slots(t_out, t_slot, t_kept, t_prob)
    for name, a, b in (("xin", t_xin, xin), ("out", t_out, out), ("y", t_y, y)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **TOL)
    dropped = ~t_kept.numpy()
    assert np.all(t_y.numpy()[dropped] == 0.0)  # the residual carries them


@pytest.mark.parametrize("cf", [4.0, 0.25])
def test_scatter_form_matches_both_einsum_oracles(cf):
    """The scatter/gather routing against the port's one-hot einsum form
    and the JAX package's, without drops and with heavy drops."""
    mp, cfg = _moe_params(4, seed=5)
    cfg = cfg._replace(capacity_factor=cf)
    x = np.random.RandomState(6).randn(4, 8, 64).astype(np.float32)
    layer = _port_moe(mp, 4)
    with torch.no_grad():
        got = moe.moe_mlp_dense(layer, torch.from_numpy(x), 4, cf)
        oracle = moe.moe_mlp_dense_einsum(layer, torch.from_numpy(x), 4, cf)
    want = jmoe.moe_mlp_dense_einsum(mp, jnp.asarray(x), cfg)
    for ref in (oracle.y.numpy(), np.asarray(want.y)):
        np.testing.assert_allclose(got.y.numpy(), ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss), **TOL)
    np.testing.assert_allclose(float(oracle.aux_loss), float(want.aux_loss), **TOL)


def test_dispatch_tensors_match_jax():
    mp, cfg = _moe_params(2, seed=0)
    cfg = cfg._replace(capacity_factor=0.5)
    x = _tokens(8, seed=1)
    cap = jmoe.capacity_for(8, cfg)
    want = jmoe.gate_and_dispatch(mp["gate"], jnp.asarray(x), cfg, cap)
    got = moe.gate_and_dispatch(_port_moe(mp, 2).gate, torch.from_numpy(x), 2, cap)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].detach().numpy(), np.asarray(want[1]), **TOL)


def _vit_params(seed=0, **cfg):
    jcfg = jvit.ViTConfig(num_experts=8, **cfg)
    return jax.device_get(jvit.init_vit_params(jax.random.PRNGKey(seed), jcfg)), jcfg


def _port_vit(params, **cfg) -> ViT:
    model = ViT(ViTConfig(num_experts=8, **cfg))
    model.load_state_dict(torch_vit_state_from_jax(params))
    return model


def _images(n, seed):
    return np.random.RandomState(seed).rand(n, 28, 28, 1).astype(np.float32)


def test_moe_vit_tree_crosses_both_ways():
    params, _ = _vit_params(seed=2)
    model = _port_vit(params)
    back = jax_vit_tree_from_torch(model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert np.array_equal(a, np.asarray(b))
    assert model.blocks[0].moe.gate.weight.shape == (8, 64)  # kernel [64, 8] transposed


@pytest.mark.parametrize("cf", [2.0, 0.5])
def test_moe_vit_forward_matches_jax(cf):
    params, jcfg = _vit_params(seed=1, capacity_factor=cf)
    x = _images(16, 2)
    want_logp, want_aux = jvit.vit_moe_forward(params, jnp.asarray(x), jcfg)
    with torch.no_grad():
        logp, aux = _port_vit(params, capacity_factor=cf)(torch.from_numpy(x))
    np.testing.assert_allclose(logp.numpy(), np.asarray(want_logp), rtol=1e-5, atol=1e-5)
    assert np.array_equal(logp.numpy().argmax(1), np.asarray(want_logp).argmax(1))
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


def test_moe_vit_gradients_match_jax():
    """The objective nll + 0.01 aux: every leaf's gradient within 1e-5 of
    JAX's, relative to its largest entry."""
    from pytorch_mnist_ddp_tpu.ops.loss import nll_loss as jax_nll
    from pytorch_mnist_ddp_tpu_torch.ops.loss import nll_loss

    params, jcfg = _vit_params(seed=4)
    x, y = _images(8, 5), np.random.RandomState(6).randint(0, 10, 8)

    def loss_fn(p):
        logp, aux = jvit.vit_moe_forward(p, jnp.asarray(x), jcfg)
        return jax_nll(logp, jnp.asarray(y), None, reduction="mean") + 0.01 * aux

    want = torch_vit_state_from_jax(jax.device_get(jax.grad(loss_fn)(params)))
    model = _port_vit(params)
    logp, aux = model(torch.from_numpy(x))
    (nll_loss(logp, torch.from_numpy(y)) + 0.01 * aux).backward()
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        assert float(np.abs(p.grad.numpy() - ref).max()) <= 1e-5 * float(np.abs(ref).max()), name


def _capture_moe_inputs(params, jcfg, x):
    """Each block's tokens entering the MoE layer, in both packages, under
    ``--bf16``; and the port's layer dtypes."""
    jax_h, port_h, dtypes = [], [], []

    def jax_moe(mp, h):
        jax_h.append(np.asarray(h.astype(jnp.float32)))
        return jmoe.moe_mlp_dense(mp, h, jcfg)

    jvit.vit_moe_forward(params, jnp.asarray(x), jcfg, moe_fn=jax_moe)
    model = _port_vit(params, bf16=True)

    def port_moe(layer, h):
        port_h.append(h.float().numpy())
        b, t, d = h.shape
        flat = h.reshape(b * t, d)
        cap = moe.capacity_for(b * t, 8, 2.0)
        slot, kept, prob, aux = moe.route(layer.gate, flat, 8, cap)
        xin = moe.scatter_to_slots(flat, slot, kept, 8, cap)
        out = moe.expert_ffn(layer, xin)
        y = moe.gather_from_slots(out, slot, kept, prob).reshape(b, t, d).to(h.dtype)
        dtypes.append((h.dtype, xin.dtype, out.dtype, y.dtype))
        return moe.MoeOut(y, aux)

    with torch.no_grad():
        vit_moe_forward(model, torch.from_numpy(x), moe_fn=port_moe)
    return jax_h, port_h, dtypes, model


def test_bf16_promotion_and_routing_match_jax():
    params, jcfg = _vit_params(seed=7, bf16=True)
    x = _images(32, 8)
    jax_h, port_h, dtypes, model = _capture_moe_inputs(params, jcfg, x)
    # JAX's promotion: bf16 tokens in and scattered, the experts in f32, bf16 out
    assert dtypes == [(torch.bfloat16, torch.bfloat16, torch.float32, torch.bfloat16)] * 2
    mp = params["blocks"]["0"]["moe"]
    hb = jnp.asarray(jax_h[0].reshape(-1, 64), jnp.bfloat16)
    jxin = jmoe.scatter_to_slots(hb, *jmoe.route(mp["gate"], hb, jcfg, 128)[:2], jcfg, 128)
    assert jxin.dtype == jnp.bfloat16 and jmoe.expert_ffn(mp, jxin).dtype == jnp.float32
    flips, under = 0, 0
    for i, (jh, ph) in enumerate(zip(jax_h, port_h)):
        gate = model.blocks[i].moe.gate
        w = gate.weight.detach().numpy().astype(np.float64)
        b = gate.bias.detach().numpy().astype(np.float64)
        jl = jh.reshape(-1, 64).astype(np.float64) @ w.T + b
        top2 = np.sort(jl, axis=1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        # Per token: the most any logit of the two packages' tokens can
        # differ, twice (both the top logit and its rival move), plus f32
        # accumulation; a wider margin cannot flip.
        bound = 2 * (np.abs(w) @ np.abs(jh - ph).reshape(-1, 64).T).max(axis=0) + 1e-5
        t = torch.from_numpy(ph.reshape(-1, 64)).to(torch.bfloat16)
        slot, _, _, _ = moe.route(gate, t, 8, 10**6)
        port_expert = slot.numpy() // 10**6
        jslot = np.asarray(jmoe.route(params["blocks"][str(i)]["moe"]["gate"],
                                      jnp.asarray(jh.reshape(-1, 64), jnp.bfloat16),
                                      jcfg, 10**6)[0])
        jax_expert = jslot // 10**6
        safe = margin > bound
        assert np.array_equal(port_expert[safe], jax_expert[safe]), i
        flips += int((port_expert != jax_expert).sum())
        under += int((~safe).sum())
    print(f"bf16 routing: {flips} flips, {under} tokens under the bound, of {2 * 32 * 16}")
    assert flips <= under
