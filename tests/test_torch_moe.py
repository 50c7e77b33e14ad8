"""The port's Mixture-of-Experts layer (``repro_torch.models.moe``) against
the reference's ``apply_moe``, with the reference's weights carried across
(``torch_port_ref.moe_to_port``), in float32 on the CPU:

* the capacity path: y and the aux loss within rtol 1e-4 / atol 1e-5, the
  expert indices equal, and the same rows dropped (exactly zero), on the
  twin of ``tests/test_models.py::test_moe_capacity_drop_semantics``, on
  top-2 with drops and on top-1 with a shared expert;
* the dense switch (``_dense_moe``) against the reference's;
* a forced tie in the router: the lower expert first, as ``jax.lax.top_k``;
* the combine: each token's k pairs summed in k order equal a scatter-add
  to the bit, and two calls give the same bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as ref_moe
from repro.models.config import ModelConfig as RefModelConfig
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig
from torch_port_ref import moe_to_port, t2n

RTOL, ATOL = 1e-4, 1e-5

CASES = {
    # tests/test_models.py::test_moe_capacity_drop_semantics
    "drop_semantics": (dict(d_model=16, d_ff=32, n_experts=2, top_k=1,
                            capacity_factor=0.26), (2, 512)),
    "top2_drops": (dict(d_model=32, d_ff=48, n_experts=4, top_k=2,
                        capacity_factor=0.75), (2, 40)),
    "top1_shared": (dict(d_model=32, d_ff=48, n_experts=4, top_k=1,
                         shared_expert=True, mlp_act="gelu"), (3, 24)),
}


def _cfgs(**kw):
    base = dict(name="m", family="moe", n_layers=1, n_heads=2, n_kv_heads=2,
                vocab_size=64, param_dtype="float32", compute_dtype="float32")
    base.update(kw)
    return RefModelConfig(**base), ModelConfig(**base)


def _setup(kw, shape, seed=0):
    ref_cfg, cfg = _cfgs(**kw)
    params = jax.jit(ref_moe.init_moe, static_argnums=(1, 2))(
        jax.random.key(seed), ref_cfg, jnp.float32)
    x = np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)
    return ref_cfg, cfg, params, moe_to_port(cfg, params), x


def _apply(params, x, ref_cfg):
    return jax.jit(ref_moe.apply_moe, static_argnums=2)(
        params, jnp.asarray(x), ref_cfg)


def _port_apply(port, x):
    """The port's y and its aux loss (``moe.aux_loss`` from ``route``)."""
    xt = torch.from_numpy(x)
    probs, _, idx = port.route(xt.reshape(-1, xt.shape[-1]))
    return port(xt), moe.aux_loss(probs, idx, port.cfg.n_experts)


def _ref_route(params, x, k):
    probs = jax.nn.softmax(x.reshape(-1, x.shape[-1]) @ params["router"], -1)
    return jax.lax.top_k(probs, k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_moe_matches_reference(case):
    kw, shape = CASES[case]
    ref_cfg, cfg, params, port, x = _setup(kw, shape)
    y_ref, aux_ref = _apply(params, x, ref_cfg)
    y, aux = _port_apply(port, x)
    y_ref = np.asarray(y_ref)
    np.testing.assert_allclose(t2n(y), y_ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=RTOL)
    _, idx_ref = _ref_route(params, jnp.asarray(x), cfg.top_k)
    _, _, idx = port.route(torch.from_numpy(x).reshape(-1, cfg.d_model))
    np.testing.assert_array_equal(t2n(idx), np.asarray(idx_ref))
    dropped_ref = np.all(y_ref == 0.0, axis=-1)
    dropped = np.all(t2n(y) == 0.0, axis=-1)
    np.testing.assert_array_equal(dropped, dropped_ref)
    if not cfg.shared_expert:
        assert dropped.sum() > 0          # tight capacity drops tokens


def test_capacity_matches_reference():
    for kw, _ in CASES.values():
        ref_cfg, cfg = _cfgs(**kw)
        for n in (1, 8, 48, 1024, 8192):
            assert moe.capacity(n, cfg) == ref_moe.capacity(n, ref_cfg)


def test_dense_mode_matches_reference(monkeypatch):
    """``_dense_moe`` directly, and the switch with the token threshold
    raised on both sides (REPRO_MOE_DENSE_MAX)."""
    kw, _ = CASES["top1_shared"]
    ref_cfg, cfg, params, port, x = _setup(dict(kw, top_k=2), (2, 5), 3)
    xf = jnp.asarray(x.reshape(-1, cfg.d_model))
    gates, idx = _ref_route(params, xf, 2)
    gates = gates / jnp.maximum(gates.sum(-1, keepdims=True), 1e-9)
    want = jax.jit(ref_moe._dense_moe, static_argnums=4)(params, xf, gates,
                                                         idx, ref_cfg)
    got = port.dense(*(torch.tensor(np.asarray(a)) for a in (xf, gates)),
                     torch.tensor(np.asarray(idx)).long())
    np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    monkeypatch.setattr(ref_moe, "DENSE_MODE_MAX_TOKENS", 512)
    monkeypatch.setattr(moe, "DENSE_MODE_MAX_TOKENS", 512)
    y_ref, aux_ref = _apply(params, x, ref_cfg)
    y, aux = _port_apply(port, x)
    np.testing.assert_allclose(t2n(y), np.asarray(y_ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=RTOL)


def test_forced_tie_takes_the_lower_expert_first():
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.1, 0.4, 0.1],
                      [0.2, 0.3, 0.2, 0.3]], np.float32)
    vals_ref, idx_ref = jax.lax.top_k(jnp.asarray(probs), 3)
    vals, idx = moe.top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(t2n(idx), np.asarray(idx_ref))
    np.testing.assert_array_equal(t2n(vals), np.asarray(vals_ref))
    # a router of zeros ties every expert on every token: all go to the
    # lowest k experts, which overflow
    kw, shape = CASES["top2_drops"]
    ref_cfg, cfg, params, _, x = _setup(kw, shape, 1)
    params = dict(params, router=jnp.zeros_like(params["router"]))
    port = moe_to_port(cfg, params)
    y_ref, _ = _apply(params, x, ref_cfg)
    y = port(torch.from_numpy(x))
    _, _, idx = port.route(torch.from_numpy(x).reshape(-1, cfg.d_model))
    assert (t2n(idx) == np.array([0, 1])).all()
    np.testing.assert_allclose(t2n(y), np.asarray(y_ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(np.all(t2n(y) == 0, -1),
                                  np.all(np.asarray(y_ref) == 0, -1))


def test_combine_equals_scatter_add_to_the_bit():
    kw, shape = CASES["top2_drops"]
    _, cfg, _, port, x = _setup(kw, shape, 2)
    xf = torch.from_numpy(x).reshape(-1, cfg.d_model)
    _, gates, idx = port.route(xf)
    got = port.dispatch(xf, gates, idx)
    assert torch.equal(got, port.dispatch(xf, gates, idx))
    # the reference's combine, a scatter-add of every slot's gated output
    n, e, k = xf.shape[0], cfg.n_experts, cfg.top_k
    c = moe.capacity(n, cfg)
    slot = port.slots(idx, c)
    tok = torch.full((e * c + 1,), n, dtype=torch.long)
    tok[slot] = torch.arange(n * k) // k
    gate = torch.zeros(e * c + 1)
    gate[slot] = gates.reshape(-1)
    x_pad = torch.cat([xf, xf.new_zeros((1, cfg.d_model))])
    yd = port._ffn(x_pad[tok[:e * c]].reshape(e, c, -1)).reshape(e * c, -1)
    want = torch.zeros((n + 1, cfg.d_model)).index_add_(
        0, tok[:e * c], yd * gate[:e * c, None])[:n]
    assert torch.equal(got, want)
