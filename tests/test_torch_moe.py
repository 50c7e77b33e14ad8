"""The port's Mixture-of-Experts layer (``repro_torch.models.moe``) against
the reference's ``apply_moe``, with the reference's weights carried across
(``torch_port_ref.moe_to_port``), in float32 on the CPU:

* the capacity path: y and the aux loss within rtol 1e-4 / atol 1e-5, the
  expert indices equal, and the same rows dropped (exactly zero), on the
  twin of ``tests/test_models.py::test_moe_capacity_drop_semantics``, on
  top-2 with drops and on top-1 with a shared expert;
* the dense switch (``_dense_moe``) against the reference's;
* a forced tie in the router: the lower expert first, as ``jax.lax.top_k``;
* the grouped dispatch (the kept pairs packed by expert, three grouped
  products) against the capacity formulation it replaced ((E, C, D)
  buffers, three ``bmm``, the k-order combine), kept here as its plain
  version: within rtol 1e-4 / atol 1e-5 on every case above, a dropless
  one and one where an expert gets no pair, dropped tokens exactly zero,
  every output finite (the packed rows past the last group, which
  ``grouped_mm`` leaves undefined, made NaN) and the gradients of every
  input and weight alike;
* the combine over the packed rows: each token's k pairs summed in k order
  equal a scatter-add to the bit, and two calls give the same bits;
* the host's cost: one ``Moe.forward`` issues no more aten ops than the
  capacity path did, at a decode and a prefill shape.
"""
import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as ref_moe
from repro.models.config import ModelConfig as RefModelConfig
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.models import layers, moe
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


def _capacity_dispatch(port, xf, gates, idx):
    """The capacity formulation, as ``Moe.dispatch`` ran before its
    grouped products: every token gathered into (E, C, D) buffers (empty
    rows zero), three ``bmm`` over every row, the gated outputs gathered
    back and summed in k order."""
    cfg = port.cfg
    n, d = xf.shape
    e, k = cfg.n_experts, cfg.top_k
    c = moe.capacity(n, cfg)
    slot = port.slots(idx, c)
    tok = torch.full((e * c + 1,), n, dtype=torch.long)
    tok[slot] = torch.arange(n * k) // k
    gate = torch.zeros(e * c + 1)
    gate[slot] = gates.reshape(-1)
    xd = torch.cat([xf, xf.new_zeros((1, d))])[tok[:e * c]].reshape(e, c, d)
    h = torch.bmm(xd, port.wi)
    g = layers.gate_act(torch.bmm(xd, port.wg), cfg.mlp_act)
    yd = torch.bmm(h * g, port.wo).reshape(e * c, d)
    yw = torch.cat([yd * gate[:e * c, None], yd.new_zeros((1, d))])
    pairs = yw[slot].reshape(n, k, d)
    y = torch.zeros((n, d))
    for j in range(k):
        y = y + pairs[:, j]
    return y, slot == e * c


DISPATCH_CASES = dict(
    {name: (kw, shape, False) for name, (kw, shape) in CASES.items()},
    dropless=(dict(d_model=32, d_ff=48, n_experts=4, top_k=2,
                   capacity_factor=2.0), (2, 40), False),
    empty_expert=(dict(d_model=32, d_ff=48, n_experts=4, top_k=2,
                       capacity_factor=0.75), (2, 40), True))


def _nan_past_last_group(grouped_mm):
    """``grouped_mm`` with the rows past ``offs[-1]``, which it leaves
    undefined, set to NaN: a dispatch that reads one, even gated by zero,
    turns non-finite."""
    def wrapped(a, b, *, offs=None, **kw):
        out = grouped_mm(a, b, offs=offs, **kw)
        out[int(offs[-1]):] = float("nan")
        return out
    return wrapped


@pytest.mark.parametrize("case", sorted(DISPATCH_CASES))
def test_grouped_dispatch_matches_capacity_path(case, monkeypatch):
    monkeypatch.setattr(torch.nn.functional, "grouped_mm",
                        _nan_past_last_group(torch.nn.functional.grouped_mm))
    kw, shape, no_expert_0 = DISPATCH_CASES[case]
    _, cfg, _, port, x = _setup(kw, shape, 4)
    xf = torch.from_numpy(x).reshape(-1, cfg.d_model)
    _, gates, idx = port.route(xf)
    if no_expert_0:      # route every pair to experts 1..E-1: expert 0 idle
        rng = np.random.default_rng(4)
        idx = torch.from_numpy(np.stack([
            rng.choice(np.arange(1, cfg.n_experts), cfg.top_k, replace=False)
            for _ in range(xf.shape[0])]))
    leaves = [t.requires_grad_() for t in (xf, gates, port.wi, port.wg,
                                           port.wo)]
    got = port.dispatch(xf, gates, idx)
    want, dropped = _capacity_dispatch(port, xf, gates, idx)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(t2n(got), t2n(want), rtol=RTOL, atol=ATOL)
    # the training path's gradients (Moe.apply), every leaf
    v = torch.from_numpy(np.random.default_rng(5).standard_normal(
        tuple(got.shape)).astype(np.float32))
    for a, b in zip(torch.autograd.grad(got, leaves, v),
                    torch.autograd.grad(want, leaves, v)):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(t2n(a), t2n(b), rtol=RTOL, atol=ATOL)
    got = got.detach()
    gone = dropped.reshape(-1, cfg.top_k).all(-1)
    assert (got[gone] == 0).all()
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.n_experts)
    if case == "dropless":
        assert not dropped.any()
    elif case in ("drop_semantics", "top2_drops", "empty_expert"):
        assert gone.any()             # tight capacity drops whole tokens
    if no_expert_0:
        assert counts[0] == 0


def test_combine_equals_scatter_add_to_the_bit():
    """Over the packed rows: each kept pair's gated output added into its
    token by a scatter-add, from the same grouped products, equals the
    k-order combine to the bit."""
    kw, shape = CASES["top2_drops"]
    _, cfg, _, port, x = _setup(kw, shape, 2)
    xf = torch.from_numpy(x).reshape(-1, cfg.d_model)
    _, gates, idx = port.route(xf)
    got = port.dispatch(xf, gates, idx)
    assert torch.equal(got, port.dispatch(xf, gates, idx))
    # packed rows: the kept pairs in order of their capacity slot, that is
    # by expert and then by position
    n, e, k = xf.shape[0], cfg.n_experts, cfg.top_k
    c = moe.capacity(n, cfg)
    slot = port.slots(idx, c)
    kept = torch.nonzero(slot < e * c)[:, 0]
    kept = kept[torch.argsort(slot[kept])]
    tok = kept // k
    offs = torch.cumsum(torch.bincount(idx.reshape(-1)[kept], minlength=e),
                        0).to(torch.int32)
    xp = torch.cat([xf[tok], xf.new_zeros((n * k - len(kept), cfg.d_model))])
    yp = port._ffn(xp, offs)[:len(kept)]
    want = torch.zeros((n, cfg.d_model)).index_add_(
        0, tok, yp * gates.reshape(-1)[kept, None])
    assert len(kept) < n * k          # the case drops pairs
    assert torch.equal(got, want)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


# The aten ops one Moe.forward issued on the capacity path (three bmm over
# (E, C, D) buffers; the parent commit of the grouped dispatch), counted
# with this test's counter and config: 58 at both shapes.  A decode wave is
# bound by the host's enqueue, so the dispatch may not issue more.
CAPACITY_PATH_OPS = 58


@pytest.mark.parametrize("n", [8, 512])
def test_forward_issues_no_more_ops_than_the_capacity_path(n):
    cfg = ModelConfig(name="m", family="moe", n_layers=1, n_heads=2,
                      n_kv_heads=2, vocab_size=64, d_model=64, d_ff=96,
                      n_experts=4, top_k=2, capacity_factor=2.0)
    port = moe.Moe(cfg)
    port.init_weights(torch.Generator().manual_seed(0))
    x = torch.randn(1, n, cfg.d_model).to(torch.bfloat16)
    with torch.no_grad(), _CountOps() as count:
        port(x)
    assert count.ops["_grouped_mm"] == 3 and count.ops["bmm"] == 0
    assert sum(count.ops.values()) <= CAPACITY_PATH_OPS, count.ops
