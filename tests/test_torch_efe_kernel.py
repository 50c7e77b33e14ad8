"""Port parity of the fused fleet EFE kernel module.

``repro_torch.kernels.efe.ops`` on CPU tensors runs the plain PyTorch
versions of the CUDA kernel (B1 ``belief_efe_fleet``, B2 ``efe_fleet``);
they are held against the reference's Pallas kernels in interpret mode (as
``tests/test_quasistatic_cache.py`` runs them) and against its XLA oracle
``belief_efe_fleet_ref``, for K=3 and K=5, masked and unmasked, R in {1, 3}.
The CUDA kernels themselves are held against these plain versions on the
card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import belief as ref_belief
from repro.core import generative as ref_gen
from repro.core import policies as ref_pol
from repro.core.topology import default_topology, five_tier_topology
from repro.kernels.efe import ops as ref_ops
from repro.kernels.efe import ref as ref_oracle
from repro_torch.core import generative
from repro_torch.kernels.efe import efe, ops
from torch_port_ref import assert_close, port_topo

# Pallas-vs-oracle bar of the reference itself (tests/test_quasistatic_cache)
G_ATOL, Q_ATOL = 1e-4, 1e-5


def _operands(topo, r, masked, seed):
    rng = np.random.default_rng(seed)
    s, m, nbins = topo.n_states, topo.n_modalities, topo.max_bins
    a_n = ref_pol.n_actions(topo)
    cfg = ref_gen.AifConfig(topology=topo)
    a_counts = rng.uniform(0.1, 2.0, (r, m, nbins, s)).astype(np.float32)
    b_counts = rng.uniform(0.01, 1.0, (r, a_n, s, s)).astype(np.float32)
    c_log = np.tile(np.asarray(ref_gen.nominal_c_log(cfg))[None], (r, 1, 1))
    c_log[0] = np.asarray(ref_gen.unstable_c_log(cfg))
    q = rng.dirichlet(np.ones(s), r).astype(np.float32)
    obs = rng.integers(0, 2, (r, m)).astype(np.int32)
    prev = rng.integers(0, a_n, r).astype(np.int32)
    mask = None
    if masked:
        mask = rng.integers(0, 2, (r, m)).astype(np.float32)
        mask[0] = 1.0
    caches = [ref_gen.derive_cache(ref_gen.GenerativeModel(
        a_counts=jnp.asarray(a_counts[i]), b_counts=jnp.asarray(b_counts[i]),
        c_log=jnp.asarray(c_log[i]), d_prior=jnp.ones(s) / s), topo)
        for i in range(r)]
    nb = jnp.stack([c.nb for c in caches])
    na = jnp.stack([c.na for c in caches])
    amb_m = jnp.stack([c.amb_m for c in caches])
    jmask = None if mask is None else jnp.asarray(mask)
    amb = (jnp.stack([c.amb for c in caches]) if mask is None
           else ref_gen.masked_ambiguity(amb_m, jmask))
    logc = ref_gen.masked_log_c(jnp.asarray(c_log), topo)
    loglik = ref_belief.log_likelihood_from_normalized(na, jnp.asarray(obs),
                                                       jmask)
    return dict(cfg=cfg, a_counts=a_counts, b_counts=b_counts, c_log=c_log,
                nb=nb, na=na, amb=amb, logc=logc, q=jnp.asarray(q),
                prev=jnp.asarray(prev), loglik=loglik, mask=jmask)


def _t(x, dtype=torch.float32):
    return None if x is None else torch.tensor(np.asarray(x), dtype=dtype)


CASES = [(topo, r, masked)
         for topo in (default_topology(), five_tier_topology())
         for r in (1, 3) for masked in (False, True)]
IDS = [f"k{t.n_tiers}-r{r}-{'masked' if mk else 'clean'}"
       for t, r, mk in CASES]


@pytest.mark.parametrize("topo,r,masked", CASES, ids=IDS)
def test_fleet_belief_efe_matches_pallas_interpret_and_oracle(topo, r,
                                                              masked):
    d = _operands(topo, r, masked, seed=10 * r + masked)
    cfg_p = generative.AifConfig(topology=port_topo(topo))
    launches = efe.belief_efe_fleet.launches
    g_p, q_p = ops.fleet_belief_efe(
        _t(d["nb"]), _t(d["na"]), _t(d["logc"]), _t(d["amb"]), _t(d["q"]),
        _t(d["prev"], torch.int64), _t(d["loglik"]), cfg_p,
        obs_mask=_t(d["mask"]))
    assert efe.belief_efe_fleet.launches == launches   # no kernel on CPU
    g_pal, q_pal = ref_ops.fleet_belief_efe(
        d["nb"], d["na"], d["logc"], d["amb"], d["q"], d["prev"],
        d["loglik"], d["cfg"], obs_mask=d["mask"], use_pallas=True,
        interpret=True)
    assert_close(g_p, g_pal, rtol=0, atol=G_ATOL)
    assert_close(q_p, q_pal, rtol=0, atol=Q_ATOL)
    # the oracle at the parity tolerance
    cost = d["cfg"].cost_weight * ref_pol.policy_concentration_cost(topo)
    b_prev = jnp.take_along_axis(d["nb"], d["prev"][:, None, None, None],
                                 axis=1)[:, 0]
    g_ref, q_ref = ref_oracle.belief_efe_fleet_ref(
        b_prev, d["q"], d["loglik"], d["nb"], d["na"], d["logc"], d["amb"],
        cost, d["mask"])
    assert_close(g_p, g_ref)
    assert_close(q_p, q_ref)


@pytest.mark.parametrize("topo,r,masked", CASES, ids=IDS)
def test_fleet_efe_cached_and_counts_match_pallas_interpret(topo, r, masked):
    d = _operands(topo, r, masked, seed=7 + 10 * r + masked)
    cfg_p = generative.AifConfig(topology=port_topo(topo))
    launches = efe.efe_fleet.launches
    g_p = ops.fleet_efe_cached(_t(d["nb"]), _t(d["na"]), _t(d["logc"]),
                               _t(d["amb"]), _t(d["q"]), cfg_p,
                               obs_mask=_t(d["mask"]))
    g_pal = ref_ops.fleet_efe_cached(d["nb"], d["na"], d["logc"], d["amb"],
                                     d["q"], d["cfg"], obs_mask=d["mask"],
                                     use_pallas=True, interpret=True)
    assert_close(g_p, g_pal, rtol=0, atol=G_ATOL)
    g_ref = ref_ops.fleet_efe_cached(d["nb"], d["na"], d["logc"], d["amb"],
                                     d["q"], d["cfg"], obs_mask=d["mask"],
                                     use_pallas=False)
    assert_close(g_p, g_ref)
    # from raw pseudo-counts (normalization inside)
    g_cnt = ops.fleet_efe(_t(d["a_counts"]), _t(d["b_counts"]),
                          _t(d["c_log"]), _t(d["q"]), cfg_p,
                          obs_mask=_t(d["mask"]))
    g_cnt_ref = ref_ops.fleet_efe(jnp.asarray(d["a_counts"]),
                                  jnp.asarray(d["b_counts"]),
                                  jnp.asarray(d["c_log"]), d["q"], d["cfg"],
                                  obs_mask=d["mask"], use_pallas=False)
    assert_close(g_cnt, g_cnt_ref)
    assert efe.efe_fleet.launches == launches


def test_held_tick_posterior_matches_oracle():
    topo = default_topology()
    d = _operands(topo, 3, False, seed=3)
    q_p = ops.fleet_belief_posterior(_t(d["nb"]), _t(d["q"]),
                                     _t(d["prev"], torch.int64),
                                     _t(d["loglik"]))
    q_r = ref_ops.fleet_belief_posterior(d["nb"], d["q"], d["prev"],
                                         d["loglik"])
    assert_close(q_p, q_r)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """Shape/dtype/device checks run before any launch (no card needed for
    the meta-device tensors: they never reach the library)."""
    r, a, s, m, nbin = 2, 3, 5, 2, 2
    meta = dict(device="meta")
    nb = torch.empty((r, a, s, s), **meta)
    args = [torch.empty((r,), dtype=torch.int64, **meta),
            torch.empty((r, s), **meta), torch.empty((r, s), **meta),
            torch.empty((r, m, nbin, s), **meta),
            torch.empty((r, m, nbin), **meta), torch.empty((r, s), **meta),
            torch.empty((a,), **meta)]
    with pytest.raises(ValueError, match="no kernel for device"):
        efe.belief_efe_fleet(nb, *args)
    with pytest.raises(ValueError, match="no kernel for device"):
        efe.efe_fleet(nb, args[1], *args[3:])
