"""Port parity of the static spec layer and the generative model.

The policy tables, observation discretization, state tables, preference
tables and every ``ModelCache`` field of ``repro_torch`` against ``repro``
(JAX) on the same inputs, for K = 2, 3 and 5 tiers.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import belief as ref_belief
from repro.core import generative as ref_gen
from repro.core import policies as ref_pol
from repro.core import preferences as ref_pref
from repro.core import spaces as ref_spaces
from repro_torch.core import belief, generative, policies, preferences, spaces
from torch_port_ref import assert_close, port_topo, ref_topologies, t2n

TOPOS = ref_topologies()
IDS = ["k2", "k3", "k5"]


@pytest.mark.parametrize("topo", TOPOS, ids=IDS)
def test_policy_tables_equal_reference(topo):
    pt = port_topo(topo)
    np.testing.assert_array_equal(policies.generate_policy_table(pt),
                                  ref_pol.generate_policy_table(topo))
    assert policies.n_actions(pt) == ref_pol.n_actions(topo)
    assert_close(policies.policy_concentration_cost(pt, "cpu"),
                 ref_pol.policy_concentration_cost(topo))
    act = torch.tensor([0, policies.n_actions(pt) - 1, 3])
    assert_close(policies.routing_weights(act, pt),
                 ref_pol.routing_weights(jnp.asarray([0, ref_pol.n_actions(
                     topo) - 1, 3]), topo), rtol=0, atol=0)


def test_paper_table_has_twenty_rows():
    pt = port_topo(TOPOS[1])
    tbl = policies.generate_policy_table(pt)
    assert tbl.shape == (20, 3)
    np.testing.assert_array_equal(tbl[0], np.float32([0.33, 0.33, 0.34]))


@pytest.mark.parametrize("topo", TOPOS, ids=IDS)
def test_state_tables_and_bin_mask_equal_reference(topo):
    pt = port_topo(topo)
    np.testing.assert_array_equal(spaces.state_factor_table(pt),
                                  ref_spaces.state_factor_table(topo))
    np.testing.assert_array_equal(spaces.bins_mask_np(pt),
                                  ref_spaces.bins_mask_np(topo))


def test_discretize_observation_equals_reference_with_edge_clamp():
    rng = np.random.default_rng(0)
    raw = rng.uniform(-1.0, 100.0, size=(64, 4)).astype(np.float32)
    raw[0] = [np.inf, np.inf, np.inf, np.inf]      # clamps to the top bin
    raw[1] = [np.nan, 50.0, -np.inf, 0.15]         # NaN -> bin 0; edge hit
    disc_p, disc_r = spaces.DiscretizationConfig(), \
        ref_spaces.DiscretizationConfig()
    got = spaces.discretize_observation(torch.tensor(raw), disc_p)
    want = ref_spaces.discretize_observation(jnp.asarray(raw), disc_r)
    np.testing.assert_array_equal(t2n(got), np.asarray(want))
    oh = spaces.one_hot_observation(got, 3)
    np.testing.assert_array_equal(
        t2n(oh), np.asarray(ref_spaces.one_hot_observation(want, 3)))


def _random_counts(topo, r, seed):
    rng = np.random.default_rng(seed)
    s, m, nb = topo.n_states, topo.n_modalities, topo.max_bins
    a = rng.uniform(0.1, 2.0, (r, m, nb, s)).astype(np.float32)
    b = rng.uniform(0.01, 1.0, (r, ref_pol.n_actions(topo), s, s)
                    ).astype(np.float32)
    return a, b


@pytest.mark.parametrize("topo", TOPOS, ids=IDS)
def test_model_cache_fields_equal_reference(topo):
    pt = port_topo(topo)
    cfg_r, cfg_p = ref_gen.AifConfig(topology=topo), \
        generative.AifConfig(topology=pt)
    a, b = _random_counts(topo, 1, 0)
    model_r = ref_gen.init_generative_model(cfg_r)._replace(
        a_counts=jnp.asarray(a[0]), b_counts=jnp.asarray(b[0]))
    model_p = generative.init_generative_model(cfg_p, "cpu")._replace(
        a_counts=torch.tensor(a[0]), b_counts=torch.tensor(b[0]))
    cache_r = ref_gen.derive_cache(model_r, topo)
    cache_p = generative.derive_cache(model_p, pt)
    for field in ref_gen.ModelCache._fields:
        assert_close(getattr(cache_p, field), getattr(cache_r, field),
                     err_msg=field)
    # the prior model and its cache
    init_r = ref_gen.init_generative_model(cfg_r)
    init_p = generative.init_generative_model(cfg_p, "cpu")
    for field in ref_gen.GenerativeModel._fields:
        assert_close(getattr(init_p, field), getattr(init_r, field),
                     rtol=0, atol=0, err_msg=field)


@pytest.mark.parametrize("topo", TOPOS, ids=IDS)
def test_preferences_and_masked_terms_equal_reference(topo):
    pt = port_topo(topo)
    cfg_r, cfg_p = ref_gen.AifConfig(topology=topo), \
        generative.AifConfig(topology=pt)
    ema = np.float32([0.0, 0.1, 0.2, 0.5])
    c_r, uns_r = ref_pref.adapt_preferences(jnp.asarray(ema), cfg_r)
    c_p, uns_p = preferences.adapt_preferences(torch.tensor(ema), cfg_p)
    assert_close(c_p, c_r, rtol=0, atol=0)
    np.testing.assert_array_equal(t2n(uns_p), np.asarray(uns_r))
    assert_close(generative.masked_log_c(c_p, pt),
                 ref_gen.masked_log_c(c_r, topo))
    for p_tab, r_tab in zip(preferences.preference_log_tables(cfg_p, "cpu"),
                            ref_pref.preference_log_tables(cfg_r)):
        assert_close(p_tab, r_tab)
    assert_close(preferences.ema_update(torch.tensor(ema),
                                        torch.tensor(ema[::-1].copy()),
                                        cfg_p),
                 ref_pref.ema_update(jnp.asarray(ema),
                                     jnp.asarray(ema[::-1].copy()), cfg_r))

    a, _ = _random_counts(topo, 3, 1)
    na_r = jnp.stack([ref_gen.normalize_a(jnp.asarray(x), topo) for x in a])
    na_p = generative.normalize_a(torch.tensor(a), pt)
    assert_close(na_p, na_r)
    amb_m_p = generative.modality_ambiguity_from_normalized(na_p, pt)
    amb_m_r = ref_gen.modality_ambiguity_from_normalized(na_r, topo)
    assert_close(amb_m_p, amb_m_r)
    mask = np.random.default_rng(2).integers(
        0, 2, (3, topo.n_modalities)).astype(np.float32)
    mask[0] = 1.0                                   # unmasked row
    assert_close(generative.masked_ambiguity(amb_m_p, torch.tensor(mask)),
                 ref_gen.masked_ambiguity(amb_m_r, jnp.asarray(mask)))
    # masked and unmasked observation log-likelihood, utilization scrape
    obs = np.random.default_rng(3).integers(0, 2, (3, topo.n_modalities))
    for m in (None, mask):
        got = belief.log_likelihood_from_normalized(
            na_p, torch.tensor(obs), None if m is None else torch.tensor(m))
        want = ref_belief.log_likelihood_from_normalized(
            na_r, jnp.asarray(obs), None if m is None else jnp.asarray(m))
        assert_close(got, want)
    util = np.random.default_rng(4).integers(0, topo.n_levels,
                                             (3, topo.n_tiers))
    assert_close(belief.util_log_likelihood(torch.tensor(util), pt),
                 ref_belief.util_log_likelihood(jnp.asarray(util), topo))


def test_posterior_and_entropy_equal_reference():
    rng = np.random.default_rng(5)
    logp = rng.normal(0.0, 3.0, (4, 243)).astype(np.float32)
    q_p = belief.posterior_from_logp(torch.tensor(logp))
    for i in range(4):
        q_r = ref_belief.posterior_from_logp(jnp.asarray(logp[i]))
        assert_close(q_p[i], q_r)
        assert_close(belief.belief_entropy(q_p[i]),
                     ref_belief.belief_entropy(q_r))
