"""Port parity of the fused fleet tick: fast (selecting), light (held) and
slow steps and the watchdog, with the reference's draws injected.

A non-trivial batched agent state (learned-looking counts, a part-filled
replay ring, mixed actions and EMAs) is built on the reference side and
carried across with ``agent_state_from_numpy``; both sides then take one
step on the same observations and the same random numbers, and every leaf
of the new state is compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fleet as ref_fleet
from repro.core import generative as ref_gen
from repro.core import policies as ref_pol
from repro.core.topology import default_topology, five_tier_topology
from repro_torch.core import fleet, generative
from torch_port_ref import (assert_close, assert_tree_close, port_topo,
                            t2n, to_numpy)

CAP = 16        # a small ring: the path is the same as at 5000


def _ref_state(topo, r, t, seed):
    cfg = ref_gen.AifConfig(topology=topo, replay_capacity=CAP)
    rng = np.random.default_rng(seed)
    s, m, nbins = topo.n_states, topo.n_modalities, topo.max_bins
    a_n = ref_pol.n_actions(topo)
    st = ref_fleet.init_fleet_state(cfg, r)
    model = st.model._replace(
        a_counts=jnp.asarray(rng.uniform(0.1, 2.0, (r, m, nbins, s)),
                             jnp.float32),
        b_counts=jnp.asarray(rng.uniform(0.01, 1.0, (r, a_n, s, s)),
                             jnp.float32))
    cache = jax.vmap(lambda mo: ref_gen.derive_cache(mo, topo))(model)
    n_fill = 7
    rp = st.replay
    replay = rp._replace(
        q_prev=rp.q_prev.at[:, :n_fill].set(jnp.asarray(
            rng.dirichlet(np.ones(s), (r, n_fill)), jnp.float32)),
        q_next=rp.q_next.at[:, :n_fill].set(jnp.asarray(
            rng.dirichlet(np.ones(s), (r, n_fill)), jnp.float32)),
        obs_bins=rp.obs_bins.at[:, :n_fill].set(jnp.asarray(
            rng.integers(0, 2, (r, n_fill, m)), jnp.int32)),
        obs_mask=rp.obs_mask.at[:, :n_fill].set(jnp.asarray(
            rng.integers(0, 2, (r, n_fill, m)), jnp.float32)),
        action=rp.action.at[:, :n_fill].set(jnp.asarray(
            rng.integers(0, a_n, (r, n_fill)), jnp.int32)),
        dt_since_change=rp.dt_since_change.at[:, :n_fill].set(jnp.asarray(
            rng.uniform(0, 8, (r, n_fill)), jnp.float32)),
        cursor=jnp.full((r,), n_fill, jnp.int32),
        size=jnp.full((r,), n_fill, jnp.int32))
    st = st._replace(
        model=model, cache=cache, replay=replay,
        belief=jnp.asarray(rng.dirichlet(np.ones(s), r), jnp.float32),
        prev_action=jnp.asarray(rng.integers(0, a_n, r), jnp.int32),
        dt_since_change=jnp.asarray(rng.uniform(0, 6, r), jnp.float32),
        error_ema=jnp.asarray(rng.uniform(0, 0.3, r), jnp.float32),
        t=jnp.full((r,), t, jnp.int32))
    return cfg, st


def _port(cfg, st):
    cfg_p = generative.AifConfig(topology=port_topo(cfg.topology),
                                 replay_capacity=CAP)
    return cfg_p, fleet.agent_state_from_numpy(to_numpy(st), cfg_p, "cpu")


def _tick_inputs(topo, r, masked, seed):
    rng = np.random.default_rng(seed)
    m = topo.n_modalities
    obs = rng.integers(0, 2, (r, m)).astype(np.int32)
    err = rng.uniform(0, 0.4, r).astype(np.float32)
    util = rng.integers(0, topo.n_levels, (r, topo.n_tiers)).astype(np.int32)
    mask = None
    if masked:
        mask = rng.integers(0, 2, (r, m)).astype(np.float32)
        mask[0] = 1.0
    return obs, err, util, mask


def _opt(x, dtype=torch.float32):
    return None if x is None else torch.tensor(x, dtype=dtype)


CASES = [(default_topology(), False, True), (default_topology(), True, False),
         (five_tier_topology(), True, True)]
IDS = ["k3-clean-scrape", "k3-masked", "k5-masked-scrape"]


@pytest.mark.parametrize("topo,masked,util_valid", CASES, ids=IDS)
def test_fused_fast_step_matches_reference(topo, masked, util_valid):
    r = 3
    cfg, st = _ref_state(topo, r, t=5, seed=1)
    obs, err, util, mask = _tick_inputs(topo, r, masked, seed=2)
    keys = jax.random.split(jax.random.key(3), r)
    new_r, info_r = ref_fleet.fleet_fast_step(
        st, jnp.asarray(obs), jnp.asarray(err), keys, cfg,
        jnp.asarray(util), util_valid,
        None if mask is None else jnp.asarray(mask), fused=True,
        use_pallas=True)
    a_n = ref_pol.n_actions(topo)
    gumbel = torch.tensor(np.asarray(
        jax.vmap(lambda k: jax.random.gumbel(k, (a_n,)))(keys)))
    cfg_p, st_p = _port(cfg, st)
    new_p, info_p = fleet.fleet_fast_step(
        st_p, torch.tensor(obs), torch.tensor(err), gumbel, cfg_p,
        torch.tensor(util), util_valid, _opt(mask))
    np.testing.assert_array_equal(t2n(info_p.action),
                                  np.asarray(info_r.action))
    assert_tree_close(new_p, new_r)
    assert_close(info_p.efe.g, info_r.efe.g)
    assert_close(info_p.efe.action_probs, info_r.efe.action_probs)
    assert_close(info_p.routing_weights, info_r.routing_weights)
    assert_close(info_p.belief_entropy, info_r.belief_entropy)
    assert_close(info_p.obs_mask, info_r.obs_mask)


@pytest.mark.parametrize("topo,masked,util_valid", CASES, ids=IDS)
def test_fused_light_step_matches_reference(topo, masked, util_valid):
    r = 3
    cfg, st = _ref_state(topo, r, t=7, seed=4)
    obs, err, util, mask = _tick_inputs(topo, r, masked, seed=5)
    new_r, info_r = ref_fleet.fleet_light_step(
        st, jnp.asarray(obs), jnp.asarray(err), cfg, jnp.asarray(util),
        util_valid, None if mask is None else jnp.asarray(mask), fused=True)
    cfg_p, st_p = _port(cfg, st)
    new_p, info_p = fleet.fleet_light_step(
        st_p, torch.tensor(obs), torch.tensor(err), cfg_p,
        torch.tensor(util), util_valid, _opt(mask))
    np.testing.assert_array_equal(t2n(info_p.action),
                                  np.asarray(info_r.action))
    assert_tree_close(new_p, new_r)
    assert_close(info_p.belief_entropy, info_r.belief_entropy)


@pytest.mark.parametrize("topo", [default_topology(), five_tier_topology()],
                         ids=["k3", "k5"])
@pytest.mark.parametrize("t", [10, 13], ids=["boundary", "off-boundary"])
def test_fleet_slow_step_matches_reference(topo, t):
    """Replay draws injected; off the boundary nothing may change."""
    r = 3
    cfg, st = _ref_state(topo, r, t=t, seed=6)
    keys = jax.random.split(jax.random.key(7), r)
    new_r = ref_fleet.fleet_slow_step(st, keys, cfg)
    idx = jax.vmap(lambda k, n: jax.random.randint(
        k, (cfg.replay_batch,), 0, jnp.maximum(n, 1)))(keys, st.replay.size)
    cfg_p, st_p = _port(cfg, st)
    new_p = fleet.fleet_slow_step(st_p, torch.tensor(np.asarray(idx)),
                                  cfg_p)
    assert_tree_close(new_p, new_r)
    if t % 10:
        assert_close(new_p.model.b_counts, st.model.b_counts, rtol=0, atol=0)


def test_mixed_clock_slow_step_learns_only_on_boundary_cells():
    topo = default_topology()
    cfg, st = _ref_state(topo, 3, t=10, seed=8)
    st = st._replace(t=jnp.asarray([10, 11, 20], jnp.int32))
    keys = jax.random.split(jax.random.key(9), 3)
    new_r = ref_fleet.fleet_slow_step(st, keys, cfg)
    idx = jax.vmap(lambda k, n: jax.random.randint(
        k, (cfg.replay_batch,), 0, jnp.maximum(n, 1)))(keys, st.replay.size)
    cfg_p, st_p = _port(cfg, st)
    new_p = fleet.fleet_slow_step(st_p, torch.tensor(np.asarray(idx)), cfg_p)
    assert_tree_close(new_p, new_r)


def test_watchdog_quarantine_matches_reference():
    topo = default_topology()
    cfg, st = _ref_state(topo, 3, t=5, seed=10)
    st = st._replace(
        belief=st.belief.at[1, 0].set(jnp.nan),
        error_ema=st.error_ema.at[2].set(jnp.inf))
    bad_r = ref_fleet.fleet_watchdog_bad(st)
    new_r = ref_fleet.fleet_quarantine(st, bad_r, cfg)
    cfg_p, st_p = _port(cfg, st)
    bad_p = fleet.fleet_watchdog_bad(st_p)
    np.testing.assert_array_equal(t2n(bad_p), np.asarray(bad_r))
    assert t2n(bad_p).tolist() == [False, True, True]
    new_p = fleet.fleet_quarantine(st_p, bad_p, cfg_p)
    assert_tree_close(new_p, new_r)
