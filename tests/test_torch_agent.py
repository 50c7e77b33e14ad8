"""The port's single-agent AIF tick (``repro_torch.core.agent.tick``, R=1)
and its router adapter against the reference's ``repro.core.tick`` and
``repro.envsim.routers.AifRouter``, on the same draws
(``RouterKeyChainNoise`` replays the router's key chain: Gumbel noise at
``k_fast``, replay indices at ``k_slow``).

The bar is the port's: equal actions on every tick, and floats (belief,
the EFE breakdown, learned counts) within rtol 1e-4 / atol 1e-6 — both
sides compute in float32 but sum in different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as ref_core
from repro.core import belief as ref_belief
from repro.core import efe as ref_efe
from repro.envsim.routers import AifRouter as RefAifRouter
from repro.envsim.simulator import MetricsSnapshot as RefSnapshot
from repro_torch.core import agent, belief, efe, fleet, generative
from repro_torch.envsim.routers import AifRouter
from repro_torch.envsim.simulator import MetricsSnapshot
from torch_port_ref import (RouterKeyChainNoise, assert_close, t2n,
                            to_numpy)

N_TICKS = 23


def _observations(cfg, seed, n, masked):
    topo = cfg.topology
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        bins = np.array([rng.integers(0, nb) for nb in topo.n_bins],
                        np.int32)
        err = np.float32(rng.uniform(0.0, 0.4))
        util = rng.integers(0, topo.n_levels, topo.n_tiers).astype(np.int32)
        mask = None
        if masked:
            mask = rng.integers(0, 2, topo.n_modalities).astype(np.float32)
            if t % 7 == 3:
                mask[:] = 0.0            # a fully dark tick: prior fallback
        out.append((bins, err, util, t % 10 == 0 and t > 0 and t % 7 != 3,
                    mask))
    return out


@pytest.mark.parametrize("masked", [False, True])
def test_tick_matches_reference_on_every_tick(masked):
    cfg_ref = ref_core.AifConfig()
    cfg = generative.AifConfig()
    ref_state = ref_core.init_agent_state(cfg_ref)
    state = fleet.init_fleet_state(cfg, 1, "cpu")
    noise = RouterKeyChainNoise(0, N_TICKS)
    key = jax.random.key(0)
    for t, (bins, err, util, valid, mask) in enumerate(
            _observations(cfg, 1, N_TICKS, masked)):
        key, k = jax.random.split(key)
        ref_state, info_ref = ref_core.tick(
            ref_state, jnp.asarray(bins), jnp.asarray(err), k, cfg_ref,
            jnp.asarray(util), valid,
            None if mask is None else jnp.asarray(mask))
        state, info = agent.tick(
            state, torch.from_numpy(bins)[None], torch.tensor([err]), cfg,
            noise, t, torch.from_numpy(util)[None], valid,
            None if mask is None else torch.from_numpy(mask)[None])
        msg = f"tick {t}"
        assert int(info.action[0]) == int(info_ref.action), msg
        assert bool(info.unstable[0]) == bool(info_ref.unstable), msg
        np.testing.assert_array_equal(t2n(info.routing_weights[0]),
                                      np.asarray(info_ref.routing_weights))
        for field in ("g", "risk", "ambiguity", "action_probs"):
            assert_close(getattr(info.efe, field)[0],
                         getattr(info_ref.efe, field), err_msg=f"{msg} {field}")
        assert_close(info.belief_entropy[0], info_ref.belief_entropy,
                     err_msg=msg)
        assert_close(state.belief[0], ref_state.belief, err_msg=msg)
    ref_np = to_numpy(ref_state)
    for field in ("a_counts", "b_counts"):
        assert_close(getattr(state.model, field)[0], ref_np["model"][field],
                     err_msg=field)
    assert_close(state.cache.nb[0], ref_np["cache"]["nb"])
    assert int(state.replay.size[0]) == int(ref_np["replay"]["size"])
    assert int(state.t[0]) == int(ref_np["t"]) == N_TICKS


def test_belief_and_efe_from_counts_match_reference():
    """The uncached paths: predict_prior and log_likelihood from
    pseudo-counts, the all-masked fallback, and G with an obs_mask."""
    cfg = generative.AifConfig()
    cfg_ref = ref_core.AifConfig()
    topo, topo_ref = cfg.topology, cfg_ref.topology
    rng = np.random.default_rng(7)
    s, a, m, nb = topo.n_states, cfg.n_actions, topo.n_modalities, topo.max_bins
    mask_bins = np.asarray(ref_core.spaces.bins_mask(topo_ref))
    a_counts = (rng.uniform(0.1, 2.0, (m, nb, s)) * mask_bins[:, :, None]
                ).astype(np.float32)
    b_counts = rng.uniform(0.01, 1.0, (a, s, s)).astype(np.float32)
    c_log = np.asarray(ref_core.generative.nominal_c_log(cfg_ref))
    q = rng.dirichlet(np.ones(s)).astype(np.float32)
    d = np.full(s, 1.0 / s, np.float32)
    bins = np.array([1, 2, 0, 1], np.int32)
    util = np.array([2, 0, 1], np.int32)
    ref_model = ref_core.generative.GenerativeModel(
        a_counts=jnp.asarray(a_counts), b_counts=jnp.asarray(b_counts),
        c_log=jnp.asarray(c_log), d_prior=jnp.asarray(d))
    model = generative.GenerativeModel(*(torch.tensor(x)[None] for x in
                                         (a_counts, b_counts, c_log, d)))
    ref_update = jax.jit(ref_belief.update_belief, static_argnames="topo")
    ref_g = jax.jit(ref_efe.expected_free_energy, static_argnames="cfg")
    for mask, valid in ((None, True), (np.array([1, 0, 1, 0], np.float32),
                                       False),
                        (np.zeros(4, np.float32), False),
                        (np.zeros(4, np.float32), True)):
        want = ref_update(
            ref_model, jnp.asarray(q), 3, jnp.asarray(bins), topo=topo_ref,
            util_bins=jnp.asarray(util), util_valid=valid,
            obs_mask=None if mask is None else jnp.asarray(mask))
        got = belief.update_belief(
            model, torch.from_numpy(q)[None], torch.tensor([3]),
            torch.from_numpy(bins)[None], topo, torch.from_numpy(util)[None],
            valid, obs_mask=None if mask is None else torch.from_numpy(mask)[None])
        assert_close(got[0], want, err_msg=f"mask {mask} valid {valid}")
        bd_ref = ref_g(ref_model, jnp.asarray(q), cfg=cfg_ref,
                       obs_mask=None if mask is None else jnp.asarray(mask))
        bd = efe.expected_free_energy(
            model, torch.from_numpy(q)[None], cfg,
            obs_mask=None if mask is None else torch.from_numpy(mask)[None])
        for field in ("g", "risk", "ambiguity", "cost", "action_probs"):
            assert_close(getattr(bd, field)[0], getattr(bd_ref, field),
                         err_msg=field)
    # all masked, no scrape: exactly the renormalized prior
    prior = belief.predict_prior(model.b_counts, torch.from_numpy(q)[None],
                                 torch.tensor([3]))
    dark = belief.update_belief(
        model, torch.from_numpy(q)[None], torch.tensor([3]),
        torch.from_numpy(bins)[None], topo, obs_mask=torch.zeros(1, 4))
    torch.testing.assert_close(dark, prior / prior.sum(-1, keepdim=True))


def _snapshots(n, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n):
        kw = dict(t=float(t), p95_latency_s=float(rng.uniform(0, 9)),
                  rps=float(rng.uniform(0, 8)),
                  queue_depth=float(rng.integers(0, 14)),
                  error_rate=float(rng.choice([0.0, 0.5, 0.9])),
                  tier_utilization=rng.uniform(0, 1, 3),
                  tier_queue_depth=rng.integers(0, 5, 3).astype(float),
                  tier_up=np.ones(3, bool))
        out.append((RefSnapshot(**kw), MetricsSnapshot(**kw)))
    return out


@pytest.mark.parametrize("adaptive", [True, False])
def test_router_weights_match_reference(adaptive):
    ref_router = RefAifRouter(seed=2, adaptive_preferences=adaptive)
    router = AifRouter(seed=2, adaptive_preferences=adaptive,
                       noise=RouterKeyChainNoise(2, N_TICKS), device="cpu")
    for ref_snap, snap in _snapshots(N_TICKS):
        w_ref = ref_router(ref_snap)
        w = router(snap)
        assert w.dtype == np.float64
        np.testing.assert_array_equal(w, w_ref)
    assert router.actions == ref_router.actions
    assert router.unstable_trace == ref_router.unstable_trace
    if adaptive:
        assert any(router.unstable_trace)
