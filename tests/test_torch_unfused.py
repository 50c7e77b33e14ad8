"""The unfused AIF path (``fused=False``: the reference's vmapped
single-agent step, batched over R in plain PyTorch) and the fleet shims
around it, against the reference (mirrors ``tests/test_fleet.py``,
``tests/test_core_aif.py::test_fleet_matches_single_agent`` and the
fused-vs-vmap, light-step and slow-once-per-period rows of
``tests/test_quasistatic_cache.py``), plus ``hetero_fleet_rollout``.

Reference draws reach the port as noise operands (``JaxChainNoise`` for
the engine's chain, a per-router key source for single ticks), in the
reference's R1 PRNG mode.
"""
import warnings

import jax
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro import core as ref_core
from repro.core import fleet as ref_fleet
from repro.core.topology import default_topology as ref_default
from repro.core.topology import five_tier_topology as ref_five
from repro.envsim import batched as ref_batched
from repro.envsim import scenarios as ref_scen
from repro.envsim import config as ref_config
from repro_torch import api
from repro_torch.checkpoint.checkpointer import flatten
from repro_torch.core import agent, fleet, generative
from repro_torch.envsim import batched, scenarios
from repro_torch.envsim.config import (SimConfig, discretization_for,
                                       sim_config_for)
from repro_torch.noise import GeneratorNoise
from torch_port_ref import (JaxChainNoise, assert_close, assert_tree_close,
                            port_topo, t2n, two_tier_ref)

CFG = generative.AifConfig()


@pytest.fixture(autouse=True)
def _r1_prng_mode():
    with jax.threefry_partitionable(False):
        yield


# ------------------------------------------------------- Experiment parity
CASES = [("paper-burst", None), ("flaky-telemetry", None),
         ("paper-burst", "two-tier")]


@pytest.mark.parametrize("scenario,topo", CASES,
                         ids=["paper-burst", "flaky-telemetry", "two-tier"])
def test_unfused_experiment_matches_reference(scenario, topo):
    r, t, seed = 3, 30, 0
    ref_topo = two_tier_ref() if topo else "paper-3tier"
    ref = ref_api.run(ref_api.Experiment(
        router="aif", scenario=scenario, topology=ref_topo, n_cells=r,
        n_windows=t, seed=seed, fused=False))
    port = api.run(api.Experiment(
        router="aif", scenario=scenario,
        topology=port_topo(ref_topo) if topo else ref_topo, n_cells=r,
        n_windows=t, seed=seed, fused=False, device="cpu"),
        noise=JaxChainNoise(seed, r, t))
    np.testing.assert_array_equal(t2n(port.trace.actions),
                                  np.asarray(ref.trace.actions))
    for field in ("success_pct", "p50_ms", "p95_ms", "obs_frac", "restarts"):
        assert_close(getattr(port, field), getattr(ref, field),
                     err_msg=field)
    assert_close(port.trace.unstable, ref.trace.unstable)
    assert_tree_close(port.final_carry.model, ref.final_carry.model)
    assert_tree_close(port.final_carry.replay, ref.final_carry.replay)
    assert_close(port.final_carry.belief, ref.final_carry.belief)
    assert_tree_close(port.trace.env, ref.trace.env)


# ------------------------------------------------------------ single ticks
class KeyNoise:
    """The draws of the reference's ``core.tick`` for per-router keys:
    ``k_fast, k_slow = split(key)``, Gumbel at ``k_fast``, replay indices
    at ``k_slow``; one list of (R,) keys per tick."""

    def __init__(self, keys):
        self.keys = keys

    def _split(self, t):
        ks = jax.vmap(jax.random.split)(self.keys[t])
        return ks[:, 0], ks[:, 1]

    def gumbel(self, t, shape):
        g = jax.vmap(lambda k: jax.random.gumbel(k, (shape[-1],)))(
            self._split(t)[0])
        return torch.tensor(np.asarray(g))

    def replay_indices(self, t, size, batch):
        n = jax.numpy.maximum(jax.numpy.asarray(t2n(size), jax.numpy.int32),
                              1)
        idx = jax.vmap(lambda k, m: jax.random.randint(k, (batch,), 0, m))(
            self._split(t)[1], n)
        return torch.tensor(np.asarray(idx), dtype=torch.int64)


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, 2, size=(n, 4)).astype(np.int32)
    errs = rng.uniform(0.0, 0.3, size=(n,)).astype(np.float32)
    return obs, errs


def test_fleet_tick_per_router_matches_single_agent():
    """Router i of the unfused fleet evolves like the reference's lone
    agent fed the same (obs, error, key), over 11 ticks (one slow step)."""
    n, ticks = 3, 11
    obs, errs = _inputs(n, seed=1)
    keys = [jax.random.split(jax.random.key(7 + t), n) for t in range(ticks)]
    noise = KeyNoise(keys)
    ref_cfg = ref_core.AifConfig()
    fst = fleet.init_fleet_state(CFG, n, "cpu")
    singles = [ref_core.init_agent_state(ref_cfg) for _ in range(n)]
    ref_tick = jax.jit(ref_core.tick, static_argnames=("cfg",))
    for t in range(ticks):
        fst, finfo = fleet.fleet_tick(fst, torch.tensor(obs),
                                      torch.tensor(errs), noise, t, CFG,
                                      fused=False)
        for i in range(n):
            singles[i], info_i = ref_tick(singles[i], obs[i], errs[i],
                                          keys[t][i], cfg=ref_cfg)
            assert int(finfo.action[i]) == int(info_i.action)
            assert_close(finfo.efe.g[i], info_i.efe.g, rtol=1e-5)
            assert_close(finfo.efe.risk[i], info_i.efe.risk, rtol=1e-5)
    for i in range(n):
        assert_close(fst.belief[i], singles[i].belief, atol=1e-6)
        assert_close(fst.model.a_counts[i], singles[i].model.a_counts)
        assert_close(fst.model.b_counts[i], singles[i].model.b_counts)


def test_fleet_matches_single_agent():
    """Identical routers on identical inputs and keys pick the single
    agent's action (``test_core_aif``'s row)."""
    n = 4
    obs = np.tile(np.asarray([1, 1, 1, 0], np.int32), (n, 1))
    key = jax.random.key(3)
    keys = [jax.vmap(jax.random.wrap_key_data)(
        np.stack([np.asarray(jax.random.key_data(key))] * n))]
    fst, finfo = fleet.fleet_tick(fleet.init_fleet_state(CFG, n, "cpu"),
                                  torch.tensor(obs), torch.zeros(n),
                                  KeyNoise(keys), 0, CFG, fused=False)
    ref_cfg = ref_core.AifConfig()
    _, info = ref_core.tick(ref_core.init_agent_state(ref_cfg), obs[0],
                            np.float32(0.0), key, ref_cfg)
    assert_close(finfo.efe.g[0], info.efe.g, rtol=1e-5)
    assert (t2n(finfo.action) == int(info.action)).all()


def test_fused_tick_matches_unfused_tick():
    """The fused fleet tick reproduces the single-agent step: G within
    1e-5, the same actions, states close after a slow boundary."""
    n = 4
    obs, errs = _inputs(n, seed=3)
    obs, errs = torch.tensor(obs), torch.tensor(errs)
    state_v = fleet.init_fleet_state(CFG, n, "cpu")
    state_f = fleet.init_fleet_state(CFG, n, "cpu")
    noise_v, noise_f = GeneratorNoise(5, "cpu"), GeneratorNoise(5, "cpu")
    for t in range(11):
        state_v, info_v = fleet.fleet_tick(state_v, obs, errs, noise_v, t,
                                           CFG, fused=False)
        state_f, info_f = fleet.fleet_tick(state_f, obs, errs, noise_f, t,
                                           CFG, fused=True)
        assert_close(info_v.efe.g, t2n(info_f.efe.g), rtol=1e-5)
        np.testing.assert_array_equal(t2n(info_v.action), t2n(info_f.action))
    assert_close(state_v.belief, t2n(state_f.belief))
    assert_close(state_v.model.a_counts, t2n(state_f.model.a_counts))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_light_step_matches_fast_step_on_held_ticks(fused):
    """On a tick with t % dwell != 0 the sampled action is discarded, so the
    light step (no EFE) evolves the state like the full fast step."""
    n = 3
    obs, errs = _inputs(n, seed=0)
    obs, errs = torch.tensor(obs), torch.tensor(errs)
    state = fleet.init_fleet_state(CFG, n, "cpu")
    noise = GeneratorNoise(0, "cpu")
    for t in range(2):
        state, _ = fleet.fleet_tick(state, obs, errs, noise, t, CFG,
                                    fused=fused)
    assert int(state.t[0]) % int(CFG.action_dwell_s) != 0
    gumbel = noise.gumbel(2, (n, CFG.n_actions))
    copy = fleet._map_state(torch.clone, state)
    s_full, info_full = fleet.fleet_fast_step(state, obs, errs, gumbel, CFG,
                                              fused=fused)
    s_light, info_light = fleet.fleet_light_step(copy, obs, errs, CFG,
                                                 fused=fused)
    np.testing.assert_array_equal(t2n(info_full.action),
                                  t2n(info_light.action))
    full, light = flatten(s_full), flatten(s_light)
    assert full.keys() == light.keys()
    for name in full:
        np.testing.assert_allclose(t2n(full[name]), t2n(light[name]),
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_slow_step_executes_once_per_period(fused, monkeypatch):
    calls = []
    orig = agent.slow_step

    def counting(state, idx, cfg, learn=None):
        calls.append(1)
        return orig(state, idx, cfg, learn)

    monkeypatch.setattr(agent, "slow_step", counting)
    r, t = 2, 25                           # 2 slow periods + 5-tick remainder
    res = api.run(api.Experiment(n_cells=r, n_windows=t, fused=fused,
                                 device="cpu"))
    period = int(CFG.slow_period_s / CFG.fast_period_s)
    assert len(calls) == t // period == 2
    init = fleet.init_fleet_state(CFG, r, "cpu")
    assert float(res.final_carry.model.a_counts.sum()) > float(
        init.model.a_counts.sum())


def _world(topo, r, t):
    scfg = SimConfig() if topo.n_tiers == 3 else sim_config_for(topo)
    sc = scenarios.build_scenario("paper-burst", scfg, r, t)
    params = batched.params_from_config(scfg, r, sc.capacity_scale,
                                        device="cpu")
    disc = None if topo.n_tiers == 3 else discretization_for(scfg)
    return params, batched.make_scenario_env_step(params, sc), disc


@pytest.mark.parametrize("topo", [ref_default(), ref_five()],
                         ids=["paper-3tier", "continuum-5tier"])
def test_fused_rollout_trace_parity(topo):
    """Fused vs unfused whole rollouts on the port: identical action and
    weight traces; T=23 crosses two slow boundaries and ends in a
    remainder."""
    r, t = 3, 23
    topo = port_topo(topo)
    cfg = generative.AifConfig(topology=topo)
    params, env_step, disc = _world(topo, r, t)
    out = {}
    for fused in (False, True):
        router = api.AifRouter(cfg=cfg, disc=disc, fused=fused)
        out[fused] = api.rollout(router, router.init_carry(r, "cpu"),
                                 batched.init_fluid_state(params), env_step,
                                 t, seed=11)
    (c_v, e_v, tr_v), (c_f, e_f, tr_f) = out[False], out[True]
    np.testing.assert_array_equal(t2n(tr_v.actions), t2n(tr_f.actions))
    np.testing.assert_array_equal(t2n(tr_v.routing_weights),
                                  t2n(tr_f.routing_weights))
    np.testing.assert_array_equal(t2n(tr_v.unstable), t2n(tr_f.unstable))
    np.testing.assert_allclose(t2n(c_v.belief), t2n(c_f.belief), atol=1e-5)
    np.testing.assert_allclose(t2n(c_v.model.b_counts),
                               t2n(c_f.model.b_counts), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(t2n(e_v.n_success), t2n(e_f.n_success),
                               rtol=1e-5)


def test_fleet_rollout_shim_warns_and_matches_api():
    r, t = 2, 12
    params, env_step, _ = _world(port_topo(ref_default()), r, t)
    with pytest.warns(DeprecationWarning, match="repro_torch.api"):
        c_a, e_a, tr_a = fleet.fleet_rollout(
            fleet.init_fleet_state(CFG, r, "cpu"),
            batched.init_fluid_state(params), env_step, t, None, CFG,
            fused=False, seed=9)
    router = api.AifRouter(cfg=CFG, fused=False)
    c_b, e_b, tr_b = api.rollout(router, router.init_carry(r, "cpu"),
                                 batched.init_fluid_state(params), env_step,
                                 t, seed=9)
    np.testing.assert_array_equal(t2n(tr_a.actions), t2n(tr_b.actions))
    assert torch.equal(c_a.belief, c_b.belief)
    assert torch.equal(e_a.n_success, e_b.n_success)


# ------------------------------------------------------- heterogeneous fleet
def _ref_group(name, topo, r, t, fused):
    cfg = ref_core.AifConfig(topology=topo)
    scfg = (ref_config.SimConfig() if topo.n_tiers == 3
            else ref_config.sim_config_for(topo))
    sc = ref_scen.build_scenario("paper-burst", scfg, r, t)
    params = ref_batched.params_from_config(scfg, r, sc.capacity_scale)
    return ref_fleet.FleetGroup(
        name=name, cfg=cfg, agent_state=ref_fleet.init_fleet_state(cfg, r),
        env_state=ref_batched.init_fluid_state(params),
        env_step=ref_batched.make_scenario_env_step(params, sc), fused=fused,
        disc=(None if topo.n_tiers == 3
              else ref_config.discretization_for(scfg)))


def _port_group(name, topo, r, t, fused):
    topo = port_topo(topo)
    cfg = generative.AifConfig(topology=topo)
    params, env_step, disc = _world(topo, r, t)
    return fleet.FleetGroup(
        name=name, cfg=cfg, agent_state=fleet.init_fleet_state(cfg, r, "cpu"),
        env_state=batched.init_fluid_state(params), env_step=env_step,
        fused=fused, disc=disc)


def test_hetero_fleet_rollout_matches_reference():
    t = 20
    specs = [("edge-3tier", ref_default(), 2, False),
             ("continuum-5tier", ref_five(), 2, True)]
    key = jax.random.key(4)
    ref = ref_fleet.hetero_fleet_rollout(
        [_ref_group(n, tp, r, t, f) for n, tp, r, f in specs], t, key)
    noises = [JaxChainNoise(0, r, t, key=jax.random.fold_in(key, i))
              for i, (_, _, r, _) in enumerate(specs)]
    port = fleet.hetero_fleet_rollout(
        [_port_group(n, tp, r, t, f) for n, tp, r, f in specs], t, noises)
    assert set(port) == {"edge-3tier", "continuum-5tier"}
    for name, *_ in specs:
        (c_p, e_p, tr_p), (c_r, e_r, tr_r) = port[name], ref[name]
        np.testing.assert_array_equal(t2n(tr_p.actions),
                                      np.asarray(tr_r.actions), err_msg=name)
        assert_close(c_p.belief, c_r.belief, err_msg=name)
        assert_tree_close(e_p, e_r, path=name)


def test_hetero_fleet_rollout_options():
    with pytest.raises(TypeError, match="use_palas"):
        fleet.hetero_fleet_rollout([], 5, use_palas=True)
    with pytest.raises(TypeError, match="fused"):
        fleet.hetero_fleet_rollout([], 5, fused=True)
    g = _port_group("a", ref_default(), 2, 8, True)
    with pytest.raises(ValueError, match="duplicate"):
        fleet.hetero_fleet_rollout([g, g], 8)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = fleet.hetero_fleet_rollout(
            [g, _port_group("b", ref_default(), 2, 8, False)], 8, seed=1,
            t0=0)
    # each group draws its own stream: same world, other actions
    assert not torch.equal(out["a"][2].actions, out["b"][2].actions)
    assert fleet.group_seed(1, 0) != fleet.group_seed(1, 1)
