"""Port parity of the batched fluid engine and the scenario library.

The scenario schedules must equal the reference's exactly (host numpy on
both sides); the fluid engine, driven by the reference's restart uniforms
under the uniform router's weights, must track the reference window by
window.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policies as ref_pol
from repro.envsim import batched as ref_batched
from repro.envsim import scenarios as ref_scen
from repro.envsim.config import SimConfig as RefSimConfig
from repro_torch.core import policies
from repro_torch.envsim import batched, scenarios
from repro_torch.envsim.config import SimConfig, sim_config_for
from torch_port_ref import (RunFluidNoise, assert_close, assert_tree_close,
                            env_uniforms, port_topo, ref_topologies,
                            to_numpy)

PORTED = ("steady", "paper-burst", "diurnal", "flash-crowd", "cascade",
          "hetero-diurnal", "flaky-telemetry", "scrape-blackout",
          "stale-cascade")


@pytest.mark.parametrize("name", PORTED)
def test_scenario_schedules_equal_reference(name):
    r, t = 5, 40
    got = scenarios.build_scenario(name, SimConfig(), r, t, seed=3)
    want = ref_scen.build_scenario(name, RefSimConfig(), r, t, seed=3)
    for field in ref_scen.ScenarioBatch._fields:
        a, b = getattr(got, field), getattr(want, field)
        if b is None or isinstance(b, bool):
            assert a == b, field
        else:
            np.testing.assert_array_equal(a, b, err_msg=field)


def test_sim_configs_equal_reference_for_every_topology():
    from repro.envsim.config import discretization_for as ref_disc_for
    from repro.envsim.config import sim_config_for as ref_sim_config_for
    from repro_torch.envsim.config import discretization_for
    for topo in ref_topologies():
        got, want = sim_config_for(port_topo(topo)), ref_sim_config_for(topo)
        assert repr(got) == repr(want)
        assert repr(discretization_for(got)) == repr(ref_disc_for(want))
    assert repr(SimConfig()) == repr(RefSimConfig())


def test_waiting_scenarios_raise(monkeypatch):
    # every preset of the reference is ported (the graph presets since the
    # networked continuum); a preset listed in WAITING raises naming its item
    assert scenarios.WAITING == {}
    assert set(scenarios.SCENARIOS) == set(ref_scen.SCENARIOS)
    scenarios.build_scenario("ring-spillover", SimConfig(), 4, 10)
    monkeypatch.setitem(scenarios.WAITING, "hier-continuum", "A99")
    with pytest.raises(NotImplementedError, match="A99"):
        scenarios.build_scenario("hier-continuum", SimConfig(), 4, 10)


def _world(name, r, t, seed=0):
    sc_r = ref_scen.build_scenario(name, RefSimConfig(), r, t, seed=seed)
    sc_p = scenarios.build_scenario(name, SimConfig(), r, t, seed=seed)
    params_r = ref_batched.params_from_config(RefSimConfig(), r,
                                              sc_r.capacity_scale)
    params_p = batched.params_from_config(SimConfig(), r, sc_p.capacity_scale,
                                          device="cpu")
    return sc_r, sc_p, params_r, params_p


def test_params_and_state_carry_across():
    _, _, params_r, params_p = _world("paper-burst", 3, 10)
    carried = batched.fluid_params_from_numpy(to_numpy(params_r), "cpu")
    for field in ref_batched.FluidParams._fields:
        assert_close(getattr(params_p, field), getattr(params_r, field),
                     rtol=0, atol=0, err_msg=field)
        assert_close(getattr(carried, field), getattr(params_r, field),
                     rtol=0, atol=0, err_msg=field)
    st = batched.fluid_state_from_numpy(
        to_numpy(ref_batched.init_fluid_state(params_r)), "cpu")
    assert_tree_close(st, ref_batched.init_fluid_state(params_r))


@pytest.mark.parametrize("name", ["steady", "paper-burst", "flaky-telemetry",
                                  "scrape-blackout"])
def test_fluid_window_step_matches_reference(name):
    """Step by step from a carried mid-run state, so each window starts
    from the same values on both sides."""
    r, t = 4, 25
    sc_r, sc_p, params_r, params_p = _world(name, r, t)
    w = np.tile(policies.balanced_weights(3).astype(np.float32), (r, 1))
    st_r = ref_batched.init_fluid_state(params_r)
    key = jax.random.key(5)
    for i in range(t):
        key, k = jax.random.split(key)
        ov = None if sc_r.obs_valid is None else sc_r.obs_valid[i]
        st_p = batched.fluid_state_from_numpy(to_numpy(st_r), "cpu")
        st_r, info_r = ref_batched.fluid_window_step(
            params_r, st_r, jnp.asarray(w), jnp.asarray(sc_r.arrival_rate[i]),
            jnp.asarray(sc_r.hazard_scale[i]), k, jnp.int32(i),
            obs_valid=None if ov is None else jnp.asarray(ov),
            restart_blackout=sc_r.restart_blackout)
        st_p, info_p = batched.fluid_window_step(
            params_p, st_p, torch.tensor(w),
            torch.tensor(sc_p.arrival_rate[i]),
            torch.tensor(sc_p.hazard_scale[i]), env_uniforms(k, (r, 3)), i,
            obs_valid=None if ov is None else torch.tensor(ov),
            restart_blackout=sc_p.restart_blackout)
        assert_tree_close(st_p, st_r, path=f"{name}@{i}")
        assert_tree_close(info_p, info_r, path=f"{name}@{i}.info")


@pytest.mark.parametrize("name", ["steady", "paper-burst", "flaky-telemetry"])
def test_run_fluid_matches_reference(name):
    r, t = 4, 30
    sc_r, sc_p, params_r, params_p = _world(name, r, t)
    w = np.asarray(ref_pol.generate_policy_table(
        ref_topologies()[1])[0])
    key = jax.random.key(11)
    fin_r, tr_r = ref_batched.run_fluid(
        params_r, jnp.asarray(sc_r.arrival_rate),
        jnp.asarray(sc_r.hazard_scale), jnp.asarray(w), key,
        obs_valid=(None if sc_r.obs_valid is None
                   else jnp.asarray(sc_r.obs_valid)),
        restart_blackout=sc_r.restart_blackout)
    fin_p, tr_p = batched.run_fluid(
        params_p, torch.tensor(sc_p.arrival_rate),
        torch.tensor(sc_p.hazard_scale), torch.tensor(w),
        RunFluidNoise(key, t),
        obs_valid=(None if sc_p.obs_valid is None
                   else torch.tensor(sc_p.obs_valid)),
        restart_blackout=sc_p.restart_blackout)
    assert_tree_close(fin_p, fin_r)
    assert_tree_close(tr_p, tr_r)
    sum_p, sum_r = batched.summarize(fin_p, tr_p), \
        ref_batched.summarize(fin_r, tr_r)
    for field in ("success_rate", "p50_ms", "p95_ms", "tier_success"):
        assert_close(getattr(sum_p, field), getattr(sum_r, field),
                     err_msg=field)


def test_weighted_p95_matches_reference():
    rng = np.random.default_rng(0)
    lat = rng.uniform(0.1, 5.0, (64, 5)).astype(np.float32)
    lat[0, 1] = lat[0, 3]                  # a tie keeps the stable order
    mass = rng.uniform(0.0, 3.0, (64, 5)).astype(np.float32)
    mass[1] = 0.0
    assert_close(batched._weighted_p95(torch.tensor(lat), torch.tensor(mass)),
                 ref_batched._weighted_p95(jnp.asarray(lat),
                                           jnp.asarray(mass)))


def test_waiting_env_options_raise():
    """Row blocks of the sharded engine (once refused, ROADMAP A10): R=3
    padded to 4, a mid-run window over two blocks of 2 rows against the
    reference's row-block window on the same restart key (drawn at the true
    R, phantom row 1.0), and a block of the whole fleet equal to the bit to
    the unsharded window."""
    r_true, r_pad, t = 3, 4, 5
    sc_r, sc_p, _, _ = _world("paper-burst", r_true, 8)
    sc_r = ref_scen.pad_scenario(sc_r, r_pad)
    sc_p = scenarios.pad_scenario(sc_p, r_pad)
    params_r = ref_batched.params_from_config(RefSimConfig(), r_pad,
                                              sc_r.capacity_scale)
    params_p = batched.params_from_config(SimConfig(), r_pad,
                                          sc_p.capacity_scale, device="cpu")
    rng = np.random.default_rng(0)
    w = torch.tensor(rng.uniform(0.1, 1.0, (r_pad, 3)).astype(np.float32))
    arr, haz = (torch.tensor(x) for x in (sc_p.arrival_rate,
                                          sc_p.hazard_scale))
    st = batched.init_fluid_state(params_p)
    for i in range(t):
        st, _ = batched.fluid_window_step(
            params_p, st, w, arr[i], haz[i],
            env_uniforms(jax.random.key(i), (r_pad, 3)), i)
    key = jax.random.key(99)
    u_fire, u_dur = (torch.cat([u, torch.ones(r_pad - r_true, 3)])
                     for u in env_uniforms(key, (r_true, 3)))
    st_r = ref_batched.FluidState(**{k: jnp.asarray(v.numpy())
                                     for k, v in st._asdict().items()})
    for row0 in (0, 2):
        sl = slice(row0, row0 + 2)
        got = batched.fluid_window_step(
            params_p, batched.FluidState(*(x[sl] for x in st)), w[sl],
            arr[t], haz[t], (u_fire[sl], u_dur[sl]), t,
            row_block=(row0, r_true, r_pad))
        want = ref_batched.fluid_window_step(
            params_r, jax.tree_util.tree_map(lambda a: a[sl], st_r),
            jnp.asarray(w[sl].numpy()), jnp.asarray(sc_r.arrival_rate[t]),
            jnp.asarray(sc_r.hazard_scale[t]), key, t,
            row_block=(row0, r_true, r_pad))
        assert_tree_close(got[0], want[0], path=f"block {row0} state")
        assert_tree_close(got[1], want[1], path=f"block {row0} info")
    whole = batched.fluid_window_step(params_p, st, w, arr[t], haz[t],
                                      (u_fire, u_dur), t,
                                      row_block=(0, r_pad, r_pad))
    plain = batched.fluid_window_step(params_p, st, w, arr[t], haz[t],
                                      (u_fire, u_dur), t)
    for a, b in zip(whole, plain):
        for x, y in zip(a, b):
            assert (x is None and y is None) or torch.equal(x, y)
