"""The fault layer on the port: the five chaos presets, the fluid env
under fault schedules, the numerical watchdog and chaos runs with recovery
metrics (mirrors ``tests/test_chaos.py`` without its sharded row; the
resume and checkpointer rows are in ``tests/test_torch_checkpoint.py``).

Schedules must equal the reference's to the bit (host numpy on both
sides).  The env and whole chaos runs are held to the reference on the
same draws (``JaxChainNoise``, R1 PRNG mode): actions equal, floats within
the parity bar.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.core import agent as ref_agent
from repro.core import belief as ref_belief
from repro.core import generative as ref_gen
from repro.core.topology import PolicySpec as RefPolicySpec
from repro.core.topology import Topology as RefTopology
from repro.core.topology import default_topology as ref_default
from repro.envsim import batched as ref_batched
from repro.envsim import chaos as ref_chaos
from repro.envsim import scenarios as ref_scen
from repro.envsim.config import SimConfig as RefSimConfig
from repro_torch import api
from repro_torch.api import engine
from repro_torch.core import agent, belief, generative
from repro_torch.core import mega as mega_mod
from repro_torch.envsim import SimConfig, batched, chaos, scenarios
from repro_torch.noise import GeneratorNoise
from torch_port_ref import (JaxChainNoise, assert_close, assert_tree_close,
                            env_uniforms, port_topo, t2n, to_numpy)

R, T = 4, 40
PRESETS = sorted(chaos.CHAOS_PRESETS)


@pytest.fixture(autouse=True)
def _r1_prng_mode():
    with jax.threefry_partitionable(False):
        yield


# ------------------------------------------------------------ chaos schedules
def test_chaos_presets_registered():
    assert set(chaos.CHAOS_PRESETS) == set(ref_chaos.CHAOS_PRESETS)
    assert chaos.CHAOS_INFO == {k: tuple(v) for k, v in
                                ref_chaos.CHAOS_INFO.items()}
    for name in chaos.CHAOS_PRESETS:
        assert name in scenarios.SCENARIOS
        assert name not in scenarios.WAITING


@pytest.mark.parametrize("name", PRESETS)
@pytest.mark.parametrize("r,t,seed", [(5, 40, 3), (16, 300, 0)],
                         ids=["R5-T40", "R16-T300"])
def test_chaos_schedules_equal_reference(name, r, t, seed):
    got = scenarios.build_scenario(name, SimConfig(), r, t, seed=seed)
    want = ref_scen.build_scenario(name, RefSimConfig(), r, t, seed=seed)
    for field in ref_scen.ScenarioBatch._fields:
        a, b = getattr(got, field), getattr(want, field)
        if b is None or isinstance(b, bool):
            assert a == b, field
        else:
            assert a.dtype == b.dtype, field
            np.testing.assert_array_equal(a, b, err_msg=field)


def test_zone_outage_schedule_confined_to_fault_window():
    sc = scenarios.build_scenario("zone-outage", SimConfig(), R, T, seed=0)
    fd = np.asarray(sc.forced_down)
    assert fd.shape == (T, R, 3)
    lo, hi = int(0.3 * T), int(0.5 * T)
    assert fd[lo:hi].max() == 1.0
    assert fd[:lo].max() == 0.0 and fd[hi:].max() == 0.0
    assert fd[:, R // 2:].max() == 0.0     # zone 0 of 2 only


def test_straggler_storm_slows_but_never_stops():
    sc = scenarios.build_scenario("straggler-storm", SimConfig(), R, T,
                                  seed=0)
    sp = np.asarray(sc.speed)
    assert 0.0 < sp.min() < 1.0 and sp.max() <= 1.0
    assert sc.forced_down is None


def test_clean_scenario_has_no_chaos_tensors():
    sc = scenarios.build_scenario("paper-burst", SimConfig(), R, T, seed=0)
    assert sc.forced_down is None and sc.speed is None


# ------------------------------------------------- the env under fault schedules
def _blackout_outage(scen, faults, cfg, r, t):
    """A zone outage whose down pods also publish nothing (``scen`` /
    ``faults``: either package's scenario and chaos modules)."""
    return scen.compile_scenario(
        scen.compose(scen.paper_bursts(cfg, t, r, 1.0),
                     faults.zone_outage(t, r, 1.0, start_s=t * 0.3,
                                        duration_s=t * 0.2),
                     scen.scrape_blackout()), cfg, r, t)


@pytest.mark.parametrize("name", PRESETS + ["zone-outage+blackout"])
def test_fluid_window_step_under_faults_matches_reference(name):
    """Window by window from the reference's carried state, under the
    uniform split, so each window starts from the same values."""
    r, t = 4, 40
    if name == "zone-outage+blackout":
        sc_r = _blackout_outage(ref_scen, ref_chaos, RefSimConfig(), r, t)
        sc_p = _blackout_outage(scenarios, chaos, SimConfig(), r, t)
    else:
        sc_r = ref_scen.build_scenario(name, RefSimConfig(), r, t, seed=1)
        sc_p = scenarios.build_scenario(name, SimConfig(), r, t, seed=1)
    params_r = ref_batched.params_from_config(RefSimConfig(), r,
                                              sc_r.capacity_scale)
    params_p = batched.params_from_config(SimConfig(), r, sc_p.capacity_scale,
                                          device="cpu")
    # the policy that leans on the light tier, which the faults hit
    w = np.tile(np.asarray([0.6, 0.3, 0.1], np.float32), (r, 1))
    st_r = ref_batched.init_fluid_state(params_r)
    key = jax.random.key(5)

    def at(x, i, conv):
        return None if x is None else conv(x[i])

    for i in range(t):
        key, k = jax.random.split(key)
        st_p = batched.fluid_state_from_numpy(to_numpy(st_r), "cpu")
        st_r, info_r = ref_batched.fluid_window_step(
            params_r, st_r, jnp.asarray(w), jnp.asarray(sc_r.arrival_rate[i]),
            jnp.asarray(sc_r.hazard_scale[i]), k, jnp.int32(i),
            obs_valid=at(sc_r.obs_valid, i, jnp.asarray),
            restart_blackout=sc_r.restart_blackout,
            forced_down=at(sc_r.forced_down, i, jnp.asarray),
            speed=at(sc_r.speed, i, jnp.asarray))
        st_p, info_p = batched.fluid_window_step(
            params_p, st_p, torch.tensor(w),
            torch.tensor(sc_p.arrival_rate[i]),
            torch.tensor(sc_p.hazard_scale[i]), env_uniforms(k, (r, 3)), i,
            obs_valid=at(sc_p.obs_valid, i, torch.tensor),
            restart_blackout=sc_p.restart_blackout,
            forced_down=at(sc_p.forced_down, i, torch.tensor),
            speed=at(sc_p.speed, i, torch.tensor))
        assert_tree_close(st_p, st_r, path=f"{name}@{i}")
        assert_tree_close(info_p, info_r, path=f"{name}@{i}.info")


# ------------------------------------------------- chaos runs and recovery
RECOVERY_CASES = [(p, True) for p in PRESETS] + [("zone-outage", False)]


@pytest.mark.parametrize("scenario,fused", RECOVERY_CASES,
                         ids=[f"{s}-{'fused' if f else 'unfused'}"
                              for s, f in RECOVERY_CASES])
def test_chaos_experiment_and_recovery_match_reference(scenario, fused):
    r, t, seed = 3, T, 0
    ref = ref_api.run(ref_api.Experiment(
        router="aif", scenario=scenario, n_cells=r, n_windows=t, seed=seed,
        fused=fused))
    port = api.run(api.Experiment(
        router="aif", scenario=scenario, n_cells=r, n_windows=t, seed=seed,
        fused=fused, device="cpu"), noise=JaxChainNoise(seed, r, t))
    np.testing.assert_array_equal(t2n(port.trace.actions),
                                  np.asarray(ref.trace.actions))
    for field in ("success_pct", "p50_ms", "p95_ms", "restarts"):
        assert_close(getattr(port, field), getattr(ref, field),
                     err_msg=field)
    assert_tree_close(port.trace.env, ref.trace.env)
    rec, rec_ref = port.recovery, ref.recovery
    assert rec.keys() == rec_ref.keys()
    for k, v in rec_ref.items():
        if isinstance(v, float):
            assert np.isfinite(rec[k]), k
            assert_close(rec[k], v, err_msg=k)
        else:
            assert rec[k] == v, k
    assert rec["regret_vs_control"] >= 0.0
    row = port.summary()
    assert set(row["recovery"]) == set(rec_ref)


def test_chaos_run_restarts_generator_noise_for_its_control():
    """With a generator source the control run draws what the chaos run
    drew: its success equals a separate run of the control scenario."""
    e = api.Experiment(scenario="straggler-storm", n_cells=2, n_windows=30,
                       seed=4, device="cpu")
    res = api.run(e, noise=GeneratorNoise(4, "cpu"))
    control = api.run(api.Experiment(scenario="paper-burst", n_cells=2,
                                     n_windows=30, seed=4, device="cpu"))
    assert res.recovery["control_success_pct"] == control.success_pct


def test_mega_with_chaos_raises_a8b():
    """Chaos on the whole-window path, once refused (ROADMAP A8b), runs
    and matches the reference's mega run, its mega control included; only
    the sharded engine (once refused, A10) runs it on two shards of one
    cell each, against the reference's unsharded run."""
    e = api.Experiment(mega=True, scenario="zone-outage", n_cells=2,
                       n_windows=20, device="cpu")
    ref = ref_api.run(ref_api.Experiment(mega=True, scenario="zone-outage",
                                         n_cells=2, n_windows=20))
    port = api.run(e, noise=JaxChainNoise(0, 2, 20))
    np.testing.assert_array_equal(t2n(port.trace.actions),
                                  np.asarray(ref.trace.actions))
    assert isinstance(port.final_carry, mega_mod.MegaFleetState)
    assert_tree_close(port.final_carry, ref.final_carry, path="carry")
    assert_tree_close(port.trace.env, ref.trace.env, path="env")
    for k in ("regret_vs_control", "control_success_pct"):
        assert_close(port.recovery[k], ref.recovery[k], err_msg=k)
    from repro_torch.api import experiment
    cpu = torch.device("cpu")
    two = experiment._run_sharded(e, cpu, api.ShardSpec(),
                                  JaxChainNoise(0, 2, 20), mesh=[cpu] * 2)
    assert two.trace is None and two.cells_per_device == 1
    assert_close(two.success_pct, ref.success_pct, err_msg="success_pct")
    assert_tree_close(two.final_carry, ref.final_carry, path="sharded.carry")


# --------------------------------------------------------- degenerate beliefs
def _small_topo(k: int):
    if k == 3:
        return ref_default()
    names = tuple(f"t{i}" for i in range(k))
    return RefTopology(tier_names=names, tier_classes=names, n_levels=2,
                       util_edges=(0.8,), policy_spec=RefPolicySpec())


@pytest.mark.parametrize("k", [2, 3, 5])
def test_update_belief_all_masked_falls_back_to_prior(k):
    """Every modality masked (and no scrape): the posterior is the
    renormalized one-step prior exactly, on the port and the reference."""
    ref_topo = _small_topo(k)
    topo = port_topo(ref_topo)
    s = agent.init_agent_state(generative.AifConfig(topology=topo), "cpu")
    q0 = torch.zeros_like(s.belief)
    q0[0] = 1.0
    bins = torch.zeros((topo.n_modalities,), dtype=torch.int64)
    mask0 = torch.zeros((topo.n_modalities,))
    q = belief.update_belief(s.model, q0, torch.tensor(0), bins, topo,
                             obs_mask=mask0)
    prior = belief.predict_prior(s.model.b_counts, q0, torch.tensor(0))
    assert torch.equal(q, prior / torch.clamp(prior.sum(), min=1e-30))
    sr = ref_agent.init_agent_state(ref_gen.AifConfig(topology=ref_topo))
    q_ref = ref_belief.update_belief(
        sr.model, jnp.zeros_like(sr.belief).at[0].set(1.0), 0,
        jnp.zeros((topo.n_modalities,), jnp.int32), ref_topo,
        obs_mask=jnp.zeros((topo.n_modalities,), jnp.float32))
    assert_close(q, q_ref)


@pytest.mark.parametrize("k", [2, 3, 5])
def test_update_belief_guard_is_noop_with_evidence(k):
    """An all-ones mask is the same bits as no mask."""
    topo = port_topo(_small_topo(k))
    s = agent.init_agent_state(generative.AifConfig(topology=topo), "cpu")
    bins = torch.ones((topo.n_modalities,), dtype=torch.int64)
    q_none = belief.update_belief(s.model, s.belief, torch.tensor(0), bins,
                                  topo)
    q_ones = belief.update_belief(s.model, s.belief, torch.tensor(0), bins,
                                  topo, obs_mask=torch.ones(topo.n_modalities))
    assert torch.equal(q_none, q_ones)


# ----------------------------------------------------------- watchdog healing
def _world(scenario):
    sc = scenarios.build_scenario(scenario, SimConfig(), R, T)
    params = batched.params_from_config(SimConfig(), R, sc.capacity_scale,
                                        device="cpu")
    return params, batched.make_scenario_env_step(params, sc)


def _copy(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    return type(tree)(*(_copy(x) for x in tree))


def _warm(router, scenario="paper-burst"):
    params, env_step = _world(scenario)
    carry, est, _ = engine.rollout(router, router.init_carry(R, "cpu"),
                                   batched.init_fluid_state(params),
                                   env_step, 10, seed=3)
    return env_step, carry, est


def test_watchdog_quarantines_poisoned_cell_and_spares_neighbors():
    router = api.AifRouter()
    env_step, carry, est = _warm(router)
    poisoned = _copy(carry)
    poisoned.belief[2] = float("nan")
    c_clean, _, tr_clean = engine.rollout(router, _copy(carry), _copy(est),
                                          env_step, 10, seed=7)
    c_bad, _, tr_bad = engine.rollout(router, poisoned, _copy(est), env_step,
                                      10, seed=7)
    wd = t2n(tr_bad.watchdog)
    assert wd.shape == (10, R)
    assert wd[0, 2] == 1.0 and wd[1:, 2].max() == 0.0
    assert wd[:, [0, 1, 3]].max() == 0.0
    for leaf in c_bad:
        for x in (leaf if isinstance(leaf, tuple) else (leaf,)):
            if x.dtype.is_floating_point:
                assert bool(torch.isfinite(x).all())
    for name in ("belief", "error_ema", "prev_action"):
        a, b = t2n(getattr(c_bad, name)), t2n(getattr(c_clean, name))
        np.testing.assert_array_equal(a[[0, 1, 3]], b[[0, 1, 3]])
    assert t2n(tr_clean.watchdog).max() == 0.0


def test_watchdog_off_lets_nan_propagate():
    env_step, carry, est = _warm(api.AifRouter())
    off = api.AifRouter(cfg=generative.AifConfig(watchdog=False))
    poisoned = _copy(carry)
    poisoned.belief[2] = float("nan")
    c_bad, _, tr = engine.rollout(off, poisoned, _copy(est), env_step, 10,
                                  seed=7)
    assert tr.watchdog is None
    assert not bool(torch.isfinite(c_bad.belief[2]).all())


def test_watchdog_identity_branch_is_bit_exact():
    params, env_step = _world("paper-burst")
    runs = []
    for wd in (True, False):
        router = api.AifRouter(cfg=generative.AifConfig(watchdog=wd))
        runs.append(engine.rollout(router, router.init_carry(R, "cpu"),
                                   batched.init_fluid_state(params),
                                   env_step, 20, seed=0))
    (c_on, e_on, t_on), (c_off, e_off, t_off) = runs
    assert torch.equal(c_on.belief, c_off.belief)
    assert torch.equal(c_on.model.b_counts, c_off.model.b_counts)
    assert torch.equal(e_on.n_success, e_off.n_success)
    assert torch.equal(t_on.actions, t_off.actions)


def test_mega_watchdog_quarantine_unit():
    cfg = generative.AifConfig()
    state = mega_mod.init_mega_state(cfg, R, T, device="cpu")
    state.belief[1] = float("nan")
    bad = mega_mod.mega_watchdog_bad(state)
    np.testing.assert_array_equal(t2n(bad), [False, True, False, False])
    t_before = state.t.clone()
    healed = mega_mod.mega_quarantine(state, bad, cfg)
    b = t2n(healed.belief)
    assert np.isfinite(b).all()
    np.testing.assert_allclose(b[1].sum(), 1.0, rtol=1e-6)
    np.testing.assert_array_equal(b[0], b[2])
    assert torch.equal(healed.t, t_before)
