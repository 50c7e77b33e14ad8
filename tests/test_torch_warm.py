"""Warm promotion onto the mega path on the port (mirrors
``tests/test_mega.py::test_warm_promotion_*``).

A dense per-tick fleet carry promoted with ``init_mega_state(
from_agent_state=...)`` keeps its learned transition counts as the cache's
``b_base`` baseline.  The port's promoted state, its factored prior and EFE
with a baseline, one warm window and the densified carry are held against
the reference's oracle on the same carries; the promoted run takes the
per-tick continuation's action on every tick (both draw from the
reference's key chain, ``JaxChainNoise``, in the R1 PRNG mode); a
checkpointed warm run resumes to the bit.  The reference's ``use_pallas``
refusal has no counterpart (the port runs the warm window on kernel B3's
warm branch on the card); its boundary and clock errors stay.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import engine as ref_engine
from repro.api import experiment as ref_experiment
from repro.core import mega as ref_mega
from repro.core import topology as ref_topology
from repro.envsim import SimConfig as RefSimConfig
from repro.envsim import batched as ref_batched
from repro.envsim import scenarios as ref_scen
from repro_torch import api
from repro_torch.api import engine
from repro_torch.api import experiment
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import generative, mega
from repro_torch.core.topology import default_topology
from repro_torch.envsim import SimConfig, batched, scenarios
from repro_torch.kernels.efe import ops
from torch_port_ref import (JaxChainNoise, agent_state_to_port,
                            assert_bits_equal, assert_close,
                            assert_tree_close, clone_tree, env_uniforms,
                            mega_state_to_port, mega_state_to_ref,
                            port_to_numpy, t2n)

T1, T2 = 20, 20


@pytest.fixture(autouse=True)
def _r1_prng_mode():
    with jax.threefry_partitionable(False):
        yield


def _port_world(r, t, scenario="paper-burst"):
    scfg = SimConfig()
    sc = scenarios.build_scenario(scenario, scfg, r, t)
    params = batched.params_from_config(scfg, r, sc.capacity_scale,
                                        device="cpu")
    env_step = batched.make_scenario_env_step(params, sc)
    topo = default_topology()
    return (params, env_step,
            experiment._make_aif(topo, scfg, True, False),
            experiment._make_aif(topo, scfg, True, True))


def _ref_world(r, t, scenario="paper-burst"):
    scfg = RefSimConfig()
    sc = ref_scen.build_scenario(scenario, scfg, r, t)
    params = ref_batched.params_from_config(scfg, r, sc.capacity_scale)
    env_step = ref_batched.make_scenario_env_step(params, sc)
    topo = ref_topology.default_topology()
    return (params, env_step,
            ref_experiment._make_aif(topo, scfg, True, False, False),
            ref_experiment._make_aif(topo, scfg, True, False, True))


@functools.lru_cache(maxsize=None)
def _ref_dense(r, t1, horizon, scenario="paper-burst"):
    """The reference's per-tick rollout stopped at tick ``t1`` of a
    ``horizon``-tick world: (carry, env state, snapshot) as numpy."""
    params, env_step, pt, _ = _ref_world(r, horizon, scenario)
    carry, est, _, snap = ref_engine.resumable_rollout(
        pt, pt.init_carry(r), ref_batched.init_fluid_state(params), env_step,
        t1, jax.random.key(0))
    return (jax.tree_util.tree_map(np.asarray, carry),
            jax.tree_util.tree_map(np.asarray, est),
            tuple(np.asarray(x) for x in snap[:5]))


def _dense_both(r, t1, horizon, scenario="paper-burst"):
    """Fresh (port, reference) copies of :func:`_ref_dense`'s carry, env
    state and telemetry carry."""
    carry, est, obs = _ref_dense(r, t1, horizon, scenario)
    _, _, pt, _ = _port_world(r, horizon, scenario)
    port = (agent_state_to_port(carry, pt.cfg),
            batched.fluid_state_from_numpy(est._asdict(), "cpu"),
            tuple(torch.tensor(x) for x in obs))
    ref = (jax.tree_util.tree_map(jnp.asarray, carry),
           jax.tree_util.tree_map(jnp.asarray, est),
           tuple(jnp.asarray(x) for x in obs))
    return port, ref


@functools.lru_cache(maxsize=None)
def _warm_midrun(r=4, t1=T1, t_more=T2, horizon=T1 + T2 + 10):
    """The port's promoted mega run after ``t_more`` more ticks (two slow
    boundaries, so the slot terms carry weight beside the baseline), as a
    numpy snapshot: (state, env state, obs carry)."""
    (carry, est, obs), _ = _dense_both(r, t1, horizon)
    _, env_step, _, mg = _port_world(r, horizon)
    state, est, _, obs = engine.mega_rollout(
        mg, est, env_step, t_more, JaxChainNoise(0, r, horizon),
        carry=carry, obs_carry=obs, n_total=horizon - t1)
    return port_to_numpy(state), port_to_numpy(est), tuple(t2n(x)
                                                          for x in obs)


def _warm_both(cfg):
    state, est, obs = _warm_midrun()
    return ((mega_state_to_port(state, cfg),
             batched.fluid_state_from_numpy(est, "cpu"),
             tuple(torch.tensor(x) for x in obs)),
            (mega_state_to_ref(state),
             ref_batched.FluidState(**{k: jnp.asarray(v)
                                       for k, v in est.items()}),
             tuple(jnp.asarray(x) for x in obs)))


# ------------------------------------------------------------- promotion
def test_warm_promotion_roundtrip():
    """``init_mega_state(from_agent_state=to_agent_state(s))`` is an exact
    round trip, and promoting the reference's dense carry gives the
    reference's promoted state."""
    r, t = 4, 20
    cfg = generative.AifConfig()
    state = api.run(api.Experiment(router="aif", mega=True, n_cells=r,
                                   n_windows=t, device="cpu")).final_carry
    dense = mega.to_agent_state(state, cfg)
    back = mega.init_mega_state(cfg, r, t, device="cpu",
                                from_agent_state=dense)
    assert torch.equal(dense.model.b_counts, back.cache.b_base)
    for f in ("a_counts", "belief", "prev_action", "dt_since_change",
              "error_ema", "unstable", "t"):
        assert torch.equal(getattr(state, f), getattr(back, f)), f
    for f in ("q_prev", "q_next", "obs_bins", "obs_mask", "action",
              "dt_since_change"):
        assert torch.equal(getattr(state.slots, f),
                           getattr(back.slots, f)), f"slots.{f}"
    # colsum rebuilds as the baseline's column sum: equal up to rounding
    np.testing.assert_allclose(t2n(state.cache.colsum),
                               t2n(back.cache.colsum), rtol=1e-5, atol=1e-5)
    assert_bits_equal(dense, mega.to_agent_state(back, cfg))
    # the promotion copies: the source carry stays untouched
    assert back.cache.b_base.data_ptr() != dense.model.b_counts.data_ptr()

    (p_dense, _, _), (r_dense, _, _) = _dense_both(3, T1, 50)
    _, _, _, mg = _ref_world(3, 50)
    want = ref_mega.init_mega_state(mg.cfg, 3, 50, from_agent_state=r_dense)
    got = mega.init_mega_state(generative.AifConfig(), 3, 50, device="cpu",
                               from_agent_state=p_dense)
    assert_tree_close(got, want, path="promoted")
    assert_close(got.cache.b_base, want.cache.b_base, rtol=0, atol=0)


def test_warm_factored_prior_and_efe_match_reference():
    """The b_base branches of the factored prior and EFE on a promoted
    state whose slots carry weight, against the reference's oracle."""
    cfg = generative.AifConfig()
    (state, _, _), (st_r, _, _) = _warm_both(cfg)
    _, _, _, mg = _ref_world(4, 50)
    assert state.cache.b_base is not None
    assert float(state.cache.coefact.abs().sum()) > 0.0
    rng = np.random.default_rng(1)
    r, s = state.belief.shape
    q = rng.dirichlet(np.ones(s), r).astype(np.float32)
    logc = rng.normal(0.0, 2.0, state.cache.logna.shape[:3]).astype(
        np.float32)
    cost = rng.normal(0.0, 0.1, cfg.n_actions).astype(np.float32)
    mask = rng.integers(0, 2, (r, state.a_counts.shape[1])).astype(np.float32)
    prior_r = jax.jit(functools.partial(ref_mega.factored_prior,
                                        cfg=mg.cfg))(
        st_r.cache, st_r.slots, jnp.asarray(q), st_r.prev_action)
    assert_close(mega.factored_prior(state.cache, state.slots,
                                     torch.tensor(q), state.prev_action,
                                     cfg), prior_r)
    efe_r = jax.jit(functools.partial(ref_mega.factored_efe, cfg=mg.cfg))
    for m in (None, mask):
        want = efe_r(st_r.cache, st_r.slots, jnp.asarray(q),
                     jnp.asarray(logc), jnp.asarray(cost),
                     obs_mask=None if m is None else jnp.asarray(m))
        got = mega.factored_efe(state.cache, state.slots, torch.tensor(q),
                                torch.tensor(logc), torch.tensor(cost), cfg,
                                obs_mask=None if m is None
                                else torch.tensor(m))
        assert_close(got, want)


def test_warm_window_slow_step_and_densify_match_reference():
    """One warm window (the plain version of B3's warm branch) against the
    reference's oracle on the same carries and draws; then the slow step
    and the densified carry; then the watchdog's quarantine of a warm
    cell."""
    cfg = generative.AifConfig()
    (state, est, obs), (st_r, est_r, obs_r) = _warm_both(cfg)
    params_r, env_r, _, mg = _ref_world(4, 50)
    params_p, env_p, _, mg_p = _port_world(4, 50)
    t0, w, r = int(state.t[0]), 10, 4
    assert t0 == T1 + T2
    fl, p_fl = env_r.fluid, env_p.fluid
    k_env = jax.random.split(jax.random.key(11), w)
    gum = jax.random.gumbel(jax.random.key(12), (w, r, mg.cfg.n_actions))
    sl = slice(t0, t0 + w)
    statics = dict(cfg=mg.cfg, disc=mg.resolved_disc,
                   util_edges=mg.resolved_util_edges,
                   util_period=mg.util_period, dt=fl.dt,
                   scrape_every=fl.scrape_every,
                   restart_blackout=fl.restart_blackout, emits_mask=False)
    want = jax.jit(functools.partial(ref_mega.mega_window, **statics))(
        st_r, est_r, obs_r, params_r, fl.arrival_rate[sl],
        fl.hazard_scale[sl], None, k_env, gum, t0)
    uniforms = torch.stack([torch.stack(env_uniforms(k, (r, 3)))
                            for k in k_env])
    got = ops.mega_window(
        state, est, obs, p_fl.params, p_fl.arrival_rate[sl],
        p_fl.hazard_scale[sl], None, uniforms, torch.tensor(np.asarray(gum)),
        t0, cfg=cfg, disc=mg_p.resolved_disc,
        util_edges=mg_p.resolved_util_edges, util_period=mg_p.util_period,
        dt=p_fl.dt, scrape_every=p_fl.scrape_every, restart_blackout=False,
        emits_mask=False)
    np.testing.assert_array_equal(t2n(got[3][0]), np.asarray(want[3][0]))
    assert_tree_close(got[0], want[0], path="warm.state")
    assert_tree_close(got[1], want[1], path="warm.est")
    assert_tree_close(got[3][5], want[3][5], path="warm.win")

    ks = jax.random.split(jax.random.key(9), r)
    size = jnp.minimum(want[0].t, want[0].slots.action.shape[1])
    idx = jax.vmap(lambda k, n: jax.random.randint(
        k, (cfg.replay_batch,), 0, jnp.maximum(n, 1)))(ks, size)
    idx = torch.tensor(np.asarray(idx), dtype=torch.int64)
    slow_r = ref_mega.mega_slow_step(want[0], ks, mg.cfg)
    slow_p = mega.mega_slow_step(got[0], idx, cfg)
    assert_tree_close(slow_p, slow_r, path="warm.slow")
    full = mega.mega_slow_step(got[0], idx, cfg, incremental=False)
    assert full.cache.b_base is slow_p.cache.b_base
    np.testing.assert_allclose(t2n(full.cache.colsum),
                               t2n(slow_p.cache.colsum), rtol=1e-5,
                               atol=1e-5)
    assert_tree_close(mega.to_agent_state(slow_p, cfg),
                      ref_mega.to_agent_state(slow_r, mg.cfg),
                      path="warm.dense")

    bad = torch.tensor([False, True, False, False])
    fixed_r = ref_mega.mega_quarantine(slow_r, jnp.asarray(t2n(bad)), mg.cfg)
    fixed_p = mega.mega_quarantine(clone_tree(slow_p), bad, cfg)
    assert_tree_close(fixed_p, fixed_r, path="warm.quarantined")
    assert torch.equal(fixed_p.cache.b_base[0], slow_p.cache.b_base[0])


# ------------------------------------------------------------ continuation
def test_warm_promotion_continues_per_tick_run():
    """A warm per-tick carry promoted onto the mega path routes like the
    per-tick engine continued from the same snapshot (same world, same
    draws, same telemetry carry), and like the reference's promoted run."""
    r = 5
    params, env_step, pt, mg = _port_world(r, T1 + T2)
    noise = JaxChainNoise(0, r, T1 + T2)
    c_a, e_a, _, snap = engine.resumable_rollout(
        pt, pt.init_carry(r, "cpu"), batched.init_fluid_state(params),
        env_step, T1, noise)
    c_copy, e_copy = clone_tree(c_a), clone_tree(e_a)
    _, e_b, tr_b, _ = engine.resumable_rollout(
        pt, c_a, e_a, env_step, T2, noise, t_begin=T1, snapshot=snap)
    state, e_m, tr_m, _ = engine.mega_rollout(
        mg, e_copy, env_step, T2, noise, carry=c_copy, obs_carry=snap[0])
    assert torch.equal(tr_b.actions, tr_m.actions)
    assert state.t.unique().tolist() == [T1 + T2]
    assert state.cache.b_base is not None
    for f in e_b._fields:
        np.testing.assert_allclose(t2n(getattr(e_b, f)),
                                   t2n(getattr(e_m, f)), atol=1e-4,
                                   err_msg=f"env.{f}")

    params_r, env_r, pt_r, mg_r = _ref_world(r, T1 + T2)
    key = jax.random.key(0)
    c_r, e_r, _, snap_r = ref_engine.resumable_rollout(
        pt_r, pt_r.init_carry(r), ref_batched.init_fluid_state(params_r),
        env_r, T1, key)
    st_r, e_mr, tr_mr, _ = ref_engine._mega_rollout(
        mg_r, c_r, e_r, env_r, T2, snap_r[5], obs_masked=None, t0=None,
        obs_carry=snap_r[:5])
    np.testing.assert_array_equal(t2n(tr_m.actions),
                                  np.asarray(tr_mr.actions))
    assert_tree_close(e_m, e_mr, path="env")
    assert_tree_close(state, st_r, path="promoted")


def test_warm_promotion_rejects_off_boundary_and_clock():
    r = 3
    cfg = generative.AifConfig()
    params, env_step, pt, mg = _port_world(r, 40)
    dense = pt.init_carry(r, "cpu")
    # mixed-phase fleet clocks cannot share the slot==tick invariant
    mixed = dense._replace(t=torch.tensor([7, 8, 7]))
    with pytest.raises(ValueError, match="uniform fleet clock"):
        mega.init_mega_state(cfg, r, 20, device="cpu",
                             from_agent_state=mixed)
    with pytest.raises(ValueError, match="uniform fleet clock"):
        api.rollout(mg, mixed, batched.init_fluid_state(params), env_step,
                    10)
    est = batched.init_fluid_state(params)
    # a promotion starts on a slow-period and dwell boundary
    with pytest.raises(ValueError, match="boundary"):
        api.rollout(mg, dense._replace(t=torch.full((r,), 7)), est,
                    env_step, 10)
    warm = dense._replace(t=torch.full((r,), 20))
    with pytest.raises(ValueError, match="t_begin"):
        engine.mega_rollout(mg, est, env_step, 10, carry=warm, t_begin=10)
    with pytest.raises(ValueError, match="scheduled ticks"):
        api.rollout(mg, warm, est, env_step, 30)
    with pytest.raises(ValueError, match="n_slots"):
        mega.init_mega_state(cfg, r, 10, device="cpu", from_agent_state=warm)
    # a warm factored state cannot seed a new horizon; its densified carry can
    state, _, _ = api.rollout(mg, warm, est, env_step, 10)
    assert state.t.unique().tolist() == [30]
    with pytest.raises(ValueError, match="to_agent_state"):
        api.rollout(mg, state, est, env_step, 10)
    again, _, _ = api.rollout(mg, mega.to_agent_state(state, cfg), est,
                              env_step, 10)
    assert again.t.unique().tolist() == [40]


def test_warm_mega_checkpoint_resumes_to_the_bit(tmp_path):
    """A promoted run cut at a slow boundary, its carries written to a
    checkpoint and restored, ends where the uninterrupted promoted run
    ends, to the bit."""
    r = 4
    params, env_step, pt, mg = _port_world(r, 60)
    dense, est, _, _ = engine.resumable_rollout(
        pt, pt.init_carry(r, "cpu"), batched.init_fluid_state(params),
        env_step, T1, seed=5)
    s_u, e_u, tr_u = api.rollout(mg, clone_tree(dense), clone_tree(est),
                                 env_step, 30, seed=42)
    s1, e1, tr1, snap = engine.resumable_rollout(
        mg, clone_tree(dense), clone_tree(est), env_step, 10, seed=42,
        n_total=30)
    assert s1.t.unique().tolist() == [T1 + 10]
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(T1 + 10, {"carry": s1, "env": e1, "obs": snap[0],
                      "noise": snap[1]})
    ck.wait()
    tree, _ = ck.restore({"carry": s1, "env": e1, "obs": snap[0],
                          "noise": snap[1]})
    assert tree["carry"].cache.b_base is not None
    s2, e2, tr2, _ = engine.resumable_rollout(
        mg, tree["carry"], tree["env"], env_step, 20, seed=42,
        t_begin=T1 + 10, snapshot=(tree["obs"], tree["noise"]))
    assert_bits_equal(s_u, s2)
    assert_bits_equal(e_u, e2)
    assert_bits_equal(tr_u, experiment._cat([tr1, tr2]))
