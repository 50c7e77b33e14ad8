"""Port parity of the mega path's modules, from mid-run states.

The port's mega rollout runs on the CPU past two or more slow boundaries
(so the slot terms of the prior and the EFE are non-zero; the rollout
itself is held against the reference by ``tests/test_torch_mega.py``), and
its factored state is carried to both sides.  Then:

* one window of the port (``ops.mega_window`` on CPU tensors: the plain
  version of kernel B3) against the reference's XLA oracle window and its
  Pallas megakernel ``mega_window_pallas`` in interpret mode, on the same
  Gumbel noise and restart uniforms; under each chaos preset's fault
  schedules and on each graph preset's world (M=5, every ``spill_*``
  field and the neighbor pressure) against the oracle alone, which is
  what the reference's own dispatch runs for such windows;
* the slow step (streaming and full refresh) on the same replay draws;
* the densified per-tick carry (``to_agent_state``);
* the window-granularity watchdog and quarantine.

The CUDA kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import experiment as ref_experiment
from repro.core import graph as ref_graph
from repro.core import mega as ref_mega
from repro.core import topology as ref_topology
from repro.envsim import batched as ref_batched
from repro.kernels.efe.mega import mega_window_pallas
from repro_torch import api
from repro_torch.api import engine
from repro_torch.api import experiment as port_experiment
from repro_torch.core import generative, mega
from repro_torch.envsim import batched
from repro_torch.kernels.efe import mega as mega_kernel
from repro_torch.kernels.efe import ops
from repro_torch.noise import GeneratorNoise
from torch_port_ref import (assert_bits_equal, assert_close,
                            assert_tree_close, env_uniforms,
                            mega_state_to_port, mega_state_to_ref,
                            port_to_numpy, port_topo, t2n)

TWO_TIER = ref_topology.Topology(tier_names=("edge", "cloud"),
                                 tier_classes=("edge-medium", "server"))
TOPOS = {"k3": ref_topology.default_topology(), "k2": TWO_TIER,
         "k5": ref_topology.five_tier_topology()}
SLOT_TYPES = {"float32": (torch.float32, jnp.float32),
              "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _port_world(scenario, r, horizon, topo_key, slot="float32", g=None):
    """(router, env_step) of the port; ``g`` a graph preset name (the
    graph scenarios' default when None, as in ``Experiment``)."""
    topo = port_topo(TOPOS[topo_key])
    e = api.Experiment(scenario=scenario, topology=topo, n_cells=r,
                       n_windows=horizon, mega=True, mega_slot_dtype=slot,
                       device="cpu", graph=g)
    fg = e.resolve_graph()
    scfg, _, env_step = port_experiment._build_world(
        topo, scenario, r, horizon, 1.0, 0, torch.device("cpu"), fg)
    return e.resolve_router(scfg, fg), env_step


def _ref_world(scenario, r, horizon, topo_key, slot="float32", g=None):
    topo = TOPOS[topo_key]
    fg = ref_graph.resolve_graph(g, r, scenario=scenario)
    scfg, params, env_step = ref_experiment._build_world(
        topo, scenario, r, horizon, 1.0, 0, graph=fg)
    router = ref_experiment._make_aif(topo, scfg, True, False, True, slot,
                                      graph=fg)
    return router, params, env_step


@functools.lru_cache(maxsize=None)
def _midrun(scenario, r, t_pre, horizon, topo_key, slot="float32", g=None):
    """The port's mega rollout stopped at tick ``t_pre`` (slots sized for
    ``horizon``), as numpy snapshots: (state, env state, obs carry)."""
    router, env_step = _port_world(scenario, r, horizon, topo_key, slot, g)
    est0 = batched.init_fluid_state(env_step.fluid.params,
                                    env_step.n_obs_modalities)
    state, est, _, obs = engine.mega_rollout(
        router, est0, env_step, t_pre, GeneratorNoise(3, "cpu"),
        n_total=horizon)
    return port_to_numpy(state), port_to_numpy(est), tuple(t2n(x)
                                                          for x in obs)


def _both_sides(snap, p_cfg, slot="float32"):
    """Fresh (port, reference) copies of a :func:`_midrun` snapshot."""
    state, est, obs = snap
    p_dtype, r_dtype = SLOT_TYPES[slot]
    port = (mega_state_to_port(state, p_cfg, p_dtype),
            batched.fluid_state_from_numpy(est, "cpu"),
            tuple(torch.tensor(x) for x in obs))
    ref = (mega_state_to_ref(state, r_dtype),
           ref_batched.FluidState(**{k: jnp.asarray(v)
                                     for k, v in est.items()}),
           tuple(jnp.asarray(x) for x in obs))
    return port, ref


# (scenario, R, t0, topology, slot type, against Pallas too): the Pallas
# interpret run takes ~20 s a case, so it covers float32 and bf16 slots on
# the paper's topology; the oracle covers every case
WINDOW_CASES = [("paper-burst", 3, 30, "k3", "float32", True),
                ("flaky-telemetry", 3, 20, "k3", "float32", False),
                ("scrape-blackout", 2, 20, "k3", "float32", False),
                ("paper-burst", 2, 20, "k5", "float32", False),
                ("paper-burst", 2, 20, "k3", "bfloat16", True)]


@pytest.mark.parametrize("scenario,r,t0,topo_key,slot,pallas", WINDOW_CASES,
                         ids=["clean", "masked", "blackout", "k5", "bf16"])
def test_window_matches_oracle_and_pallas_kernel(scenario, r, t0, topo_key,
                                                 slot, pallas):
    horizon, w = t0 + 20, 10
    p_router, p_env = _port_world(scenario, r, horizon, topo_key, slot)
    router, params, env_step = _ref_world(scenario, r, horizon, topo_key,
                                          slot)
    (p_state, p_est, p_obs), (st_r, est_r, obs_r) = _both_sides(
        _midrun(scenario, r, t0, horizon, topo_key, slot), p_router.cfg,
        slot)
    assert int(p_state.t[0]) == t0
    assert float(p_state.cache.coefact.abs().sum()) > 0.0
    cfg, fl, p_fl = router.cfg, env_step.fluid, p_env.fluid
    k_env = jax.random.split(jax.random.key(11), w)
    gum = jax.random.gumbel(jax.random.key(12), (w, r, cfg.n_actions))
    sl = slice(t0, t0 + w)
    statics = dict(cfg=cfg, disc=router.resolved_disc,
                   util_edges=router.resolved_util_edges,
                   util_period=router.util_period, dt=fl.dt,
                   scrape_every=fl.scrape_every,
                   restart_blackout=fl.restart_blackout,
                   emits_mask=bool(env_step.emits_mask))
    args = (st_r, est_r, obs_r, params, fl.arrival_rate[sl],
            fl.hazard_scale[sl],
            None if fl.obs_valid is None else fl.obs_valid[sl], k_env, gum,
            t0)
    refs = {"oracle": ref_mega.mega_window(*args, **statics)}
    if pallas:
        refs["pallas"] = mega_window_pallas(*args, **statics, interpret=True)

    uniforms = torch.stack([torch.stack(env_uniforms(k, (r, p_fl.params
                                                         .n_tiers)))
                            for k in k_env])
    port = ops.mega_window(
        p_state, p_est, p_obs, p_fl.params, p_fl.arrival_rate[sl],
        p_fl.hazard_scale[sl],
        None if p_fl.obs_valid is None else p_fl.obs_valid[sl], uniforms,
        torch.tensor(np.asarray(gum)), t0, cfg=p_router.cfg,
        disc=p_router.resolved_disc,
        util_edges=p_router.resolved_util_edges,
        util_period=p_router.util_period, dt=p_fl.dt,
        scrape_every=p_fl.scrape_every,
        restart_blackout=p_fl.restart_blackout,
        emits_mask=bool(p_env.emits_mask))
    for name, (ref_state, ref_est, ref_obs, ref_ys) in refs.items():
        np.testing.assert_array_equal(t2n(port[3][0]), np.asarray(ref_ys[0]),
                                      err_msg=name)
        assert_tree_close(port[0], ref_state, path=f"{name}.state")
        assert_tree_close(port[1], ref_est, path=f"{name}.est")
        for i, (a, b) in enumerate(zip(port[2], ref_obs)):
            assert_close(a, b, err_msg=f"{name}.obs[{i}]")
        for i, (a, b) in enumerate(zip(port[3][1:5], ref_ys[1:5])):
            assert_close(a.to(torch.float32), np.asarray(b, np.float32),
                         err_msg=f"{name}.trace[{i + 1}]")
        assert_tree_close(port[3][5], ref_ys[5], path=f"{name}.win")


# (scenario, R, t0, horizon, graph preset): every chaos preset with its
# faults live in the window [t0, t0 + 10) (zone-outage's at ticks 15-24 of
# 50), the three graph presets, graph + chaos with bf16 slots
FAULT_GRAPH_CASES = [
    ("zone-outage", 3, 20, 50, None, "float32"),
    ("long-outage", 3, 20, 50, None, "float32"),
    ("mttf-mttr", 3, 20, 50, None, "float32"),
    ("straggler-storm", 3, 20, 50, None, "float32"),
    ("capacity-flap", 3, 20, 50, None, "float32"),
    ("ring-spillover", 6, 20, 40, None, "float32"),
    ("grid-hotspot", 6, 20, 40, None, "float32"),
    ("hier-continuum", 9, 20, 40, None, "float32"),
    ("zone-outage", 6, 20, 50, "ring", "bfloat16"),
]


@pytest.mark.parametrize("scenario,r,t0,horizon,g,slot", FAULT_GRAPH_CASES,
                         ids=["zone", "long", "mttf", "straggler", "flap",
                              "ring", "grid", "hier", "ring-zone-bf16"])
def test_fault_and_graph_window_matches_oracle(scenario, r, t0, horizon, g,
                                               slot):
    """One window under fault schedules or on a fleet graph, from a carried
    mid-run state, against the reference's oracle window (the window its
    dispatch runs for such worlds): every action, carry, env field and
    trace leaf, the ``spill_*`` fields and the fifth telemetry column
    included."""
    w = 10
    p_router, p_env = _port_world(scenario, r, horizon, "k3", slot, g)
    router, params, env_step = _ref_world(scenario, r, horizon, "k3", slot, g)
    (p_state, p_est, p_obs), (st_r, est_r, obs_r) = _both_sides(
        _midrun(scenario, r, t0, horizon, "k3", slot, g), p_router.cfg, slot)
    cfg, fl, p_fl = router.cfg, env_step.fluid, p_env.fluid
    sl = slice(t0, t0 + w)
    # the faults are live in the window
    if p_fl.forced_down is not None:
        assert float(p_fl.forced_down[sl].sum()) > 0.0
    if p_fl.speed is not None:
        assert bool((p_fl.speed[sl] < 1.0).any())
    k_env = jax.random.split(jax.random.key(11), w)
    gum = jax.random.gumbel(jax.random.key(12), (w, r, cfg.n_actions))

    def part(x):
        return None if x is None else x[sl]

    ref = ref_mega.mega_window(
        st_r, est_r, obs_r, params, fl.arrival_rate[sl], fl.hazard_scale[sl],
        part(fl.obs_valid), k_env, gum, t0, cfg=cfg,
        disc=router.resolved_disc, util_edges=router.resolved_util_edges,
        util_period=router.util_period, dt=fl.dt,
        scrape_every=fl.scrape_every, restart_blackout=fl.restart_blackout,
        emits_mask=bool(env_step.emits_mask), forced_down=part(fl.forced_down),
        speed=part(fl.speed), graph=fl.graph)
    uniforms = torch.stack([torch.stack(env_uniforms(k, (r, p_fl.params
                                                         .n_tiers)))
                            for k in k_env])
    port = ops.mega_window(
        p_state, p_est, p_obs, p_fl.params, p_fl.arrival_rate[sl],
        p_fl.hazard_scale[sl], part(p_fl.obs_valid), uniforms,
        torch.tensor(np.asarray(gum)), t0, cfg=p_router.cfg,
        disc=p_router.resolved_disc,
        util_edges=p_router.resolved_util_edges,
        util_period=p_router.util_period, dt=p_fl.dt,
        scrape_every=p_fl.scrape_every,
        restart_blackout=p_fl.restart_blackout,
        emits_mask=bool(p_env.emits_mask), forced_down=part(p_fl.forced_down),
        speed=part(p_fl.speed), graph=p_fl.graph)
    ref_state, ref_est, ref_obs, ref_ys = ref
    np.testing.assert_array_equal(t2n(port[3][0]), np.asarray(ref_ys[0]))
    assert_tree_close(port[0], ref_state, path="state")
    assert_tree_close(port[1], ref_est, path="est")
    for i, (a, b) in enumerate(zip(port[2], ref_obs)):
        assert_close(a, b, err_msg=f"obs[{i}]")
    for i, (a, b) in enumerate(zip(port[3][1:5], ref_ys[1:5])):
        assert_close(a.to(torch.float32), np.asarray(b, np.float32),
                     err_msg=f"trace[{i + 1}]")
    assert_tree_close(port[3][5], ref_ys[5], path="win")
    m = 5 if p_fl.graph is not None else 4
    assert port[0].slots.obs_bins.shape[-1] == m
    assert port[0].cache.logna.shape[1] == m
    if p_fl.graph is not None:
        assert float(port[3][5].spill_in.sum()) > 0.0   # spillover is live
        for field in ("spill_out", "spill_in", "spill_admitted",
                      "nbr_pressure"):
            assert getattr(ref_ys[5], field) is not None, field


@pytest.mark.parametrize("scenario,r,t0,horizon,g", [
    ("ring-spillover", 6, 20, 40, None), ("hier-continuum", 9, 20, 40, None),
    ("zone-outage", 6, 20, 50, "ring"), ("straggler-storm", 3, 20, 50, None)],
    ids=["ring", "hier", "ring-zone", "straggler"])
def test_launch_split_model_matches_window(scenario, r, t0, horizon, g):
    """The plain model of B3's launch split (``mega_window_launches``: W + 1
    launches, each publishing the previous tick from the carries and every
    cell's exchange rows, then running its own tick up to the env's flow)
    returns what ``mega_window`` returns, to the bit."""
    router, env_step = _port_world(scenario, r, horizon, "k3", g=g)
    snap = _midrun(scenario, r, t0, horizon, "k3", g=g)
    (s1, e1, o1), _ = _both_sides(snap, router.cfg)
    (s2, e2, o2), _ = _both_sides(snap, router.cfg)
    fl, w = env_step.fluid, 10
    sl = slice(t0, t0 + w)
    gen = torch.Generator().manual_seed(7)
    uniforms = torch.rand((w, 2, r, fl.params.n_tiers), generator=gen)
    gum = -torch.log(-torch.log(torch.rand(
        (w, r, router.cfg.n_actions), generator=gen).clamp(min=1e-30)))

    def part(x):
        return None if x is None else x[sl]

    kw = dict(cfg=router.cfg, disc=router.resolved_disc,
              util_edges=router.resolved_util_edges,
              util_period=router.util_period, dt=fl.dt,
              scrape_every=fl.scrape_every,
              restart_blackout=fl.restart_blackout,
              emits_mask=bool(env_step.emits_mask),
              forced_down=part(fl.forced_down), speed=part(fl.speed),
              graph=fl.graph)
    args = (fl.params, fl.arrival_rate[sl], fl.hazard_scale[sl],
            part(fl.obs_valid), uniforms, gum, t0)
    whole = mega.mega_window(s1, e1, o1, *args, **kw)
    split = mega.mega_window_launches(s2, e2, o2, *args, **kw)
    assert_bits_equal(whole, split)
    if fl.graph is not None:
        assert float(split[3][5].spill_in.sum()) > 0.0


SLOW_CASES = [("paper-burst", 4, 20, "k3"), ("flaky-telemetry", 4, 20, "k3"),
              ("paper-burst", 3, 10, "k2"), ("paper-burst", 3, 10, "k5"),
              ("paper-burst", 5, 30, "k3")]


@pytest.mark.parametrize("scenario,r,t_pre,topo_key", SLOW_CASES,
                         ids=["clean", "masked", "k2", "k5", "odd-r"])
def test_slow_step_matches_reference_and_full_refresh(scenario, r, t_pre,
                                                      topo_key):
    """One boundary on the same replay draws: the port's streaming slow
    step against the reference's, and against its own full refresh (A
    counts, hit counts and the recomputed rows equal, colsum within
    rounding).  The run's accumulated colsum re-derives from the slots."""
    horizon = t_pre + 10
    router, _, _ = _ref_world(scenario, r, horizon, topo_key)
    cfg = router.cfg
    p_cfg = generative.AifConfig(topology=port_topo(TOPOS[topo_key]))
    (state, _, _), (st_r, _, _) = _both_sides(
        _midrun(scenario, r, t_pre, horizon, topo_key), p_cfg)
    full = mega._refresh_cache(state.a_counts, state.slots, p_cfg)
    np.testing.assert_allclose(t2n(state.cache.colsum), t2n(full.colsum),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(state.cache.coefact, full.coefact)

    ks = jax.random.split(jax.random.key(9), r)
    size = jnp.minimum(st_r.t, horizon)
    idx = jax.vmap(lambda k, n: jax.random.randint(
        k, (cfg.replay_batch,), 0, jnp.maximum(n, 1)))(ks, size)
    idx = torch.tensor(np.asarray(idx), dtype=torch.int64)
    ref_next = ref_mega.mega_slow_step(st_r, ks, cfg)
    s_inc = mega.mega_slow_step(state, idx, p_cfg, incremental=True)
    s_full = mega.mega_slow_step(state, idx, p_cfg, incremental=False)
    assert_tree_close(s_inc, ref_next, path="slow_step")
    assert torch.equal(s_inc.a_counts, s_full.a_counts)
    assert torch.equal(s_inc.slots.wcount, s_full.slots.wcount)
    for name in ("proj", "projsum", "logna", "qnproj", "sumqn", "coefw",
                 "coefact"):
        assert torch.equal(getattr(s_inc.cache, name),
                           getattr(s_full.cache, name)), name
    np.testing.assert_allclose(t2n(s_inc.cache.colsum),
                               t2n(s_full.cache.colsum), rtol=1e-5,
                               atol=1e-5)


def test_to_agent_state_matches_reference():
    router, _, _ = _ref_world("paper-burst", 3, 30, "k3")
    p_cfg = generative.AifConfig()
    (state, _, _), (st_r, _, _) = _both_sides(
        _midrun("paper-burst", 3, 20, 30, "k3"), p_cfg)
    dense_r = ref_mega.to_agent_state(st_r, router.cfg)
    assert_tree_close(mega.to_agent_state(state, p_cfg), dense_r,
                      path="dense")


def test_watchdog_quarantine_matches_reference():
    router, _, _ = _ref_world("paper-burst", 3, 30, "k3")
    p_cfg = generative.AifConfig()
    (state, _, _), (st_r, _, _) = _both_sides(
        _midrun("paper-burst", 3, 20, 30, "k3"), p_cfg)
    st_r = st_r._replace(belief=st_r.belief.at[1, 3].set(jnp.nan))
    state.belief[1, 3] = float("nan")
    bad_r = ref_mega.mega_watchdog_bad(st_r)
    fixed_r = ref_mega.mega_quarantine(st_r, bad_r, router.cfg)
    bad_p = mega.mega_watchdog_bad(state)
    assert bad_p.tolist() == [False, True, False]
    np.testing.assert_array_equal(t2n(bad_p), np.asarray(bad_r))
    fixed_p = mega.mega_quarantine(state, bad_p, p_cfg)
    assert_tree_close(fixed_p, fixed_r, path="quarantined")
    assert not mega.mega_watchdog_bad(fixed_p).any()


def test_state_converter_round_trip_and_warm_paths_raise():
    p_cfg = generative.AifConfig()
    snap = _midrun("paper-burst", 3, 20, 30, "k3")
    (state, _, _), (st_r, _, _) = _both_sides(snap, p_cfg)
    assert state.slots.action.dtype == torch.int64
    assert state.slots.q_prev.dtype == torch.float32
    assert_tree_close(state, st_r)
    back = mega_state_to_port(st_r, p_cfg)
    assert_tree_close(back, st_r)
    # a warm state (dense b_base baseline) carries across both ways too
    dense = mega.to_agent_state(state, p_cfg)
    warm = mega.init_mega_state(p_cfg, 3, 30, device="cpu",
                                from_agent_state=dense)
    warm_r = mega_state_to_ref(port_to_numpy(warm))
    assert_tree_close(warm, warm_r)
    assert_tree_close(mega_state_to_port(warm_r, p_cfg), warm_r)
    # the warm paths still raise where the promotion cannot hold
    with pytest.raises(ValueError, match="uniform fleet clock"):
        mega.init_mega_state(p_cfg, 3, 30, device="cpu",
                             from_agent_state=dense._replace(
                                 t=torch.tensor([20, 21, 20])))
    with pytest.raises(ValueError, match="n_slots"):
        mega.init_mega_state(p_cfg, 3, 10, device="cpu",
                             from_agent_state=dense)


def test_cuda_wrapper_refuses_cpu_tensors_and_unported_options():
    """On the CPU the dispatch takes the plain version, fault schedules
    included (against the reference's oracle on the same schedules); the
    kernel's own wrapper never runs the plain version in its place, a row
    block included; a row block of the whole fleet (the sharded engine's
    one shard, once refused as ROADMAP A10) runs the unsharded window to
    the bit."""
    router, env_step = _port_world("paper-burst", 3, 30, "k3")
    ref_router, params, ref_env = _ref_world("paper-burst", 3, 30, "k3")
    (state, est, obs), (st_r, est_r, obs_r) = _both_sides(
        _midrun("paper-burst", 3, 20, 30, "k3"), router.cfg)
    fl, rfl = env_step.fluid, ref_env.fluid
    kw = dict(cfg=router.cfg, disc=router.resolved_disc,
              util_edges=router.resolved_util_edges,
              util_period=router.util_period, dt=fl.dt,
              scrape_every=fl.scrape_every, restart_blackout=False,
              emits_mask=False)
    w, r, k = 10, 3, fl.params.n_tiers
    k_env = jax.random.split(jax.random.key(5), w)
    gum = jax.random.gumbel(jax.random.key(6), (w, r, router.cfg.n_actions))
    uniforms = torch.stack([torch.stack(env_uniforms(x, (r, k)))
                            for x in k_env])
    args = (state, est, obs, fl.params, fl.arrival_rate[20:30],
            fl.hazard_scale[20:30], None, uniforms,
            torch.tensor(np.asarray(gum)), 20)
    rng = np.random.default_rng(0)
    fd = (rng.random((w, r, k)) < 0.2).astype(np.float32)
    sp = rng.uniform(0.2, 1.0, (w, r, k)).astype(np.float32)
    launches = mega_kernel.mega_window_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        mega_kernel.mega_window_cuda(*args, **kw)
    with pytest.raises(ValueError, match="CUDA"):
        mega_kernel.mega_window_cuda(*args, **kw,
                                     forced_down=torch.tensor(fd))
    with pytest.raises(ValueError, match="CUDA"):
        mega_kernel.mega_window_cuda(*args, **kw, row_block=(0, r, r))
    assert mega_kernel.mega_window_cuda.launches == launches
    assert_bits_equal(ops.mega_window(*args, **kw, row_block=(0, r, r)),
                      ops.mega_window(*args, **kw))
    port = ops.mega_window(*args, **kw, forced_down=torch.tensor(fd),
                           speed=torch.tensor(sp))
    ref = ref_mega.mega_window(
        st_r, est_r, obs_r, params, rfl.arrival_rate[20:30],
        rfl.hazard_scale[20:30], None, k_env, gum, 20,
        **dict(kw, cfg=ref_router.cfg, disc=ref_router.resolved_disc),
        forced_down=jnp.asarray(fd), speed=jnp.asarray(sp))
    np.testing.assert_array_equal(t2n(port[3][0]), np.asarray(ref[3][0]))
    assert_tree_close(port[0], ref[0], path="state")
    assert_tree_close(port[1], ref[1], path="est")
    assert_tree_close(port[3][5], ref[3][5], path="win")
    assert float(port[1].err_restart.sum()) > float(est.err_restart.sum())
