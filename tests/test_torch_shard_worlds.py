"""The port's sharded engine on the mega path, on graph worlds and under
faults, and one window at a row block.

Counterparts of the reference's sharded cases in ``tests/test_mega.py``,
``tests/test_graph.py`` and ``tests/test_chaos.py``; a ring whose edges
cross the shards' borders on 4 shards; a chaos run resumed to the bit on
4 shards, per-tick and mega; one mega window and one env window at a row
block against the reference's own row-block code
(``core.mega.mega_window(row_block=...)``, which traces without a graph).
The reference's sharded engine does not trace on jax 0.9.0 (ROADMAP R2),
so whole runs are held against its *unsharded* runs, drawing its key
chain through ``JaxChainNoise`` in the R1 PRNG mode: floats within rtol
1e-4 / atol 1e-6; against the port's own unsharded run a 1-shard run is
equal to the bit.
"""
import jax
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.api import engine as ref_engine
from repro.api import experiment as ref_experiment
from repro.core import mega as ref_mega
from repro.core.topology import default_topology as ref_default
from repro_torch import api
from repro_torch.api import engine, experiment, shard
from repro_torch.core import graph as graph_mod
from repro_torch.core import mega
from repro_torch.envsim import SimConfig, batched, scenarios
from torch_port_ref import (JaxChainNoise, assert_bits_equal, assert_close,
                            assert_tree_close, env_uniforms,
                            mega_state_to_ref, port_to_numpy, t2n)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _r1_prng_mode():
    with jax.threefry_partitionable(False):
        yield


def _sharded(e, d, noise):
    return experiment._run_sharded(e, CPU, api.ShardSpec(), noise,
                                   mesh=[CPU] * d)


def _real(tree, n):
    return shard._map(lambda x: x[:n] if x.ndim else x, tree)


# ------------------------------------------------------------- sharded mega
def test_mega_sharded_single_device_bit_identity():
    """``sharded_rollout`` of a mega router on one shard: the factored
    state and env state equal the unsharded engine's to the bit and the
    reference's unsharded run at the bar; the reducer's observation sum is
    the trace's."""
    r, t = 6, 25
    e = api.Experiment(router="aif", mega=True, n_cells=r, n_windows=t,
                       device="cpu")
    topo = e.resolve_topology()
    scfg, params, env_step = experiment._build_world(
        topo, "paper-burst", r, t, 1.0, 0, CPU)
    router = e.resolve_router(scfg)
    s1, e1, tr1 = engine.rollout(router, None,
                                 batched.init_fluid_state(params), env_step,
                                 t, JaxChainNoise(0, r, t))
    s2, e2, stats = engine.sharded_rollout(
        router, batched.init_fluid_state(params), env_step, t,
        JaxChainNoise(0, r, t), shard=api.ShardSpec(devices=1), n_cells=r,
        reducer=api.FleetMetricsReducer(n_cells=r))
    assert_bits_equal((s1, e1), (s2, e2))
    ref_topo = ref_default()
    r_scfg, r_params, r_env = ref_experiment._build_world(
        ref_topo, "paper-burst", r, t, 1.0, 0)
    r_router = ref_experiment._make_aif(ref_topo, r_scfg, True, False, True)
    ref_s, ref_e, _ = ref_engine.rollout(
        r_router, None, _ref_init(r_params), r_env, t, jax.random.key(0))
    assert_tree_close(s2, ref_s, path="state")
    assert_tree_close(e2, ref_e, path="env")
    ref_obs = float(t2n(tr1.obs_frac)[1:].sum())
    assert abs(float(stats[2]) - ref_obs) < 1e-4


def _ref_init(params):
    from repro.envsim import batched as ref_batched
    return ref_batched.init_fluid_state(params)


def test_mega_sharded_experiment_metrics_match_unsharded():
    base = dict(router="aif", mega=True, n_cells=6, n_windows=25)
    r0 = api.run(api.Experiment(**base, device="cpu"),
                 noise=JaxChainNoise(0, 6, 25))
    r1 = api.run(api.Experiment(**base, device="cpu",
                                shard=api.ShardSpec(devices=1)),
                 noise=JaxChainNoise(0, 6, 25))
    ref = ref_api.run(ref_api.Experiment(**base, fused=True))
    for field in ("success_pct", "obs_frac"):
        assert abs(getattr(r1, field) - getattr(r0, field)) < 1e-5, field
        assert_close(getattr(r1, field), getattr(ref, field), err_msg=field)
    np.testing.assert_allclose(r1.tier_share, r0.tier_share, atol=1e-5)
    assert_close(r1.tier_share, ref.tier_share)
    assert_close(r1.routed_share, ref.routed_share)
    assert r1.trace is None


def test_mega_sharded_multi_device_matches_unsharded():
    """The sharded mega path does not depend on the shard count: R=6 on 4
    shards (padded to 8) against the reference's unsharded run."""
    base = dict(router="aif", mega=True, n_cells=6, n_windows=25)
    r4 = _sharded(api.Experiment(**base, device="cpu"), 4,
                  JaxChainNoise(0, 6, 25))
    ref = ref_api.run(ref_api.Experiment(**base, fused=True))
    for field in ("success_pct", "obs_frac"):
        assert abs(getattr(r4, field) - getattr(ref, field)) < 1e-4, field
    np.testing.assert_allclose(r4.tier_share, ref.tier_share, atol=1e-4)
    np.testing.assert_allclose(r4.routed_share, ref.routed_share, atol=1e-4)
    assert r4.cells_per_device == 2
    assert_tree_close(_real(r4.final_carry, 6), ref.final_carry,
                      path="carry")


# ------------------------------------------------------------ graph worlds
def test_sharded_single_device_graph_bit_identity():
    """The graphed engine on one shard: the exchange needs no gather and
    the final env state equals the unsharded rollout's to the bit, and the
    reference's at the bar; the admitted spillover reaches the reducer."""
    r, t = 6, 30
    g = graph_mod.ring(r)
    sc = scenarios.build_scenario("ring-spillover", SimConfig(), r, t)
    params = batched.params_from_config(SimConfig(), r, sc.capacity_scale,
                                        device="cpu")
    env_step = batched.make_scenario_env_step(params, sc, graph=g)
    router = api.LeastLoadedRouter(tiers=3, extra_modalities=1)
    _, est_ref, _ = engine.rollout(
        router, router.init_carry(r, CPU),
        batched.init_fluid_state(params, n_modalities=5), env_step, t,
        JaxChainNoise(0, r, t))
    _, est_sh, stats = engine.sharded_rollout(
        router, batched.init_fluid_state(params, n_modalities=5), env_step,
        t, JaxChainNoise(0, r, t), shard=api.ShardSpec(devices=1),
        n_cells=r, reducer=api.FleetMetricsReducer(n_cells=r))
    assert_bits_equal(est_ref, est_sh)
    assert float(stats[3]) > 0.0
    ref = ref_api.run(ref_api.Experiment(router="least_loaded",
                                         scenario="ring-spillover",
                                         n_cells=r, n_windows=t))
    assert_close(est_sh.n_success, ref.fluid.n_success)
    assert_close(float(stats[3]) / float(est_sh.n_requests.sum()),
                 ref.offload_frac)


def test_offload_frac_reported_sharded():
    res = api.run(api.Experiment(router="least_loaded",
                                 scenario="ring-spillover", n_cells=6,
                                 n_windows=30, device="cpu",
                                 shard=api.ShardSpec(devices=1)),
                  noise=JaxChainNoise(0, 6, 30))
    assert res.offload_frac > 0.0
    assert res.summary()["offload_frac"] == round(res.offload_frac, 4)
    ref = ref_api.run(ref_api.Experiment(router="least_loaded",
                                         scenario="ring-spillover",
                                         n_cells=6, n_windows=30))
    assert_close(res.offload_frac, ref.offload_frac)


@pytest.mark.parametrize("mega_path", [False, True], ids=["fused", "mega"])
def test_ring_across_shard_borders_matches_unsharded_reference(mega_path):
    """ring-spillover at R=7 on 4 shards (padded to 8): every shard's first
    and last cell spill across a border every tick (and on the mega path
    the plain model of B3's launches runs over the 4 blocks).  Against the
    reference's unsharded run: the carry's real rows, success and offload
    at the bar."""
    r, t = 7, 25
    e = api.Experiment(router="aif", scenario="ring-spillover", n_cells=r,
                       n_windows=t, mega=mega_path, device="cpu")
    r4 = _sharded(e, 4, JaxChainNoise(0, r, t))
    ref = ref_api.run(ref_api.Experiment(router="aif", fused=True,
                                         scenario="ring-spillover",
                                         n_cells=r, n_windows=t,
                                         mega=mega_path))
    assert r4.offload_frac > 0.0
    for field in ("success_pct", "offload_frac", "restarts"):
        assert_close(getattr(r4, field), getattr(ref, field), err_msg=field)
    assert_close(r4.fluid.n_success, ref.fluid.n_success)
    assert_tree_close(_real(r4.final_carry, r), ref.final_carry,
                      path="carry")


# ------------------------------------------------------------- fault layer
@pytest.mark.parametrize("mega_path", [False, True], ids=["fused", "mega"])
def test_resume_bit_identical_sharded(mega_path):
    """zone-outage on 4 shards (R=8) in two chunks: the carry, env state
    and reduced stats equal the uninterrupted sharded run's to the bit; the
    env state matches the reference's unsharded run at the bar."""
    r, t = 8, 40
    spec = api.ShardSpec()
    e = api.Experiment(router="aif", scenario="zone-outage", n_cells=r,
                       n_windows=t, mega=mega_path, device="cpu")
    scfg, params, env_step = experiment._build_world_padded(
        e.resolve_topology(), e.scenario, r, t, 1.0, 0, r, 4, CPU)
    router = e.resolve_router(scfg)
    red = api.FleetMetricsReducer(n_cells=r)
    key = jax.random.key(42)
    kw = dict(shard=spec, n_cells=r, reducer=red, mesh=[CPU] * 4)

    def noise():
        return JaxChainNoise(0, r, t, key=key)

    c_u, e_u, stats_u = engine.sharded_rollout(
        router, batched.init_fluid_state(params), env_step, t, noise(), **kw)
    c1, e1, _, snap = engine.sharded_resumable_rollout(
        router, None, batched.init_fluid_state(params), env_step, 20,
        noise(), n_total=t, **kw)
    c2, e2, s2, _ = engine.sharded_resumable_rollout(
        router, c1, e1, env_step, 20, noise(), t_begin=20, snapshot=snap,
        **kw)
    assert_bits_equal(c_u, c2)
    assert_bits_equal(e_u, e2)
    assert_bits_equal(stats_u, engine.sharded_finalize(s2, shard=spec,
                                                       reducer=red))
    ref_topo = ref_default()
    r_scfg, r_params, r_env = ref_experiment._build_world(
        ref_topo, "zone-outage", r, t, 1.0, 0)
    r_router = ref_experiment._make_aif(ref_topo, r_scfg, True, False,
                                        mega_path)
    carry0 = None if mega_path else r_router.init_carry(r)
    _, ref_e, _ = ref_engine.rollout(r_router, carry0, _ref_init(r_params),
                                     r_env, t, key)
    assert_tree_close(e2, ref_e, path="env")


# ------------------------------------------------- one window, a row block
def test_row_block_window_matches_reference():
    """One mega window from a mid-run state at each of two row blocks of a
    4-cell fleet, against the reference's ``core.mega.mega_window`` with
    the same row block (restart uniforms drawn at the true R and sliced);
    ``mega_window_launches`` and ``mega_window_blocks`` at those blocks
    equal it to the bit."""
    r, t0, horizon, w = 4, 20, 40, 10
    e = api.Experiment(router="aif", mega=True, n_cells=r, n_windows=horizon,
                       device="cpu")
    scfg, params, env_step = experiment._build_world(
        e.resolve_topology(), "paper-burst", r, horizon, 1.0, 0, CPU)
    router = e.resolve_router(scfg)
    state, est, _, obs = engine.mega_rollout(
        router, batched.init_fluid_state(params), env_step, t0,
        JaxChainNoise(0, r, horizon), n_total=horizon)
    fl = env_step.fluid
    ref_topo = ref_default()
    r_scfg, r_params, r_env = ref_experiment._build_world(
        ref_topo, "paper-burst", r, horizon, 1.0, 0)
    r_router = ref_experiment._make_aif(ref_topo, r_scfg, True, False, True)
    k_env = jax.random.split(jax.random.key(11), w)
    gum = jax.random.gumbel(jax.random.key(12),
                            (w, r, router.cfg.n_actions))
    uniforms = torch.stack([torch.stack(env_uniforms(k, (r, 3)))
                            for k in k_env])
    sl = slice(t0, t0 + w)
    kw = dict(cfg=router.cfg, disc=router.resolved_disc,
              util_edges=router.resolved_util_edges,
              util_period=router.util_period, dt=fl.dt,
              scrape_every=fl.scrape_every, restart_blackout=False,
              emits_mask=False)
    r_kw = dict(kw, cfg=r_router.cfg, disc=r_router.resolved_disc)
    snap = port_to_numpy(state)

    def block_state(row0):
        return mega.mega_state_from_numpy(_rows_np(snap, row0), router.cfg,
                                          "cpu")

    outs = []
    for row0 in (0, 2):
        rows = slice(row0, row0 + 2)
        rb = (row0, r, r)
        st_b = block_state(row0)
        est_b = batched.FluidState(*(x[rows] for x in est))
        obs_b = tuple(x[rows] for x in obs)
        u_b = uniforms[:, :, rows].contiguous()
        g_b = torch.tensor(np.asarray(gum))[:, rows].contiguous()
        port = mega.mega_window(st_b, est_b, obs_b, fl.params,
                                fl.arrival_rate[sl], fl.hazard_scale[sl],
                                None, u_b, g_b, t0, row_block=rb, **kw)
        ref = ref_mega.mega_window(
            mega_state_to_ref(_rows_np(snap, row0)),
            _ref_rows(est_b), tuple(jax.numpy.asarray(t2n(x))
                                    for x in obs_b), r_params,
            r_env.fluid.arrival_rate[sl], r_env.fluid.hazard_scale[sl],
            None, k_env, gum[:, rows], t0, row_block=rb, **r_kw)
        np.testing.assert_array_equal(t2n(port[3][0]), np.asarray(ref[3][0]))
        assert_tree_close(port[0], ref[0], path=f"block {row0} state")
        assert_tree_close(port[1], ref[1], path=f"block {row0} est")
        assert_tree_close(port[3][5], ref[3][5], path=f"block {row0} win")
        again = mega.mega_window_launches(
            block_state(row0), est_b, obs_b, fl.params, fl.arrival_rate[sl],
            fl.hazard_scale[sl], None, u_b, g_b, t0, row_block=rb, **kw)
        assert_bits_equal(port, again)
        outs.append((st_b, est_b, obs_b, u_b, g_b, rb, port))
    blocks = mega.mega_window_blocks(
        [(block_state(o[5][0]),) + o[1:6] for o in outs], fl.params,
        fl.arrival_rate[sl],
        fl.hazard_scale[sl], None, t0, **kw)
    for got, o in zip(blocks, outs):
        assert_bits_equal(got, o[6])


def _rows_np(tree, row0):
    """Rows ``row0, row0 + 1`` of a :func:`port_to_numpy` dict."""
    if isinstance(tree, dict):
        return {k: _rows_np(v, row0) for k, v in tree.items()}
    return None if tree is None else tree[row0:row0 + 2]


def _ref_rows(est):
    from repro.envsim import batched as ref_batched
    return ref_batched.FluidState(**{k: jax.numpy.asarray(t2n(v))
                                     for k, v in est._asdict().items()})
