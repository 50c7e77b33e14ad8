"""The networked continuum on the port (mirrors ``tests/test_graph.py``
without its sharded rows; its graph-on-mega row is in
``tests/test_torch_mega_worlds.py``).

Fleet-graph presets and their edge tensors must equal the reference's; one
spillover window from a carried mid-run state must match the reference's
in every field; the graph scenarios' ``Experiment`` runs (fused and
unfused) must take the reference's action on every tick of every cell
with the reference's key chain replayed by ``JaxChainNoise``, all draws in
the reference's R1 PRNG mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.core import graph as ref_graph
from repro.core import topology as ref_topology
from repro.envsim import SimConfig as RefSimConfig
from repro.envsim import batched as ref_batched
from repro.envsim import scenarios as ref_scen
from repro_torch import api
from repro_torch.api import engine
from repro_torch.core import graph
from repro_torch.core.graph import FleetGraph
from repro_torch.envsim import SimConfig, batched, scenarios
from torch_port_ref import (JaxChainNoise, assert_bits_equal, assert_close,
                            assert_tree_close, env_uniforms, port_topo, t2n,
                            to_numpy)

GRAPH_SCENARIOS = ("ring-spillover", "grid-hotspot", "hier-continuum")


@pytest.fixture(autouse=True)
def _r1_prng_mode():
    with jax.threefry_partitionable(False):
        yield


# ------------------------------------------------------------- graph spec
@pytest.mark.parametrize("preset", ["ring", "grid", "hier", "none"])
@pytest.mark.parametrize("n", [1, 2, 5, 9, 13])
def test_presets_equal_reference(preset, n):
    got = graph.GRAPH_PRESETS[preset](n)
    want = ref_graph.GRAPH_PRESETS[preset](n)
    assert (got.n_cells, got.edges, got.hop_s, got.name) == \
        (want.n_cells, want.edges, want.hop_s, want.name)
    gd, rd = got.device_data(device="cpu"), want.device_data()
    if rd is None:
        assert gd is None
        return
    for field in ("src", "dst", "hop", "share", "has_out"):
        np.testing.assert_array_equal(t2n(getattr(gd, field)),
                                      np.asarray(getattr(rd, field)),
                                      err_msg=field)
    # the padded edge lists hold each cell's in- and out-edges in edge order
    src, dst = t2n(gd.src), t2n(gd.dst)
    for lists, cells in ((gd.in_edges, dst), (gd.out_edges, src)):
        lists = t2n(lists)
        for c in range(n):
            want_e = np.flatnonzero(cells == c)
            got_e = lists[c][lists[c] < len(src)]
            np.testing.assert_array_equal(got_e, want_e)
    out_deg = np.bincount(src, minlength=n)
    assert gd.out_edges.shape[1] == max(out_deg.max(), 1)


def test_graph_validation_resolution_and_modality():
    with pytest.raises(ValueError, match="edge"):
        FleetGraph(n_cells=4, edges=((0, 9),), hop_s=(0.1,))
    with pytest.raises(ValueError, match="self"):
        FleetGraph(n_cells=4, edges=((1, 1),), hop_s=(0.1,))
    with pytest.raises(ValueError, match="hop"):
        FleetGraph(n_cells=4, edges=((0, 1),), hop_s=())
    assert hash(graph.ring(6)) == hash(graph.ring(6))
    g = graph.ring(8)
    with pytest.raises(ValueError, match="pad"):
        g.validate_true_rows(6)
    g.validate_true_rows(8)
    assert g.device_data(r_pad=12, device="cpu").has_out.shape == (12,)
    with pytest.raises(ValueError, match="r_pad"):
        g.device_data(r_pad=4, device="cpu")
    r = 6
    assert graph.resolve_graph(None, r) is None
    assert graph.resolve_graph("none", r) is None
    assert graph.resolve_graph(FleetGraph(n_cells=r), r) is None
    auto = graph.resolve_graph(None, r, scenario="ring-spillover")
    assert auto == graph.ring(r)
    assert graph.resolve_graph("none", r, scenario="ring-spillover") is None
    assert graph.GRAPH_SCENARIOS == ref_graph.GRAPH_SCENARIOS
    with pytest.raises(KeyError, match="graph preset"):
        graph.resolve_graph("bogus", r)
    with pytest.raises(ValueError, match="true fleet size"):
        graph.resolve_graph(graph.ring(4), r)
    assert (graph.NEIGHBOR_BINS, graph.NEIGHBOR_EDGES) == \
        (ref_graph.NEIGHBOR_BINS, ref_graph.NEIGHBOR_EDGES)
    ref5 = ref_graph.with_neighbor_modality(ref_topology.default_topology())
    got5 = graph.with_neighbor_modality(
        port_topo(ref_topology.default_topology()))
    assert got5 == port_topo(ref5)
    assert graph.with_neighbor_modality(got5) == got5


@pytest.mark.parametrize("name", GRAPH_SCENARIOS)
def test_graph_scenario_schedules_equal_reference(name):
    assert name not in scenarios.WAITING
    got = scenarios.build_scenario(name, SimConfig(), 9, 40, seed=3)
    want = ref_scen.build_scenario(name, RefSimConfig(), 9, 40, seed=3)
    for field in ref_scen.ScenarioBatch._fields:
        a, b = getattr(got, field), getattr(want, field)
        if b is None or isinstance(b, bool):
            assert a == b, field
        else:
            np.testing.assert_array_equal(a, b, err_msg=field)


# ----------------------------------------------- engine: spillover physics
def _ref_world(scenario, r, t, g=None):
    sc = ref_scen.build_scenario(scenario, RefSimConfig(), r, t)
    params = ref_batched.params_from_config(RefSimConfig(), r,
                                            sc.capacity_scale)
    return sc, params, ref_batched.make_scenario_env_step(params, sc, graph=g)


def _world(scenario, r, t, g=None):
    sc = scenarios.build_scenario(scenario, SimConfig(), r, t)
    params = batched.params_from_config(SimConfig(), r, sc.capacity_scale,
                                        device="cpu")
    return params, batched.make_scenario_env_step(params, sc, graph=g)


@pytest.mark.parametrize("scenario,preset,t0", [
    ("ring-spillover", "ring", 14), ("grid-hotspot", "grid", 9),
    ("hier-continuum", "hier", 12), ("zone-outage", "ring", 12)])
def test_fluid_window_step_with_graph_matches_reference(scenario, preset,
                                                        t0):
    """One window from a carried mid-run state (the reference's, after t0
    windows under skewed weights), every field of the state and of the
    window's info, spillover fields and the neighbor column included."""
    r, t = 9, 20
    g_ref = ref_graph.GRAPH_PRESETS[preset](r)
    sc, params_r, step_r = _ref_world(scenario, r, t, g_ref)
    step_r = jax.jit(step_r, static_argnames=("row_block", "shard_axis"))
    w = jnp.asarray(np.random.default_rng(0).dirichlet(np.ones(3), r),
                    jnp.float32)
    st = ref_batched.init_fluid_state(params_r, n_modalities=5)
    key = jax.random.key(3)
    for i in range(t0):
        key, k = jax.random.split(key)
        st, _ = step_r(st, w, i, k)
    key, k = jax.random.split(key)
    st_r, info_r = step_r(st, w, t0, k)
    assert float(jnp.sum(info_r.spill_in)) > 0.0     # spillover is live

    params_p, step_p = _world(scenario, r, t, graph.GRAPH_PRESETS[preset](r))
    assert step_p.has_graph and step_p.n_obs_modalities == 5
    st_p, info_p = step_p(batched.fluid_state_from_numpy(to_numpy(st), "cpu"),
                          torch.tensor(np.asarray(w)), t0,
                          env_uniforms(k, (r, 3)))
    assert info_p.raw_obs.shape == (r, 5)
    assert_tree_close(st_p, st_r, path=f"{scenario}.state")
    assert_tree_close(info_p, info_r, path=f"{scenario}.info")


def test_spillover_conserves_fleet_mass():
    """Fleet-global accounting closes under spillover: every offered unit
    ends as a success, a failure, or backlog still in the system."""
    r, t = 6, 40
    params, env_step = _world("ring-spillover", r, t, graph.ring(r))
    router = api.LeastLoadedRouter(tiers=3, extra_modalities=1)
    _, est, trace = engine.rollout(
        router, router.init_carry(r, "cpu"),
        batched.init_fluid_state(params, n_modalities=5), env_step, t,
        seed=0)

    def tot(x):
        return float(t2n(x).astype(np.float64).sum())

    accounted = (tot(est.n_success) + tot(est.err_timeout)
                 + tot(est.err_overflow) + tot(est.err_refused)
                 + tot(est.err_restart) + tot(est.backlog))
    np.testing.assert_allclose(accounted, tot(est.n_requests), rtol=1e-5)
    assert tot(trace.env.spill_admitted) > 0.0
    assert tot(trace.env.spill_out) >= tot(trace.env.spill_admitted)
    nbr = t2n(trace.env.nbr_pressure)
    assert (nbr >= 0.0).all() and (nbr <= 1e3).all()


def test_empty_edge_graph_is_the_ungraphed_program():
    r, t = 4, 20
    params, step_none = _world("flash-crowd", r, t)
    empty = graph.resolve_graph(FleetGraph(n_cells=r), r)
    _, step_empty = _world("flash-crowd", r, t, empty)
    # an edge-less graph reaching the env directly runs no spillover either
    _, step_direct = _world("flash-crowd", r, t, FleetGraph(n_cells=r))
    outs = []
    for step in (step_none, step_empty, step_direct):
        assert not step.has_graph
        assert step.n_obs_modalities == batched.N_OBS_MODALITIES
        router = api.LeastLoadedRouter(tiers=3)
        _, est, trace = engine.rollout(
            router, router.init_carry(r, "cpu"),
            batched.init_fluid_state(params), step, t, seed=0)
        assert trace.env.spill_admitted is None
        outs.append((est, trace))
    for other in outs[1:]:
        assert_bits_equal(outs[0], other)
    e = api.Experiment(router="aif", scenario="ring-spillover", n_cells=r,
                       n_windows=t, device="cpu")
    a = api.run(dataclasses.replace(e, graph="none"))
    b = api.run(dataclasses.replace(e, graph=FleetGraph(n_cells=r)))
    c = api.run(dataclasses.replace(e, graph=None, scenario="flash-crowd"))
    assert a.offload_frac == b.offload_frac == 0.0
    assert_bits_equal((a.final_carry, a.trace), (b.final_carry, b.trace))
    assert a.trace.raw_obs.shape[-1] == c.trace.raw_obs.shape[-1] == 4


# ------------------------------------------------- experiment-level parity
def ref_run(e: api.Experiment):
    """The reference's run of the port's experiment ``e``."""
    g = e.graph
    if isinstance(g, FleetGraph):
        g = ref_graph.FleetGraph(n_cells=g.n_cells, edges=g.edges,
                                 hop_s=g.hop_s, name=g.name)
    return ref_api.run(ref_api.Experiment(
        router=e.router, scenario=e.scenario, n_cells=e.n_cells,
        n_windows=e.n_windows, seed=e.seed, fused=e.fused, graph=g))


def assert_run_matches(port, ref):
    np.testing.assert_array_equal(t2n(port.trace.actions),
                                  np.asarray(ref.trace.actions))
    for field in ("success_pct", "success_std", "p50_ms", "p95_ms",
                  "obs_frac", "restarts", "offload_frac"):
        assert_close(getattr(port, field), getattr(ref, field),
                     err_msg=field)
    assert_close(port.tier_share, ref.tier_share)
    assert_close(port.routed_share, ref.routed_share)
    assert_tree_close(port.trace.env, ref.trace.env)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("scenario,r,t", [("ring-spillover", 6, 30),
                                          ("grid-hotspot", 8, 20),
                                          ("hier-continuum", 8, 25)])
def test_graph_experiment_matches_reference(scenario, r, t, fused):
    e = api.Experiment(router="aif", scenario=scenario, n_cells=r,
                       n_windows=t, fused=fused, device="cpu")
    ref = ref_run(e)
    port = api.run(e, noise=JaxChainNoise(e.seed, r, t))
    assert port.trace.raw_obs.shape[-1] == 5
    assert port.final_carry.belief.shape[-1] == ref.final_carry.belief.shape[-1]
    assert_run_matches(port, ref)
    assert port.offload_frac > 0.0
    assert port.success_pct <= 100.0


def test_graph_baselines_match_reference_and_beat_ungraphed():
    """The baselines on a graph world (grown to the 5-column observation)
    match the reference's; a ring fleet under a localized flash crowd
    absorbs more of the burst than the same run without the graph; and
    nn_offload in the Table-1 grid on a graph scenario reports its offload
    share."""
    r, t = 8, 30
    grid = api.table1_grid(routers=("least_loaded", "nn_offload", "thompson"),
                           scenario_names=("ring-spillover",), n_cells=r,
                           n_windows=t, device="cpu")
    runs = [api.run(e, noise=JaxChainNoise(e.seed, r, t)) for e in grid]
    for e, port in zip(grid, runs):
        assert_run_matches(port, ref_run(e))
    comp = api.compare(grid)
    md = comp.markdown()
    assert "nn_offload" in md and "offload %" in md
    js = comp.to_json()
    assert js["ring-spillover"]["nn_offload"]["offload_frac"] > 0.0
    control = api.run(dataclasses.replace(grid[0], graph="none"),
                      noise=JaxChainNoise(0, r, t))

    def fleet(res):
        return float(res.fluid.n_success.sum()) / float(
            res.fluid.n_requests.sum())

    assert fleet(runs[0]) > fleet(control)
    assert control.offload_frac == 0.0 < runs[0].offload_frac


def test_graph_chaos_resumes_to_the_bit(tmp_path):
    """Graph plus zone-outage chaos: the run matches the reference's (its
    refused load sheds to live ring neighbors), and a checkpointed run
    resumed from its checkpoint ends in the same state to the bit."""
    base = dict(router="aif", scenario="zone-outage", n_cells=6,
                n_windows=30, graph="ring", device="cpu")
    e = api.Experiment(**base)
    ref = ref_run(e)
    port = api.run(e, noise=JaxChainNoise(0, 6, 30))
    assert_run_matches(port, ref)
    assert port.offload_frac > 0.0 and port.recovery is not None
    r0 = api.run(e)
    ck = str(tmp_path / "ck")
    r1 = api.run(api.Experiment(**base, checkpoint_every=10,
                                checkpoint_dir=ck))
    assert r1.resume_points == (10, 20)
    assert_bits_equal((r0.final_carry, r0.trace), (r1.final_carry, r1.trace))
    r2 = api.run(api.Experiment(**base, resume_from=ck))
    assert r2.resume_points == (20,)
    assert_bits_equal(r0.final_carry, r2.final_carry)
    np.testing.assert_array_equal(r0.fluid.n_success, r2.fluid.n_success)
    assert r2.trace.env.spill_admitted.shape == (10, 6)


def test_graph_router_instance_mismatch_raises():
    with pytest.raises(ValueError, match="neighbor"):
        api.run(api.Experiment(router=api.AifRouter(),
                               scenario="ring-spillover", n_cells=4,
                               n_windows=10, device="cpu"))
    # a router built for the neighbor modality passes; baselines grow to it
    topo5 = graph.with_neighbor_modality(api.AifRouter().cfg.topology)
    from repro_torch.api.experiment import _make_aif
    aif5 = _make_aif(api.AifRouter().cfg.topology, SimConfig(), True, False,
                     graph=graph.ring(4))
    assert aif5.cfg.topology == topo5
    res = api.run(api.Experiment(router=aif5, scenario="ring-spillover",
                                 n_cells=4, n_windows=10, device="cpu"))
    assert res.trace.raw_obs.shape[-1] == 5
    res = api.run(api.Experiment(router=api.UniformRouter(),
                                 scenario="ring-spillover", n_cells=4,
                                 n_windows=10, device="cpu"))
    assert res.offload_frac >= 0.0 and res.trace.raw_obs.shape[-1] == 5


@pytest.mark.parametrize("g", ["ring", None])
def test_graph_on_the_mega_path_raises_a8b(g):
    """A graph on the mega path, once refused (ROADMAP A8b), runs and
    matches the reference's mega run (an explicit preset and the
    scenario's default graph); the ungraphed control of the same world
    runs there too, without spillover."""
    e = api.Experiment(router="aif", mega=True, scenario="ring-spillover",
                       n_cells=4, n_windows=20, graph=g, device="cpu")
    ref = ref_api.run(ref_api.Experiment(
        router="aif", mega=True, scenario="ring-spillover", n_cells=4,
        n_windows=20, graph=g))
    port = api.run(e, noise=JaxChainNoise(0, 4, 20))
    assert port.trace.raw_obs.shape[-1] == 5
    assert_run_matches(port, ref)
    assert_tree_close(port.final_carry, ref.final_carry, path="carry")
    assert port.offload_frac > 0.0
    res = api.run(dataclasses.replace(e, graph="none"))
    assert res.trace.actions.shape == (20, 4)
    assert res.offload_frac == 0.0 and res.trace.env.spill_in is None
