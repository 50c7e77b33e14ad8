"""Fault schedules and fleet graphs on the port's whole-window (mega) path.

``Experiment(mega=True)`` on the five chaos presets (with their mega
control runs and recovery metrics) and on the three graph presets (M=5,
spillover, ``offload_frac``) against the reference's mega runs of the same
experiments, whose dispatch sends such windows to its XLA oracle; the
counterparts of the reference's ``tests/test_chaos.py::
test_resume_bit_identical_mega`` and ``tests/test_graph.py::
test_mega_engine_matches_per_tick_with_graph``; checkpointed mega runs on a
graph + chaos world resumed to the bit.

The port runs on the CPU (the plain version of kernel B3, which
``chip_smoke.py`` holds against the kernel on the card), drawing the
reference's key chain through ``JaxChainNoise`` in its R1 PRNG mode:
actions equal on every tick of every cell, floats within rtol 1e-4 / atol
1e-6, resumes equal to the bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro_torch import api
from repro_torch.api import engine, experiment
from repro_torch.core import mega
from repro_torch.envsim import batched, chaos
from torch_port_ref import (JaxChainNoise, assert_bits_equal, assert_close,
                            assert_tree_close, clone_tree, t2n)

CHAOS = sorted(chaos.CHAOS_PRESETS)
GRAPHS = [("ring-spillover", 6, 25), ("grid-hotspot", 6, 20),
          ("hier-continuum", 8, 20)]


@pytest.fixture(autouse=True)
def _r1_prng_mode():
    with jax.threefry_partitionable(False):
        yield


def _runs(scenario, r, t, **kw):
    """(port, reference) mega runs of one experiment on the same draws."""
    ref = ref_api.run(ref_api.Experiment(
        router="aif", scenario=scenario, n_cells=r, n_windows=t, seed=0,
        fused=True, mega=True, **kw))
    port = api.run(api.Experiment(
        router="aif", scenario=scenario, n_cells=r, n_windows=t, seed=0,
        mega=True, device="cpu", **kw), noise=JaxChainNoise(0, r, t))
    return port, ref


def _assert_runs_match(port, ref):
    np.testing.assert_array_equal(t2n(port.trace.actions),
                                  np.asarray(ref.trace.actions))
    for field in ("success_pct", "success_std", "p50_ms", "p95_ms",
                  "obs_frac", "restarts", "offload_frac",
                  "watchdog_events"):
        assert_close(getattr(port, field), getattr(ref, field),
                     err_msg=field)
    assert_close(port.tier_share, ref.tier_share)
    assert_close(port.routed_share, ref.routed_share)
    assert_tree_close(port.trace.env, ref.trace.env, path="trace.env")
    assert isinstance(port.final_carry, mega.MegaFleetState)
    assert_tree_close(port.final_carry, ref.final_carry, path="final_carry")


@pytest.mark.parametrize("scenario", CHAOS)
def test_mega_chaos_experiment_matches_reference(scenario):
    """A chaos preset on the mega path, and its control on the mega path
    too: the run and its recovery metrics equal the reference's."""
    port, ref = _runs(scenario, 3, 30)
    _assert_runs_match(port, ref)
    rec, rec_ref = port.recovery, ref.recovery
    assert rec.keys() == rec_ref.keys()
    for k, v in rec_ref.items():
        if isinstance(v, float):
            assert_close(rec[k], v, err_msg=k)
        else:
            assert rec[k] == v, k


@pytest.mark.parametrize("scenario,r,t", GRAPHS, ids=[g[0] for g in GRAPHS])
def test_mega_graph_experiment_matches_reference(scenario, r, t):
    """A graph preset on the mega path: five telemetry columns, the
    spillover fields and the fleet-global success ratio as the
    reference's."""
    port, ref = _runs(scenario, r, t)
    assert port.trace.raw_obs.shape[-1] == 5
    assert port.final_carry.slots.obs_bins.shape[-1] == 5
    _assert_runs_match(port, ref)
    assert port.offload_frac > 0.0


def _world(scenario, r, t, g=None):
    e = api.Experiment(router="aif", scenario=scenario, n_cells=r,
                       n_windows=t, mega=True, device="cpu", graph=g)
    fg = e.resolve_graph()
    scfg, params, env_step = experiment._build_world(
        e.resolve_topology(), scenario, r, t, 1.0, 0, torch.device("cpu"),
        fg)
    return e.resolve_router(scfg, fg), params, env_step


@pytest.mark.parametrize("scenario,g", [("zone-outage", None),
                                        ("zone-outage", "ring")],
                         ids=["zone-outage", "zone-outage-ring"])
def test_resume_bit_identical_mega(scenario, g):
    """Counterpart of the reference's test of the same name: a chaos world
    (and the same on a ring graph) run on the mega path in two chunks ends
    in the uninterrupted run's carry and env state to the bit, and each
    chunk's trace is the uninterrupted trace's slice."""
    r, t = 4, 40
    router, params, env_step = _world(scenario, r, t, g)
    n_mod = env_step.n_obs_modalities
    noise = JaxChainNoise(42, r, t)
    c_u, e_u, tr_u = engine.rollout(
        router, None, batched.init_fluid_state(params, n_mod), env_step, t,
        noise)
    c1, e1, tr1, snap = engine.resumable_rollout(
        router, None, batched.init_fluid_state(params, n_mod), env_step, 20,
        noise, n_total=t)
    assert snap[0][0].shape == (r, n_mod)
    c2, e2, tr2, _ = engine.resumable_rollout(
        router, c1, e1, env_step, 20, noise, t_begin=20, snapshot=snap)
    assert_bits_equal((c_u, e_u), (c2, e2))
    joined = experiment._cat([tr1, tr2])
    assert_bits_equal(tr_u, joined)
    # the outage refused load (on the ring its cells export all of it)
    spilled = tr_u.env.spill_out
    assert float(e_u.err_refused.sum()) + (
        0.0 if spilled is None else float(spilled.sum())) > 0.0


def test_mega_engine_matches_per_tick_with_graph():
    """Counterpart of the reference's test of the same name: on a graphed
    world the mega path takes the per-tick engine's action on every tick,
    and its accounting and offload share agree."""
    base = dict(router="aif", scenario="ring-spillover", n_cells=6,
                n_windows=25, device="cpu")
    r1 = api.run(api.Experiment(**base), noise=JaxChainNoise(0, 6, 25))
    r2 = api.run(api.Experiment(**base, mega=True),
                 noise=JaxChainNoise(0, 6, 25))
    np.testing.assert_array_equal(t2n(r1.trace.actions),
                                  t2n(r2.trace.actions))
    np.testing.assert_allclose(r1.fluid.n_success.astype(np.float64),
                               r2.fluid.n_success.astype(np.float64),
                               atol=1e-3)
    assert abs(r1.offload_frac - r2.offload_frac) < 1e-5
    assert r2.offload_frac > 0.0


def test_graph_chaos_mega_resumes_to_the_bit(tmp_path):
    """Graph plus zone-outage chaos on the mega path: the run matches the
    reference's, and a run checkpointed every 10 windows, then resumed from
    its last checkpoint, ends in the uninterrupted run's state to the bit
    (the snapshot's telemetry carry five columns wide)."""
    base = dict(router="aif", scenario="zone-outage", n_cells=6,
                n_windows=30, graph="ring", mega=True, device="cpu")
    port, ref = _runs("zone-outage", 6, 30, graph="ring")
    _assert_runs_match(port, ref)
    assert port.offload_frac > 0.0 and port.recovery is not None
    r0 = api.run(api.Experiment(**base))
    ck = str(tmp_path / "ck")
    r1 = api.run(api.Experiment(**base, checkpoint_every=10,
                                checkpoint_dir=ck))
    assert r1.resume_points == (10, 20)
    assert_bits_equal((r0.final_carry, r0.trace), (r1.final_carry, r1.trace))
    r2 = api.run(api.Experiment(**base, resume_from=ck))
    assert r2.resume_points == (20,)
    assert_bits_equal(r0.final_carry, r2.final_carry)
    np.testing.assert_array_equal(r0.fluid.n_success, r2.fluid.n_success)
    assert r2.trace.raw_obs.shape == (10, 6, 5)


def test_mega_chaos_warm_promotion_continues_per_tick_run():
    """Warm promotion on a chaos world: a dense per-tick carry promoted
    onto the mega path mid-storm takes the per-tick continuation's action
    on every tick of the same world and draws."""
    r, t1, t2 = 4, 20, 20
    e = api.Experiment(router="aif", scenario="straggler-storm", n_cells=r,
                       n_windows=t1 + t2, device="cpu")
    scfg, params, env_step = experiment._build_world(
        e.resolve_topology(), e.scenario, r, t1 + t2, 1.0, 0,
        torch.device("cpu"))
    pt = e.resolve_router(scfg)
    mg = dataclasses.replace(pt, mega=True)
    noise = JaxChainNoise(0, r, t1 + t2)
    c_a, e_a, _, snap = engine.resumable_rollout(
        pt, pt.init_carry(r, "cpu"), batched.init_fluid_state(params),
        env_step, t1, noise)
    c_copy, e_copy = clone_tree(c_a), clone_tree(e_a)
    _, e_b, tr_b, _ = engine.resumable_rollout(
        pt, c_a, e_a, env_step, t2, noise, t_begin=t1, snapshot=snap)
    state, e_m, tr_m, _ = engine.mega_rollout(
        mg, e_copy, env_step, t2, noise, carry=c_copy, obs_carry=snap[0])
    assert bool((env_step.fluid.speed[t1:] < 1.0).any())
    assert state.cache.b_base is not None
    assert torch.equal(tr_b.actions, tr_m.actions)
    for f in e_b._fields:
        np.testing.assert_allclose(t2n(getattr(e_b, f)),
                                   t2n(getattr(e_m, f)), atol=1e-4,
                                   err_msg=f"env.{f}")
