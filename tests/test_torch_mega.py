"""The port's whole-window mega path end to end:
``Experiment(router="aif", mega=True)`` against the reference's mega
``Experiment`` (its XLA oracle window) on the same draws, against the port's
own fused path, and its contracts (the reference's chunked dispatch, bf16
slots, the options that raise).

The port runs on the CPU, where every window is the plain PyTorch version
of kernel B3 (``repro_torch.core.mega.mega_window``); ``JaxChainNoise``
replays the reference's key chain.  Actions must be equal on every tick of
every cell, floats within rtol 1e-4 / atol 1e-6.
"""
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.core import topology as ref_topology
from repro_torch import api
from repro_torch.core import generative, mega
from torch_port_ref import (JaxChainNoise, assert_close, assert_tree_close,
                            port_topo, t2n)

TWO_TIER = ref_topology.Topology(tier_names=("edge", "cloud"),
                                 tier_classes=("edge-medium", "server"))

# (scenario, R, T, topology): clean and masked telemetry, the restart
# blackout, an odd R whose T=23 ends in a 3-tick remainder window, K=2, K=5
CASES = [
    ("paper-burst", 6, 25, "paper-3tier"),
    ("flaky-telemetry", 6, 25, "paper-3tier"),
    ("scrape-blackout", 5, 25, "paper-3tier"),
    ("paper-burst", 5, 23, "paper-3tier"),
    ("paper-burst", 4, 15, TWO_TIER),
    ("paper-burst", 4, 15, ref_topology.five_tier_topology()),
]
IDS = ["clean", "masked", "blackout", "odd-r-remainder", "k2", "k5"]


def _port_topology(topo):
    return topo if isinstance(topo, str) else port_topo(topo)


def _port_run(scenario, r, t, topo, seed=0, **kw):
    return api.run(api.Experiment(router="aif", scenario=scenario,
                                  topology=_port_topology(topo), n_cells=r,
                                  n_windows=t, seed=seed, device="cpu",
                                  **kw),
                   noise=JaxChainNoise(seed, r, t))


def _assert_runs_match(port, ref):
    np.testing.assert_array_equal(t2n(port.trace.actions),
                                  np.asarray(ref.trace.actions))
    for name in ("routing_weights", "raw_obs", "unstable", "obs_frac",
                 "watchdog"):
        assert_close(getattr(port.trace, name).to(torch.float32),
                     np.asarray(getattr(ref.trace, name), np.float32),
                     err_msg=f"trace.{name}")
    assert_tree_close(port.trace.env, ref.trace.env, path="trace.env")
    for field in ("success_pct", "p50_ms", "p95_ms", "obs_frac", "restarts",
                  "watchdog_events"):
        assert_close(getattr(port, field), getattr(ref, field),
                     err_msg=field)
    assert_close(port.tier_share, ref.tier_share)
    assert_close(port.routed_share, ref.routed_share)


@pytest.mark.parametrize("scenario,r,t,topo", CASES, ids=IDS)
def test_mega_experiment_matches_reference(scenario, r, t, topo):
    ref = ref_api.run(ref_api.Experiment(
        router="aif", scenario=scenario, topology=topo, n_cells=r,
        n_windows=t, seed=0, fused=True, mega=True))
    port = _port_run(scenario, r, t, topo, mega=True)
    _assert_runs_match(port, ref)
    assert isinstance(port.final_carry, mega.MegaFleetState)
    assert_tree_close(port.final_carry, ref.final_carry, path="final_carry")
    if scenario == "flaky-telemetry":
        assert port.obs_frac < 1.0          # the mask was exercised


@pytest.mark.parametrize("scenario", ["paper-burst", "flaky-telemetry"])
def test_mega_matches_the_ports_fused_path(scenario):
    """The whole-window path and the per-tick fused path are one closed loop
    (the reference pins the same between its two engines)."""
    r, t = 6, 25
    fused = _port_run(scenario, r, t, "paper-3tier")
    whole = _port_run(scenario, r, t, "paper-3tier", mega=True)
    np.testing.assert_array_equal(t2n(whole.trace.actions),
                                  t2n(fused.trace.actions))
    for name in ("routing_weights", "raw_obs", "obs_frac"):
        np.testing.assert_allclose(t2n(getattr(whole.trace, name)),
                                   t2n(getattr(fused.trace, name)),
                                   atol=1e-4, err_msg=name)
    for f in whole.trace.env._fields:
        a, b = getattr(whole.trace.env, f), getattr(fused.trace.env, f)
        if b is None:       # the graph fields of an ungraphed world
            assert a is None, f
            continue
        np.testing.assert_allclose(t2n(a), t2n(b), atol=1e-4,
                                   err_msg=f"env.{f}")
    np.testing.assert_allclose(t2n(whole.final_carry.belief),
                               t2n(fused.final_carry.belief), atol=1e-4)


def test_launch_periods_matches_single_launch():
    """The reference splits its one launch into chunks of
    ``launch_periods`` periods; the port, whose every window is a launch of
    its own, accepts the option and still gives the chunked reference run's
    actions, trace and final factored state."""
    r, t = 6, 25
    ref = ref_api.run(ref_api.Experiment(
        router="aif", scenario="paper-burst", n_cells=r, n_windows=t, seed=0,
        fused=True, mega=True, launch_periods=2))
    port = _port_run("paper-burst", r, t, "paper-3tier", mega=True,
                     launch_periods=2)
    _assert_runs_match(port, ref)
    assert_tree_close(port.final_carry, ref.final_carry, path="final_carry")


def test_bf16_slots_bounded_drift():
    """bfloat16 slot storage (float32 accumulation) stays finite, keeps
    normalized beliefs and stays close to the float32 fused path."""
    f32 = _port_run("paper-burst", 4, 20, "paper-3tier")
    bf16 = _port_run("paper-burst", 4, 20, "paper-3tier", mega=True,
                     mega_slot_dtype="bfloat16")
    assert bf16.final_carry.slots.q_prev.dtype == torch.bfloat16
    assert torch.isfinite(bf16.trace.raw_obs).all()
    np.testing.assert_allclose(t2n(bf16.final_carry.belief).sum(-1), 1.0,
                               atol=1e-3)
    assert abs(f32.success_pct - bf16.success_pct) < 10.0


def test_generator_noise_mega_run_is_deterministic():
    e = api.Experiment(scenario="paper-burst", n_cells=3, n_windows=23,
                       seed=2, mega=True, device="cpu")
    a, b = api.run(e), api.run(e)
    assert torch.equal(a.trace.actions, b.trace.actions)
    assert a.success_pct == b.success_pct
    acts = t2n(a.trace.actions)
    # windows start on selecting ticks; the action holds for the dwell
    assert (acts[1:5] == acts[0]).all() and (acts[21:23] == acts[20]).all()
    np.testing.assert_allclose(t2n(a.final_carry.belief).sum(-1), 1.0,
                               rtol=1e-5)
    assert int(a.final_carry.t[0]) == 23


def test_mega_horizon_exceeds_capacity_raises():
    cfg = generative.AifConfig(replay_capacity=16)
    with pytest.raises(ValueError, match="replay_capacity"):
        api.run(api.Experiment(router=api.AifRouter(cfg=cfg, mega=True),
                               n_cells=2, n_windows=20, device="cpu"))
    with pytest.raises(ValueError, match="replay_capacity"):
        mega.init_mega_state(cfg, 2, 17, device="cpu")


def test_launch_periods_rejected_off_mega_and_below_one():
    with pytest.raises(ValueError, match="launch_periods"):
        api.run(api.Experiment(router="uniform", launch_periods=2,
                               n_cells=2, n_windows=10, device="cpu"))
    with pytest.raises(ValueError, match="launch_periods"):
        api.run(api.Experiment(mega=True, launch_periods=0, n_cells=2,
                               n_windows=10, device="cpu"))


def test_mega_router_checks():
    with pytest.raises(ValueError, match="dwell"):
        api.AifRouter(cfg=generative.AifConfig(action_dwell_s=3.0),
                      mega=True)
    with pytest.raises(ValueError, match="novelty"):
        api.AifRouter(cfg=generative.AifConfig(novelty_weight=0.1),
                      mega=True)
    with pytest.raises(ValueError, match="mega_slot_dtype"):
        api.AifRouter(mega=True, mega_slot_dtype="float16")
