"""The paper's event-simulator protocol on the port: ``EdgeSimulator``,
``run_experiment``, the Table-1 harness and the numpy baselines
(``repro_torch.envsim.simulator`` / ``harness``, ``repro_torch.baselines``)
against the reference's, and the AIF core's remaining public names.

The simulator and the baselines are host numpy carried over as code: on
the same seeds every ``RunResult`` field equals the reference's to the
bit.  The port's ``AifRouter`` runs on the CPU with the reference router's
key chain replayed by ``RouterKeyChainNoise`` (R1 PRNG mode); its float32
policy rows, widened to float64, must equal the reference's to the bit,
since the simulator routes on their cumulative sum.  The first six tests
are the port's twins of ``tests/test_envsim.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import baselines as ref_baselines
from repro import core as ref_core
from repro import envsim as ref_envsim
from repro.core import agent as ref_agent
from repro.core import belief as ref_belief
from repro.core import fleet as ref_fleet
from repro.core import spaces as ref_spaces
from repro_torch import baselines, core, envsim
from repro_torch.baselines import (CapacityRouter, LeastLoadedRouter,
                                   UniformRouter)
from repro_torch.core import agent, belief, fleet, generative, spaces
from repro_torch.envsim import (AifRouter, SimConfig, discretization_for,
                                run_experiment, sim_config_for)
from torch_port_ref import RouterKeyChainNoise, assert_close, t2n


@pytest.fixture(autouse=True)
def _r1_prng_mode():
    with jax.threefry_partitionable(False):
        yield


def assert_results_equal(port, ref):
    """Every field of two simulator ``RunResult``s equal to the bit (arrays
    in value and dtype, scalars in value and type)."""
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray) or isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b and type(a) is type(b), (f.name, a, b)


# ------------------------------------------- twins of tests/test_envsim.py
def test_request_conservation():
    res = run_experiment(UniformRouter(), SimConfig(), 120.0, seed=0)
    # every generated request is a success, a failure, or still in the
    # system (queued / in flight) at the horizon
    in_flight = res.n_requests - res.n_success - res.n_error
    assert 0 <= in_flight < 500
    assert res.n_requests > 0


def test_determinism_same_seed():
    r1 = run_experiment(UniformRouter(), SimConfig(), 90.0, seed=7)
    r2 = run_experiment(UniformRouter(), SimConfig(), 90.0, seed=7)
    assert r1.n_requests == r2.n_requests
    assert r1.n_success == r2.n_success
    assert r1.p50_ms == pytest.approx(r2.p50_ms)


def test_capacity_router_beats_uniform():
    """Capacity-aware prior knowledge solves the testbed (paper §5.1)."""
    uni = run_experiment(UniformRouter(), SimConfig(), 600.0, seed=1)
    cap = run_experiment(CapacityRouter(), SimConfig(), 600.0, seed=1)
    assert cap.success_rate > uni.success_rate
    assert cap.p50_ms < uni.p50_ms


def test_instability_off_removes_restarts():
    cfg = dataclasses.replace(SimConfig(), instability=False)
    res = run_experiment(UniformRouter(), cfg, 300.0, seed=3)
    assert res.n_restarts.sum() == 0


def test_least_loaded_sane():
    res = run_experiment(LeastLoadedRouter(), SimConfig(), 300.0, seed=2)
    assert res.success_rate > 0.8


@pytest.mark.slow
def test_aif_learns_heavy_bias_and_latency_win():
    """Directional Table-1 claims on a shortened protocol (15 sim-minutes),
    with the port's own draws (its router's default generator noise)."""
    cfg = SimConfig()
    uni = run_experiment(UniformRouter(), cfg, 900.0, seed=1)
    aif = run_experiment(AifRouter(seed=1, device="cpu"), cfg, 900.0, seed=1)
    # Fig 2: AIF lowers P50 materially
    assert aif.p50_ms < 0.8 * uni.p50_ms
    # Fig 3b: heavy share of successes grows
    assert aif.tier_share_of_success()[2] > uni.tier_share_of_success()[2]
    # exploration has a reliability price under instability (§5.2)
    assert aif.success_rate < uni.success_rate + 0.02


# ------------------------------------------------ parity with the reference
BASELINES = [("UniformRouter", {}, 240.0, 0), ("CapacityRouter", {}, 180.0, 1),
             ("RoundRobinRouter", {}, 120.0, 2),
             ("LeastLoadedRouter", {}, 300.0, 3),
             ("ThompsonRouter", {"seed": 4}, 300.0, 4),
             ("UcbRouter", {}, 240.0, 5)]


@pytest.mark.parametrize("name,kw,duration,seed", BASELINES,
                         ids=[b[0] for b in BASELINES])
def test_baseline_run_matches_reference(name, kw, duration, seed):
    ref = ref_envsim.run_experiment(getattr(ref_baselines, name)(**kw),
                                    ref_envsim.SimConfig(), duration,
                                    seed=seed)
    port = run_experiment(getattr(baselines, name)(**kw), SimConfig(),
                          duration, seed=seed)
    assert ref.n_requests > 0 and ref.action_trace is None
    assert_results_equal(port, ref)


def test_bandits_on_five_tiers_match_reference():
    """The bandits' arms are the generated policy rows of the topology."""
    ref_cfg = ref_envsim.sim_config_for(ref_core.five_tier_topology())
    cfg = sim_config_for(core.five_tier_topology())
    for name, kw in (("ThompsonRouter", {"seed": 3}), ("UcbRouter", {})):
        ref = ref_envsim.run_experiment(
            getattr(ref_baselines, name)(
                topology=ref_core.five_tier_topology(), **kw),
            ref_cfg, 150.0, seed=6)
        port = run_experiment(
            getattr(baselines, name)(topology=core.five_tier_topology(), **kw),
            cfg, 150.0, seed=6)
        assert_results_equal(port, ref)


def _worlds():
    return {
        "paper-3tier": (ref_envsim.SimConfig(), SimConfig(), None, None),
        "continuum-5tier": (
            ref_envsim.sim_config_for(ref_core.five_tier_topology()),
            sim_config_for(core.five_tier_topology()),
            ref_core.five_tier_topology(), core.five_tier_topology()),
    }


@pytest.mark.parametrize("world", ["paper-3tier", "continuum-5tier"])
def test_aif_run_matches_reference(world):
    """200 windows of the port's AifRouter on the CPU against the
    reference's, on the same draws: actions, weights and the whole
    ``RunResult`` equal (the utilization scrape lands on every 10th tick,
    so 20 scrapes are read)."""
    ref_cfg, cfg, ref_topo, topo = _worlds()[world]
    n, seed = 200, 3
    if ref_topo is None:
        ref_router = ref_envsim.AifRouter(seed=seed)
        router = AifRouter(seed=seed, noise=RouterKeyChainNoise(seed, n),
                           device="cpu")
    else:
        ref_router = ref_envsim.AifRouter(
            cfg=ref_core.AifConfig(topology=ref_topo),
            disc=ref_envsim.discretization_for(ref_cfg), seed=seed)
        router = AifRouter(cfg=generative.AifConfig(topology=topo),
                           disc=discretization_for(cfg), seed=seed,
                           noise=RouterKeyChainNoise(seed, n), device="cpu")
    ref = ref_envsim.run_experiment(ref_router, ref_cfg, float(n), seed=4)
    port = run_experiment(router, cfg, float(n), seed=4)
    np.testing.assert_array_equal(port.action_trace, ref.action_trace)
    np.testing.assert_array_equal(port.weights_trace, ref.weights_trace)
    assert_results_equal(port, ref)
    assert router.unstable_trace == ref_router.unstable_trace
    assert router.ticks == n and len(set(router.actions)) > 1


def test_evaluate_strategy_and_table1_match_reference():
    """The harness's seed scheme (router ``base_seed + 1000 r``, world
    ``base_seed + 17 r``) and its Table-1 rendering, 2 runs x 120 s."""
    n = 120
    makers = {
        "uniform": (lambda s: ref_baselines.UniformRouter(),
                    lambda s: UniformRouter()),
        "aif": (lambda s: ref_envsim.AifRouter(seed=s),
                lambda s: AifRouter(seed=s, noise=RouterKeyChainNoise(s, n),
                                    device="cpu")),
    }
    ref_sums, port_sums = [], []
    for name, (make_ref, make_port) in makers.items():
        ref = ref_envsim.evaluate_strategy(make_ref, name,
                                           ref_envsim.SimConfig(),
                                           duration_s=float(n), n_runs=2,
                                           base_seed=5)
        port = envsim.evaluate_strategy(make_port, name, SimConfig(),
                                        duration_s=float(n), n_runs=2,
                                        base_seed=5)
        for f in dataclasses.fields(ref):
            a, b = getattr(port, f.name), getattr(ref, f.name)
            if f.name == "runs":
                for ra, rb in zip(a, b, strict=True):
                    assert_results_equal(ra, rb)
            elif isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            else:
                assert a == b, (f.name, a, b)
        ref_sums.append(ref)
        port_sums.append(port)
    assert envsim.table1(port_sums) == ref_envsim.table1(ref_sums)
    assert port_sums[1].row() == ref_sums[1].row()


# ----------------------------------------------- the AIF core's public names
def test_core_exports_the_reference_names():
    assert sorted(core.__all__) == sorted(ref_core.__all__)
    for name in core.__all__:
        assert getattr(core, name) is not None, name
    for name in ("AifRouter", "EdgeSimulator", "MetricsSnapshot", "RunResult",
                 "run_experiment", "StrategySummary", "evaluate_strategy",
                 "table1"):
        assert name in envsim.__all__ and hasattr(envsim, name), name


@pytest.mark.parametrize("masked", [False, True])
def test_observe_and_discretize_matches_reference(masked):
    disc = spaces.DiscretizationConfig()
    raw = np.array([[0.5, 50.0, 10.0, 0.1], [2.0, 70.0, 100.0, 0.3],
                    [np.inf, -1.0, np.nan, 0.15], [3.0, 48.0, 80.0, 0.0]],
                   np.float32)
    mask = (np.array([[1, 0, 1, 1], [0, 0, 0, 0], [1, 1, 1, 0],
                      [1, 1, 1, 1]], np.float32) if masked else None)
    ref_fn = jax.jit(ref_agent.observe_and_discretize,
                     static_argnames="disc")
    want_bins, want_mask = ref_fn(
        jnp.asarray(raw), disc=ref_core.DiscretizationConfig(),
        obs_mask=None if mask is None else jnp.asarray(mask))
    bins, got_mask = agent.observe_and_discretize(
        torch.from_numpy(raw), disc,
        None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(t2n(bins), np.asarray(want_bins))
    assert got_mask.dtype == torch.float32
    np.testing.assert_array_equal(t2n(got_mask), np.asarray(want_mask))


@pytest.mark.parametrize("five", [False, True], ids=["3tier", "5tier"])
def test_state_index_and_levels_match_reference(five):
    topo = core.five_tier_topology() if five else core.default_topology()
    ref_topo = (ref_core.five_tier_topology() if five
                else ref_core.default_topology())
    table = spaces.state_factor_table(topo)
    for s in range(topo.n_states):
        levels = table[s]
        assert spaces.state_index(levels, topo) == s
        assert ref_spaces.state_index(levels, ref_topo) == s
    all_states = np.arange(topo.n_states)
    got = spaces.state_levels(torch.from_numpy(all_states), topo)
    want = np.asarray(ref_spaces.state_levels(all_states, ref_topo))
    np.testing.assert_array_equal(t2n(got), want)
    np.testing.assert_array_equal(t2n(got), table)
    # one index, and a Python int
    np.testing.assert_array_equal(
        t2n(spaces.state_levels(topo.n_states - 1, topo)),
        np.asarray(ref_spaces.state_levels(topo.n_states - 1, ref_topo)))


def test_prior_from_normalized_matches_reference():
    rng = np.random.default_rng(11)
    s = core.default_topology().n_states
    counts = rng.uniform(0.0, 1.0, (s, s)).astype(np.float32)
    counts[:, 7] = 0.0                               # an all-zero column
    b_row = counts / np.maximum(counts.sum(0, keepdims=True), 1e-30)
    for q in (rng.dirichlet(np.ones(s)).astype(np.float32),
              np.eye(s, dtype=np.float32)[7]):       # all mass on it: 0 prior
        want = jax.jit(ref_belief.prior_from_normalized)(jnp.asarray(b_row),
                                                         jnp.asarray(q))
        got = belief.prior_from_normalized(torch.from_numpy(b_row),
                                           torch.from_numpy(q))
        assert_close(got, want)
    # a batch of rows and beliefs
    qs = rng.dirichlet(np.ones(s), 3).astype(np.float32)
    got = belief.prior_from_normalized(torch.from_numpy(b_row)[None],
                                       torch.from_numpy(qs))
    for i in range(3):
        assert_close(got[i], ref_belief.prior_from_normalized(
            jnp.asarray(b_row), jnp.asarray(qs[i])))


def test_fleet_routing_weights_matches_reference():
    """One unfused fleet tick on the same per-router keys: the applied
    policy rows equal to the bit."""
    r = 4
    cfg, ref_cfg = generative.AifConfig(), ref_core.AifConfig()
    rng = np.random.default_rng(2)
    obs = rng.integers(0, 2, (r, 4)).astype(np.int32)
    errs = rng.uniform(0.0, 0.3, r).astype(np.float32)
    keys = jax.random.split(jax.random.key(5), r)

    class Keys:
        def gumbel(self, t, shape):
            g = jax.vmap(lambda k: jax.random.gumbel(
                jax.random.split(k)[0], (shape[-1],)))(keys)
            return torch.tensor(np.asarray(g))

    _, info_ref = ref_fleet.fleet_tick(ref_fleet.init_fleet_state(ref_cfg, r),
                                       jnp.asarray(obs), jnp.asarray(errs),
                                       keys, ref_cfg)
    _, info = fleet.fleet_tick(fleet.init_fleet_state(cfg, r, "cpu"),
                               torch.from_numpy(obs), torch.from_numpy(errs),
                               Keys(), 0, cfg, fused=False)
    np.testing.assert_array_equal(t2n(info.action), np.asarray(info_ref.action))
    w = fleet.fleet_routing_weights(info)
    assert w.shape == (r, 3)
    np.testing.assert_array_equal(
        t2n(w), np.asarray(ref_fleet.fleet_routing_weights(info_ref)))
