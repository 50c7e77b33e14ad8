"""The port's device-sharded fleet engine: ShardSpec, the sharded
per-tick engine and the metrics reducer.

Counterparts of the reference's ``tests/test_shard.py`` and of its
reducer cases in ``tests/test_mega.py``.  The reference's sharded engine
does not trace on jax 0.9.0 (ROADMAP R2), so the port's sharded runs are
held against the reference's *unsharded* runs of the same experiments,
drawing its key chain through ``JaxChainNoise`` in the R1 PRNG mode:
floats within rtol 1e-4 / atol 1e-6.  Against the port's own unsharded
run a 1-shard run is equal to the bit.  Several shards run on the CPU as
``mesh=[cpu] * D``, the port's counterpart of the reference's virtual CPU
mesh.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.api.experiment import FleetMetricsReducer as RefReducer
from repro_torch import api
from repro_torch.api import engine, experiment, shard
from repro_torch.core.topology import default_topology
from repro_torch.envsim import SimConfig, batched, scenarios
from repro_torch.noise import GeneratorNoise, RowBlockNoise
from torch_port_ref import (JaxChainNoise, assert_bits_equal, assert_close,
                            assert_tree_close, t2n)

R, T = 6, 30
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _r1_prng_mode():
    with jax.threefry_partitionable(False):
        yield


def _world(r, scenario="paper-burst", r_pad=None, t=T):
    sc = scenarios.build_scenario(scenario, SimConfig(), r, t, seed=0)
    if r_pad is not None:
        sc = scenarios.pad_scenario(sc, r_pad)
        r = r_pad
    params = batched.params_from_config(SimConfig(), r, sc.capacity_scale,
                                        device="cpu")
    return params, batched.make_scenario_env_step(params, sc)


def _sharded(e, d, noise=None):
    """``e`` over ``d`` shards laid on the CPU."""
    return experiment._run_sharded(e, CPU, api.ShardSpec(), noise,
                                   mesh=[CPU] * d)


# ---------------------------------------------------------------- ShardSpec
def test_shardspec_validation():
    with pytest.raises(ValueError, match="pad policy"):
        api.ShardSpec(pad="bogus")
    with pytest.raises(ValueError, match="devices"):
        api.ShardSpec(devices=0)
    with pytest.raises(ValueError, match="devices"):
        api.ShardSpec(devices=10_000).n_devices("cpu")
    assert api.ShardSpec(devices=1).padded(7, device="cpu") == (7, 7)
    assert shard.resolve(None) is None
    assert shard.resolve("auto") == api.ShardSpec()
    spec = api.ShardSpec(devices=1)
    assert shard.resolve(spec) is spec
    with pytest.raises(ValueError, match="shard must be"):
        shard.resolve(4)
    # frozen and hashable: a dataclass field of Experiment, a cache key
    assert hash(api.ShardSpec()) == hash(api.ShardSpec())
    assert api.ShardSpec(devices=1).build_mesh("cpu") == [CPU]


def test_padding_math():
    spec = api.ShardSpec(devices=1)
    assert spec.padded(1, device="cpu") == (1, 1)
    assert spec.padded(8, device="cpu") == (8, 8)


def test_padding_math_multi():
    spec = api.ShardSpec()
    assert spec.padded(8, 4) == (8, 2)
    assert spec.padded(7, 4) == (8, 2)
    with pytest.raises(ValueError, match="not divisible"):
        api.ShardSpec(pad="strict").padded(7, 4)


def test_rows_split_and_gather_round_trip():
    tree = (torch.arange(8.0).reshape(4, 2), torch.tensor(3.0),
            {"a": torch.arange(4)}, None)
    parts = shard.split_rows(tree, [CPU] * 2, 2)
    assert torch.equal(parts[1][0], torch.tensor([[4.0, 5.0], [6.0, 7.0]]))
    assert torch.equal(parts[1][1], torch.tensor(3.0))
    back = shard.gather_rows(parts, CPU)
    assert torch.equal(back[0], tree[0]) and torch.equal(back[2]["a"],
                                                         tree[2]["a"])
    assert back[3] is None
    with pytest.raises(ValueError, match="padded fleet size"):
        shard.split_rows((torch.zeros(3),), [CPU] * 2, 2)


def test_row_block_noise_draws_once_at_the_true_r():
    """Every shard reads its rows of one draw at the true R (phantom rows:
    restart uniforms 1.0, Gumbel noise the last real row's), and a
    generator advances as in the unsharded run."""
    a, b = GeneratorNoise(4, CPU), GeneratorNoise(4, CPU)
    group = RowBlockNoise(a, 3, 2, [CPU] * 2)
    views = [group.block(d) for d in range(2)]
    g = [v.gumbel(0, (2, 5)) for v in views]
    u = [v.env_uniforms(0, (2, 3)) for v in views]
    size = torch.tensor([4, 9])
    idx = [v.replay_indices(0, size, 6) for v in views]
    g_ref, u_ref = b.gumbel(0, (3, 5)), b.env_uniforms(0, (3, 3))
    idx_ref = b.replay_indices(0, torch.tensor([4, 9, 4]), 6)
    assert torch.equal(torch.cat(g)[:3], g_ref)
    assert torch.equal(g[1][1], g_ref[2])
    for k in range(2):
        assert torch.equal(torch.cat([x[k] for x in u])[:3], u_ref[k])
        assert torch.equal(u[1][k][1], torch.ones(3))
    assert torch.equal(torch.cat(idx)[:3], idx_ref)
    assert torch.equal(a.get_state(), b.get_state())


# ------------------------------------------------- engine guards + identity
def test_sharded_rollout_rejects_shard_blind_env():
    def naked_env(est, w, t, u):
        return est, None

    with pytest.raises(ValueError, match="supports_shard"):
        engine.sharded_rollout(
            api.LeastLoadedRouter(tiers=3), (), naked_env, 4,
            shard=api.ShardSpec(devices=1), n_cells=4,
            reducer=api.FleetMetricsReducer(n_cells=4))


def test_sharded_rollout_rejects_unpadded_state():
    params, env_step = _world(R)
    with pytest.raises(ValueError, match="padded fleet size"):
        engine.sharded_rollout(
            api.LeastLoadedRouter(tiers=3), batched.init_fluid_state(params),
            env_step, T, shard=api.ShardSpec(devices=1), n_cells=R + 1,
            reducer=api.FleetMetricsReducer(n_cells=R + 1))


def test_single_device_bit_identity():
    """One shard runs the unsharded engine's program to the bit; the final
    env state matches the reference's unsharded run, and the reducer's
    observation sum the trace's steady ticks."""
    params, env_step = _world(R)
    router = api.LeastLoadedRouter(tiers=3)
    _, est_ref, trace = engine.rollout(
        router, router.init_carry(R, CPU), batched.init_fluid_state(params),
        env_step, T, JaxChainNoise(0, R, T))
    _, est_sh, stats = engine.sharded_rollout(
        router, batched.init_fluid_state(params), env_step, T,
        JaxChainNoise(0, R, T), shard=api.ShardSpec(devices=1), n_cells=R,
        reducer=api.FleetMetricsReducer(n_cells=R))
    assert_bits_equal(est_ref, est_sh)
    ref = ref_api.run(ref_api.Experiment(router="least_loaded", n_cells=R,
                                         n_windows=T))
    assert_close(est_sh.n_success, ref.fluid.n_success)
    assert_close(est_sh.n_requests, ref.fluid.n_requests)
    ref_obs = float(t2n(trace.obs_frac)[1:].sum())
    assert abs(float(stats[2]) - ref_obs) < 1e-4


# (router, scenario, mega): the fused path, the mega path, a baseline, a
# chaos preset and a graph preset
ONE_SHARD = [("aif", "paper-burst", False), ("aif", "paper-burst", True),
             ("least_loaded", "paper-burst", False),
             ("aif", "zone-outage", False),
             ("least_loaded", "ring-spillover", False)]


@pytest.mark.parametrize("router,scenario,mega", ONE_SHARD,
                         ids=["fused", "mega", "baseline", "chaos", "graph"])
def test_single_device_experiment_metrics_match_unsharded(router, scenario,
                                                          mega):
    """``Experiment(shard=ShardSpec(devices=1))``: the final carry and env
    state equal the port's unsharded run's to the bit, and the metrics the
    reference's unsharded run's at the bar."""
    kw = dict(router=router, scenario=scenario, n_cells=R, n_windows=T,
              mega=mega)
    r0 = api.run(api.Experiment(**kw, device="cpu"),
                 noise=JaxChainNoise(0, R, T))
    r1 = api.run(api.Experiment(**kw, device="cpu",
                                shard=api.ShardSpec(devices=1)),
                 noise=JaxChainNoise(0, R, T))
    ref = ref_api.run(ref_api.Experiment(**kw, fused=(router == "aif")))
    assert_bits_equal(r0.final_carry, r1.final_carry)
    for f in ("n_requests", "n_success", "tier_success", "n_restarts"):
        np.testing.assert_array_equal(getattr(r0.fluid, f),
                                      getattr(r1.fluid, f), err_msg=f)
    for field in ("success_pct", "obs_frac", "restarts", "offload_frac"):
        assert_close(getattr(r1, field), getattr(ref, field), err_msg=field)
        assert abs(getattr(r1, field) - getattr(r0, field)) < 1e-5, field
    assert_close(r1.tier_share, ref.tier_share)
    assert_close(r1.routed_share, ref.routed_share)
    # fleet-global histogram quantiles against the mean of per-cell ones:
    # a different statistic, the same order of magnitude
    assert 0.5 < r1.p95_ms / max(ref.p95_ms, 1e-9) < 2.0
    assert r1.cells_per_device == R
    assert r1.trace is None and r1.recovery is None


# ------------------------------------------------------- multi-shard parity
@pytest.mark.parametrize("router,scenario", [
    ("aif", "paper-burst"), ("aif", "flaky-telemetry"),
    ("thompson", "paper-burst"), ("thompson", "flaky-telemetry"),
    ("least_loaded", "paper-burst"), ("least_loaded", "flaky-telemetry")])
def test_four_device_parity(router, scenario):
    """The reduced metrics do not depend on the shard count: R=6 on 4
    shards (padded to 8) against 1 shard (within 1e-5) and the reference's
    unsharded run (at the bar)."""
    kw = dict(router=router, scenario=scenario, n_cells=R, n_windows=T)
    e = api.Experiment(**kw, device="cpu")
    r1 = api.run(dataclasses.replace(e, shard=api.ShardSpec(devices=1)),
                 noise=JaxChainNoise(0, R, T))
    r4 = _sharded(e, 4, JaxChainNoise(0, R, T))
    ref = ref_api.run(ref_api.Experiment(**kw, fused=(router == "aif")))
    assert r4.cells_per_device == R // 4 + 1       # padded: ceil(6/4) = 2
    for field in ("success_pct", "obs_frac", "restarts"):
        assert abs(getattr(r4, field) - getattr(r1, field)) < 1e-5, field
        assert_close(getattr(r4, field), getattr(ref, field), err_msg=field)
    np.testing.assert_allclose(r4.tier_share, r1.tier_share, atol=1e-5)
    np.testing.assert_allclose(r4.routed_share, r1.routed_share, atol=1e-5)
    assert_close(r4.tier_share, ref.tier_share)
    assert_close(r4.routed_share, ref.routed_share)
    # the histogram quantiles are one statistic on every shard count
    assert abs(r4.p50_ms - r1.p50_ms) <= 1e-5 * max(r1.p50_ms, 1.0)
    assert abs(r4.p95_ms - r1.p95_ms) <= 1e-5 * max(r1.p95_ms, 1.0)
    real = shard._map(lambda x: x[:R] if x.ndim else x, r4.final_carry)
    assert_tree_close(real, r1.final_carry, rtol=1e-5, atol=1e-6)


def test_odd_r_padding_inert():
    """R=7 on 4 shards pads one phantom cell: the real rows equal the
    1-shard run's to the bit and the reference's unsharded run at the bar;
    the phantom row sees no traffic and no restart; the reductions agree."""
    r_true = 7
    spec = api.ShardSpec()
    r_pad, _ = spec.padded(r_true, 4)
    assert r_pad == 8
    router = api.LeastLoadedRouter(tiers=3)
    reducer = api.FleetMetricsReducer(n_cells=r_true)
    params1, env1 = _world(r_true)
    _, est1, stats1 = engine.sharded_rollout(
        router, batched.init_fluid_state(params1), env1, T,
        JaxChainNoise(0, r_true, T), shard=api.ShardSpec(devices=1),
        n_cells=r_true, reducer=reducer)
    params4, env4 = _world(r_true, r_pad=r_pad)
    _, est4, stats4 = engine.sharded_rollout(
        router, batched.init_fluid_state(params4), env4, T,
        JaxChainNoise(0, r_true, T), shard=spec, n_cells=r_true,
        reducer=reducer, mesh=[CPU] * 4)
    for name, a, b in zip(est1._fields, est1, est4):
        assert torch.equal(a, b[:r_true]), name
    assert float(est4.n_requests[r_true:].sum()) == 0.0
    assert float(est4.tier_requests[r_true:].sum()) == 0.0
    assert float(est4.n_restarts[r_true:].sum()) == 0.0
    for s1, s4 in zip(stats1, stats4):
        np.testing.assert_allclose(t2n(s1), t2n(s4), rtol=1e-6, atol=1e-6)
    ref = ref_api.run(ref_api.Experiment(router="least_loaded",
                                         n_cells=r_true, n_windows=T))
    assert_close(est4.n_success[:r_true], ref.fluid.n_success)
    assert_close(est4.tier_requests[:r_true], ref.fluid.tier_requests)


# ----------------------------------------------------------- memoization key
def test_padded_world_memo_key_includes_shard():
    """The padded world's cache keys on (r_pad, shard count): a re-padded
    world never replays a stale env_step closure."""
    topo = default_topology()
    a = experiment._build_world_padded(topo, "paper-burst", R, 10, 1.0, 0,
                                       R, 1, CPU)
    b = experiment._build_world_padded(topo, "paper-burst", R, 10, 1.0, 0,
                                       R, 1, CPU)
    c = experiment._build_world_padded(topo, "paper-burst", R, 10, 1.0, 0,
                                       R + 2, 4, CPU)
    assert a[2] is b[2]
    assert a[2] is not c[2]
    assert batched.init_fluid_state(c[1]).backlog.shape[0] == R + 2
    assert c[2].supports_shard


# ---------------------------------------------------------------- reducer
def _reducer_inputs(w, r_local, k, seed=0):
    rng = np.random.default_rng(seed)
    comp = rng.uniform(0.0, 5.0, (w, r_local, k)).astype(np.float32)
    lat = rng.uniform(1e-3, 2.0, (w, r_local, k)).astype(np.float32)
    p95 = rng.uniform(1e-3, 5.0, (w, r_local, k)).astype(np.float32)
    of = rng.uniform(0.0, 1.0, (w, r_local)).astype(np.float32)
    spill = rng.uniform(0.0, 2.0, (w, r_local)).astype(np.float32)
    return comp, lat, p95, of, spill


def _ys(arrays, sl, lib):
    comp, lat, p95, of, spill = (lib(x[sl]) for x in arrays)
    return SimpleNamespace(
        env=SimpleNamespace(tier_completed=comp, tier_latency_s=lat,
                            tier_p95_s=p95, spill_admitted=spill),
        obs_frac=of)


def test_reducer_update_window_matches_sequential():
    """The mega path's whole-window deposit equals W per-tick updates (the
    histograms to the bit: an integer sum), and both equal the reference's
    ``FleetMetricsReducer.init``/``update``/``update_window`` (which run
    outside shard_map) at the bar; the phantom row adds nothing."""
    w, r_local, k = 4, 6, 3
    arrays = _reducer_inputs(w, r_local, k)
    red = api.FleetMetricsReducer(n_cells=5)      # row 5 is a phantom
    ref = RefReducer(n_cells=5)
    stats0 = red.init(r_local, 0, CPU)
    seq = stats0
    for i in range(w):
        seq = red.update(seq, i, _ys(arrays, i, torch.tensor))
    vec = red.update_window(stats0, 0, _ys(arrays, slice(None),
                                           torch.tensor))
    ref0 = ref.init(r_local, jnp.asarray(0))
    ref_seq = ref0
    for i in range(w):
        ref_seq = ref.update(ref_seq, jnp.asarray(i),
                             _ys(arrays, i, jnp.asarray))
    ref_vec = ref.update_window(ref0, jnp.asarray(0),
                                _ys(arrays, slice(None), jnp.asarray))
    assert torch.equal(seq[1], vec[1]) and torch.equal(seq[2], vec[2])
    for got, want in ((seq, ref_seq), (vec, ref_vec)):
        assert_close(got[0], want[0])
        for i in (1, 2):
            assert_close(got[i].double() / experiment._HIST_ONE, want[i],
                         atol=1e-5)
        assert_close(got[3], want[3])
        assert_close(got[4], want[4])
    # the phantom row's mass never lands
    total = float(np.sum(arrays[0][:, :5]))
    assert abs(float(vec[1].sum()) / experiment._HIST_ONE - total) < 1e-3


def test_reducer_finalize_sums_shards_in_order():
    """Two shards' stats of one fleet sum to the 1-shard stats: the
    histograms to the bit, the sums at rounding; quantiles agree."""
    w, k = 3, 3
    arrays = _reducer_inputs(w, 4, k, seed=1)
    red = api.FleetMetricsReducer(n_cells=3)
    one = red.update_window(red.init(4, 0, CPU), 0,
                            _ys(arrays, slice(None), torch.tensor))
    parts = []
    for row0 in (0, 2):
        sub = tuple(x[:, row0:row0 + 2] for x in arrays)
        parts.append(red.update_window(red.init(2, row0, CPU), 0,
                                       _ys(sub, slice(None), torch.tensor)))
    stack = tuple(torch.stack(x) for x in zip(*parts))
    got = red.finalize(stack)
    want = red.finalize(tuple(x[None] for x in one))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert_close(got[2], want[2])
    assert experiment._hist_quantile(t2n(got[1]), 0.95) == \
        experiment._hist_quantile(t2n(want[1]), 0.95)
