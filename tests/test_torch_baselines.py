"""The six baselines of the paper's comparison, step by step against the
reference's routers of the same names (mirrors ``tests/test_api.py``'s
parity rows: each router's weights and actions, least-loaded's fallback
when every tier is down, UCB exactly, Thompson with matched draws, the
engine deterministic for bandits).

Both sides step on the same random observations; the Thompson noise is
handed to the port as ``noise.normal``.  Reference carries cross over with
``torch_port_ref.bandit_carry_to_port``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.api.router import RouterObs as RefObs
from repro.envsim import SimConfig as RefSimConfig
from repro_torch import api
from repro_torch.envsim import SimConfig, batched, scenarios
from torch_port_ref import (JaxChainNoise, assert_close, assert_tree_close,
                            bandit_carry_to_port, t2n)

K = 3


@pytest.fixture(autouse=True)
def _r1_prng_mode():
    with jax.threefry_partitionable(False):
        yield


def random_obs(rng, r, t_idx, all_down=False):
    """One tick's observation on both sides: (port, reference)."""
    raw = np.zeros((r, 4), np.float32)
    raw[:, 0] = rng.uniform(0.0, 8.0, r)                  # p95_s
    raw[:, 1] = rng.uniform(0.0, 60.0, r)                 # rps
    raw[:, 2] = rng.uniform(0.0, 100.0, r)                # queue
    raw[:, 3] = rng.uniform(0.0, 0.5, r)                  # err
    queue = rng.uniform(0.0, 50.0, (r, K)).astype(np.float32)
    up = (rng.random((r, K)) > 0.25).astype(np.float32)
    if all_down:
        up[:] = 0.0
    util = rng.uniform(0.0, 1.0, (r, K)).astype(np.float32)
    port = api.RouterObs(raw_obs=torch.tensor(raw),
                         tier_utilization=torch.tensor(util),
                         tier_up=torch.tensor(up),
                         tier_queue=torch.tensor(queue), t_idx=t_idx)
    ref = RefObs(raw_obs=jnp.asarray(raw), tier_utilization=jnp.asarray(util),
                 tier_up=jnp.asarray(up), tier_queue=jnp.asarray(queue),
                 t_idx=jnp.asarray(t_idx, jnp.int32))
    return port, ref


def pair(name):
    """(port router, reference router) built by the two registries."""
    from repro_torch.core.topology import default_topology
    from repro.core.topology import default_topology as ref_default
    return (api.ROUTERS[name](default_topology(), SimConfig(), True, False),
            ref_api.ROUTERS[name](ref_default(), RefSimConfig(), False,
                                  False))


class StepNoise:
    """``normal(t, (R, A))`` from the reference's per-cell keys of tick t."""

    def __init__(self, keys):
        self.keys = keys

    def normal(self, t, shape):
        e = jax.vmap(lambda k: jax.random.normal(k, (shape[-1],)))(
            self.keys[t])
        return torch.tensor(np.asarray(e))


def run_steps(name, r, n, seed, carry_from=None, all_down=False):
    """``n`` ticks of router ``name`` on both sides from the same carry;
    asserts weights and actions equal each tick.  Returns both carries."""
    port, ref = pair(name)
    rng = np.random.default_rng(seed)
    keys = [jax.random.split(jax.random.key(seed * 100 + t), r)
            for t in range(n)]
    noise = StepNoise(keys)
    ref_step = jax.jit(ref.step)
    c_ref = ref.init_carry(r) if carry_from is None else carry_from
    c_port = (port.init_carry(r, "cpu") if carry_from is None
              else bandit_carry_to_port(carry_from))
    for t in range(n):
        obs_p, obs_r = random_obs(rng, r, t, all_down)
        c_port, w_p, info_p = port.step(c_port, obs_p, None, noise)
        c_ref, w_r, info_r = ref_step(c_ref, obs_r, None, keys[t])
        np.testing.assert_array_equal(t2n(info_p.action),
                                      np.asarray(info_r.action),
                                      err_msg=f"{name} t={t}")
        assert_close(w_p, w_r, atol=1e-6, err_msg=f"{name} t={t}")
        assert not bool(info_p.unstable.any())
    return c_port, c_ref


@pytest.mark.parametrize("name", ["uniform", "capacity", "round_robin",
                                  "least_loaded", "nn_offload", "thompson",
                                  "ucb"])
def test_router_steps_match_reference(name):
    c_port, c_ref = run_steps(name, r=4, n=25, seed=3)
    if not isinstance(c_ref, tuple) or c_ref:
        assert_tree_close(c_port, c_ref, path=name)


@pytest.mark.parametrize("name", ["least_loaded", "nn_offload"])
def test_all_tiers_down_falls_back_uniform(name):
    port, _ = pair(name)
    obs, _ = random_obs(np.random.default_rng(0), 2, 0, all_down=True)
    _, w, _ = port.step(port.init_carry(2, "cpu"), obs, None, None)
    np.testing.assert_allclose(t2n(w), np.full((2, K), 1 / K), atol=1e-6)
    run_steps(name, r=2, n=3, seed=5, all_down=True)


def test_ucb_parity_exact():
    """UCB1 is deterministic: the same observations give the same arm
    trajectory and, to the bit, the same pull counts."""
    c_port, c_ref = run_steps("ucb", r=2, n=30, seed=11)
    np.testing.assert_array_equal(t2n(c_port.counts),
                                  np.asarray(c_ref.counts))
    np.testing.assert_array_equal(t2n(c_port.t), np.asarray(c_ref.t))
    assert_close(c_port.sums, c_ref.sums, rtol=1e-5)


def test_thompson_parity_matched_draws():
    """With the draws matched, Thompson sampling is deterministic too: the
    posterior tables and the arm trajectory agree."""
    c_port, c_ref = run_steps("thompson", r=3, n=25, seed=5)
    assert_close(c_port.mu, c_ref.mu, rtol=1e-5)
    assert_close(c_port.var, c_ref.var, rtol=1e-5)


@pytest.mark.parametrize("name", ["thompson", "ucb", "round_robin"])
def test_reference_carry_carries_across(name):
    """A reference carry after 10 ticks, converted, steps on with the
    reference."""
    _, warm = run_steps(name, r=3, n=10, seed=7)
    c_port, c_ref = run_steps(name, r=3, n=10, seed=8, carry_from=warm)
    assert_tree_close(c_port, c_ref, path=name)


def test_engine_deterministic_for_bandits():
    r, t = 2, 20
    router = api.ThompsonRouter()
    scfg = SimConfig()
    outs = []
    for _ in range(2):
        sc = scenarios.build_scenario("paper-burst", scfg, r, t)
        params = batched.params_from_config(scfg, r, sc.capacity_scale,
                                            device="cpu")
        env_step = batched.make_scenario_env_step(params, sc)
        _, est, trace = api.rollout(router, router.init_carry(r, "cpu"),
                                    batched.init_fluid_state(params),
                                    env_step, t, seed=3)
        outs.append((t2n(trace.actions), t2n(est.n_success)))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])


def test_bandit_rollout_matches_reference_engine():
    """Both bandits through the engine's flat path on a masked world."""
    r, t, seed = 3, 25, 2
    for name in ("thompson", "ucb"):
        port, ref = pair(name)
        ref_res = ref_api.run(ref_api.Experiment(
            router=ref, scenario="flaky-telemetry", n_cells=r, n_windows=t,
            seed=seed))
        res = api.run(api.Experiment(router=port, scenario="flaky-telemetry",
                                     n_cells=r, n_windows=t, seed=seed,
                                     device="cpu"),
                      noise=JaxChainNoise(seed, r, t))
        np.testing.assert_array_equal(t2n(res.trace.actions),
                                      np.asarray(ref_res.trace.actions))
        assert_tree_close(res.final_carry, ref_res.final_carry, path=name)
        assert_close(res.success_pct, ref_res.success_pct)


def test_router_checks_and_shapes():
    with pytest.raises(ValueError, match="cap_rps"):
        api.MinResponseRouter(service_s=(0.1, 0.2), cap_rps=(1.0,))
    assert api.CapacityRouter().n_tiers == 3
    assert api.UniformRouter(extra_modalities=1).n_modalities == 5
    c = api.UcbRouter().init_carry(4, "cpu")
    assert tuple(c.counts.shape) == (4, 20) and c.t.dtype == torch.int64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            api.ThompsonRouter().init_carry(2)
