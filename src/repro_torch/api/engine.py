"""Closed-loop fleet engine over the Router protocol.

Each of the ``n_steps`` control windows hands the previous window's
telemetry to the router, applies the returned (R, K) routing weights to the
environment and carries the new observations forward.  The reference runs
this as a nested ``lax.scan``; here it is a Python loop with the same
schedule:

* routers with a slow cadence (``has_slow``) learn once per slow period,
  after the boundary tick, with that tick's draws;
* with an action dwell > 1, held ticks (``t % dwell != 0`` on the fleet
  clock) go to ``router.light_step``, so the EFE runs only on selecting
  ticks;
* mixed per-cell clocks fall back to a full step and a per-cell-gated slow
  step every tick.

Telemetry degradation: when ``env_step.emits_mask`` is set (or
``obs_masked=True``), each window's validity mask is carried into the next
tick's ``obs_mask`` and the trace records the effective-observation
fraction.

Randomness comes from ``noise`` (:mod:`repro_torch.noise`); without one the
engine draws from a seeded ``torch.Generator`` on the carry's device.  The
reference's mega, sharded and resumable engines are ROADMAP items A7, A10
and A8.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.api.router import Router, RouterObs
from repro_torch.core.fleet import FleetTrace
from repro_torch.envsim.batched import stack_infos
from repro_torch.noise import GeneratorNoise, Noise


def rollout(router: Router,
            carry,
            env_state,
            env_step: Callable,
            n_steps: int,
            noise: Noise | None = None,
            *,
            seed: int = 0,
            obs_masked: bool | None = None,
            t0: int | None = None):
    """Closed-loop fleet experiment.

    Args:
      router: router spec (see :mod:`repro_torch.api.router`).
      carry: the router's state (``router.init_carry(r, device)`` or a
        previous rollout's final carry), leading cell axis R.  The AIF carry
        is updated in place where its docstrings say so: reuse the returned
        state, not the argument.
      env_state: environment state with leading cell dim R.
      env_step: ``(env_state, weights, t_idx, uniforms) -> (env_state,
        info)`` (see :func:`repro_torch.envsim.batched.make_env_step`).
      n_steps: number of control windows T.
      noise: source of every random draw; None draws from a
        :class:`~repro_torch.noise.GeneratorNoise` seeded with ``seed``.
      obs_masked: force (True) / suppress (False) the telemetry-mask carry;
        None reads ``env_step.emits_mask``.
      t0: fast ticks already elapsed on every cell's clock; None asks
        ``router.clock_phase(carry)``.

    Returns:
      (final carry, final env state, :class:`~repro_torch.core.fleet.FleetTrace`).
    """
    if n_steps < 1:
        raise ValueError("rollout needs n_steps >= 1")
    est0 = env_state[0]
    r, dev = est0.shape[0], est0.device
    k_tiers, m = router.n_tiers, router.n_modalities
    if noise is None:
        noise = GeneratorNoise(seed, dev)
    period = max(int(router.period), 1)
    dwell = max(int(router.dwell), 1)
    clock_phase = (int(t0) % period if t0 is not None
                   else router.clock_phase(carry))
    if obs_masked is None:
        obs_masked = bool(getattr(env_step, "emits_mask", False))
    # Dwell blocking needs the fleet clock phase and, for routers with a
    # slow cadence, a dwell pattern that repeats within each period.
    dwell_blocked = (dwell > 1 and clock_phase is not None
                     and (not router.has_slow or period % dwell == 0))
    phase0 = clock_phase or 0

    raw_obs = torch.zeros((r, m), device=dev)
    tier_util = torch.zeros((r, k_tiers), device=dev)
    tier_up = torch.ones((r, k_tiers), device=dev)
    tier_queue = torch.zeros((r, k_tiers), device=dev)
    obs_mask = torch.ones((r, m), device=dev)
    ys = []
    for t in range(n_steps):
        obs = RouterObs(raw_obs=raw_obs, tier_utilization=tier_util,
                        tier_up=tier_up, tier_queue=tier_queue, t_idx=t)
        mask = obs_mask if obs_masked else None
        if dwell_blocked and (phase0 + t) % dwell != 0:
            carry, weights, tinfo = router.light_step(carry, obs, mask)
        else:
            carry, weights, tinfo = router.step(carry, obs, mask, noise)
        env_state, win = env_step(env_state, weights, t,
                                  noise.env_uniforms(t, (r, k_tiers)))
        ys.append(FleetTrace(actions=tinfo.action,
                             routing_weights=weights,
                             raw_obs=raw_obs,
                             unstable=tinfo.unstable,
                             obs_frac=torch.mean(obs_mask, dim=-1),
                             env=win,
                             watchdog=tinfo.watchdog))
        if router.has_slow and (clock_phase is None
                                or (clock_phase + t + 1) % period == 0):
            carry = router.slow_step(carry, noise, t)
        raw_obs, tier_util = win.raw_obs, win.tier_utilization
        tier_up, tier_queue = win.tier_up, win.tier_queue
        if obs_masked:
            obs_mask = win.obs_mask
    return carry, env_state, _stack_trace(ys)


def _stack_trace(ys: list[FleetTrace]) -> FleetTrace:
    def stack(xs):
        return None if xs[0] is None else torch.stack(xs)

    return FleetTrace(
        actions=stack([y.actions for y in ys]),
        routing_weights=stack([y.routing_weights for y in ys]),
        raw_obs=stack([y.raw_obs for y in ys]),
        unstable=stack([y.unstable for y in ys]),
        obs_frac=stack([y.obs_frac for y in ys]),
        env=stack_infos([y.env for y in ys]),
        watchdog=stack([y.watchdog for y in ys]))
