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

Routers with ``mega`` set run the whole-window engine instead
(:func:`mega_rollout`): one fused window of ``period`` ticks per launch
(:func:`repro_torch.kernels.efe.ops.mega_window`), each followed by the
slow step and the window-granularity watchdog.

Randomness comes from ``noise`` (:mod:`repro_torch.noise`); without one the
engine draws from a seeded ``torch.Generator`` on the carry's device.  The
reference's sharded and resumable engines are ROADMAP items A10 and A8.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.api.router import Router, RouterObs
from repro_torch.core import mega as mega_mod
from repro_torch.core.fleet import FleetTrace
from repro_torch.envsim.batched import WindowInfo, stack_infos
from repro_torch.kernels.efe import ops as efe_ops
from repro_torch.noise import GeneratorNoise, Noise


def _fresh_obs_carry(r: int, m: int, k: int, device: torch.device):
    """(raw_obs, tier_util, tier_up, tier_queue, obs_mask) before tick 0."""
    return (torch.zeros((r, m), device=device),
            torch.zeros((r, k), device=device),
            torch.ones((r, k), device=device),
            torch.zeros((r, k), device=device),
            torch.ones((r, m), device=device))


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

    A mega router owns its carry: ``carry`` must be None or fresh (clock at
    0), and the engine builds a :class:`~repro_torch.core.mega.MegaFleetState`
    sized to the horizon.

    Returns:
      (final carry, final env state, :class:`~repro_torch.core.fleet.FleetTrace`).
    """
    if n_steps < 1:
        raise ValueError("rollout needs n_steps >= 1")
    if getattr(router, "mega", False):
        if t0 not in (None, 0):
            raise ValueError(
                f"mega rollouts start on a fresh fleet clock (t0=0), got "
                f"t0={t0}: transition slots are indexed by the global tick")
        t = getattr(carry, "t", None)
        if t is not None and bool(torch.any(t != 0)):
            if isinstance(carry, mega_mod.MegaFleetState):
                raise ValueError(
                    "a warm MegaFleetState cannot seed a new rollout: its "
                    "slots were sized for the previous horizon")
            raise NotImplementedError(
                "promoting a warm dense carry onto the mega path is not "
                "ported yet: ROADMAP item A14")
        state, est, trace, _ = mega_rollout(
            router, env_state, env_step, n_steps, noise, seed=seed,
            obs_masked=obs_masked)
        return state, est, trace
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

    raw_obs, tier_util, tier_up, tier_queue, obs_mask = _fresh_obs_carry(
        r, m, k_tiers, dev)
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


# ------------------------------------------------------------ mega engine
def mega_rollout(router,
                 env_state,
                 env_step: Callable,
                 n_steps: int,
                 noise: Noise | None = None,
                 *,
                 seed: int = 0,
                 obs_masked: bool | None = None,
                 n_total: int | None = None):
    """Whole-window engine path of a ``mega`` router, on a fresh fleet.

    Full ``period``-tick windows, each one launch of
    :func:`repro_torch.kernels.efe.ops.mega_window` followed by
    :func:`~repro_torch.core.mega.mega_slow_step` and the watchdog, then a
    remainder window without a slow step.  Per window the noise block is
    one ``noise.gumbel(t, (R, A))`` and one ``noise.env_uniforms(t, (R, K))``
    for every tick ``t`` (held ticks included, as the reference's key
    block draws them) and, at the boundary, ``noise.replay_indices`` at
    the window's last tick.

    Args:
      router: an :class:`~repro_torch.api.aif.AifRouter` with ``mega``.
      env_state / env_step: as for :func:`rollout`; ``env_step`` must carry
        the :class:`~repro_torch.envsim.batched.FluidIngredients` of
        :func:`~repro_torch.envsim.batched.make_env_step` as ``.fluid``.
      n_total: slots of the fresh state (default ``n_steps``): a run that
        stops early to inspect its state sizes them to its whole horizon.

    Returns (state, env state, FleetTrace, obs_carry).
    """
    fl = getattr(env_step, "fluid", None)
    if fl is None:
        raise ValueError(
            "mega rollouts need the env adapter's whole-window ingredients "
            "(env_step.fluid, set by repro_torch.envsim.batched."
            "make_env_step); rebuild the adapter or set mega=False")
    n_slots = n_steps if n_total is None else int(n_total)
    if not 1 <= n_steps <= n_slots:
        raise ValueError(f"mega rollouts need 1 <= n_steps <= n_total, got "
                         f"{n_steps} and {n_slots}")
    cfg = router.cfg
    est0 = env_state[0]
    r, dev = est0.shape[0], est0.device
    period = max(int(router.period), 1)
    if noise is None:
        noise = GeneratorNoise(seed, dev)
    if obs_masked is None:
        obs_masked = bool(getattr(env_step, "emits_mask", False))
    slot_dtype = (torch.bfloat16 if router.mega_slot_dtype == "bfloat16"
                  else torch.float32)
    state = mega_mod.init_mega_state(cfg, r, n_slots, slot_dtype, dev)
    statics = dict(cfg=cfg, disc=router.resolved_disc,
                   util_edges=router.resolved_util_edges,
                   util_period=router.util_period, dt=fl.dt,
                   scrape_every=fl.scrape_every,
                   restart_blackout=fl.restart_blackout,
                   emits_mask=obs_masked)
    est = env_state
    obs = _fresh_obs_carry(r, router.n_modalities, router.n_tiers, dev)
    traces = []
    for t_start in range(0, n_steps, period):
        w = min(period, n_steps - t_start)
        state, est, obs, ys = _mega_window(state, est, obs, fl, noise,
                                           t_start, w, do_slow=(w == period),
                                           statics=statics)
        traces.append(ys)
    actions, weights, raw_obs, unstable, obs_frac, win, wd = (
        list(xs) for xs in zip(*traces))
    trace = FleetTrace(
        actions=torch.cat(actions), routing_weights=torch.cat(weights),
        raw_obs=torch.cat(raw_obs), unstable=torch.cat(unstable),
        obs_frac=torch.cat(obs_frac),
        env=WindowInfo(*(torch.cat(f) for f in zip(*win))),
        watchdog=torch.cat(wd))
    return state, est, trace, obs


def _mega_window(state, est, obs, fl, noise, t_start: int, w_ticks: int, *,
                 do_slow: bool, statics: dict):
    """One window: the noise block, the fused launch, then (at a period
    boundary) the slow step, then the watchdog on the window's result."""
    cfg = statics["cfg"]
    r, k = state.belief.shape[0], fl.params.n_tiers
    dev = state.belief.device
    ticks = range(t_start, t_start + w_ticks)
    gumbel = torch.stack([noise.gumbel(t, (r, cfg.n_actions))
                          for t in ticks]).to(dev)
    uniforms = torch.stack([torch.stack(noise.env_uniforms(t, (r, k)))
                            for t in ticks]).to(dev)
    sl = slice(t_start, t_start + w_ticks)
    state, est, obs, ys = efe_ops.mega_window(
        state, est, obs, fl.params, fl.arrival_rate[sl], fl.hazard_scale[sl],
        None if fl.obs_valid is None else fl.obs_valid[sl], uniforms, gumbel,
        t_start, **statics)
    if do_slow:
        size = torch.clamp(state.t, max=state.slots.action.shape[1])
        idx = noise.replay_indices(t_start + w_ticks - 1, size,
                                   cfg.replay_batch).to(dev)
        state = mega_mod.mega_slow_step(state, idx, cfg)
    events = torch.zeros((w_ticks, r), device=dev)
    if cfg.watchdog:
        bad = mega_mod.mega_watchdog_bad(state)
        if bool(bad.any()):
            state = mega_mod.mega_quarantine(state, bad, cfg)
        events[-1] = bad.to(torch.float32)
    return state, est, obs, ys + (events,)
