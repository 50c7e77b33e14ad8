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
engine draws from a seeded ``torch.Generator`` on the carry's device.

Checkpointable runs (:func:`resumable_rollout`) split the horizon into
chunks that start on slow-period boundaries; each chunk returns a snapshot
(the telemetry carry and the noise source's position) that, with the
router carry and env state, makes stop-and-resume replay the uninterrupted
run's operations exactly.  The reference's sharded engine is ROADMAP item
A10.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.api.router import Router, RouterObs
from repro_torch.core import mega as mega_mod
from repro_torch.core.fleet import FleetTrace
from repro_torch.envsim.batched import WindowInfo, stack_infos
from repro_torch.kernels.efe import ops as efe_ops
from repro_torch.noise import GeneratorNoise, Noise, get_state, set_state


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

    A mega router builds its own :class:`~repro_torch.core.mega.MegaFleetState`
    sized to the horizon: from nothing when ``carry`` is None or fresh
    (clock at 0), or by promoting a warm dense per-tick carry (see
    :func:`mega_rollout`).

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
        state, est, trace, _ = mega_rollout(
            router, env_state, env_step, n_steps, noise, seed=seed,
            obs_masked=obs_masked, carry=carry)
        return state, est, trace
    if noise is None:
        noise = GeneratorNoise(seed, env_state[0].device)
    period = max(int(router.period), 1)
    clock_phase = (int(t0) % period if t0 is not None
                   else router.clock_phase(carry))
    if obs_masked is None:
        obs_masked = bool(getattr(env_step, "emits_mask", False))
    carry, env_state, trace, _ = _rollout_core(
        router, carry, env_state, env_step, n_steps, noise,
        clock_phase=clock_phase, obs_masked=obs_masked)
    return carry, env_state, trace


def _rollout_core(router: Router, carry, env_state, env_step: Callable,
                  n_steps: int, noise: Noise, *, clock_phase: int | None,
                  obs_masked: bool, t_begin: int = 0, obs_init=None):
    """The per-tick loop over windows ``t_begin .. t_begin + n_steps - 1``
    (global indices: schedules, scrape clock, router ``t_idx`` and noise
    all see them), from the telemetry carry ``obs_init`` (None = fresh).

    Returns (carry, env state, FleetTrace, telemetry carry).
    """
    est0 = env_state[0]
    r, dev = est0.shape[0], est0.device
    k_tiers, m = router.n_tiers, router.n_modalities
    period = max(int(router.period), 1)
    dwell = max(int(router.dwell), 1)
    # Dwell blocking needs the fleet clock phase and, for routers with a
    # slow cadence, a dwell pattern that repeats within each period.
    dwell_blocked = (dwell > 1 and clock_phase is not None
                     and (not router.has_slow or period % dwell == 0))
    phase0 = clock_phase or 0

    raw_obs, tier_util, tier_up, tier_queue, obs_mask = (
        _fresh_obs_carry(r, m, k_tiers, dev) if obs_init is None
        else obs_init)
    ys = []
    for i in range(n_steps):
        t = t_begin + i
        obs = RouterObs(raw_obs=raw_obs, tier_utilization=tier_util,
                        tier_up=tier_up, tier_queue=tier_queue, t_idx=t)
        mask = obs_mask if obs_masked else None
        if dwell_blocked and (phase0 + i) % dwell != 0:
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
                                or (clock_phase + i + 1) % period == 0):
            carry = router.slow_step(carry, noise, t)
        raw_obs, tier_util = win.raw_obs, win.tier_utilization
        tier_up, tier_queue = win.tier_up, win.tier_queue
        if obs_masked:
            obs_mask = win.obs_mask
    return (carry, env_state, _stack_trace(ys),
            (raw_obs, tier_util, tier_up, tier_queue, obs_mask))


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
                 n_total: int | None = None,
                 t_begin: int = 0,
                 state_in: mega_mod.MegaFleetState | None = None,
                 obs_carry=None,
                 carry=None):
    """Whole-window engine path of a ``mega`` router.

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
        stops early, or runs in chunks, sizes them to its whole horizon.
      t_begin / state_in / obs_carry: a later chunk of a chunked run (see
        :func:`resumable_rollout`): its first global tick (a slow-period
        boundary), the previous chunk's state and telemetry carry.
      carry: the router carry when ``state_in`` is None: None or a fresh
        carry starts a fresh fleet; a warm dense per-tick
        :class:`~repro_torch.core.agent.AgentState` whose uniform clock
        sits on a slow-period and dwell boundary is *promoted* onto the
        mega path (:func:`~repro_torch.core.mega.init_mega_state`'s
        ``from_agent_state``: its dense transition counts become the
        ``b_base`` baseline).  The run then covers ticks ``[t_warm, t_warm
        + n_steps)`` of the same world, so the env schedules and the noise
        are indexed globally, and the slots are sized to ``t_warm +
        n_total``.  Warm promotion cannot be combined with ``t_begin``.

    Fault schedules (``forced_down``/``speed``) and a fleet graph ride
    along: each window takes its slice of the schedules and the graph's
    edge tensors, and on a graph world the telemetry carry is five
    columns wide (the neighbor pressure).

    Returns (state, env state, FleetTrace, obs_carry).
    """
    fl = getattr(env_step, "fluid", None)
    if fl is None:
        raise ValueError(
            "mega rollouts need the env adapter's whole-window ingredients "
            "(env_step.fluid, set by repro_torch.envsim.batched."
            "make_env_step); rebuild the adapter or set mega=False")
    if n_steps < 1:
        raise ValueError("mega rollouts need n_steps >= 1")
    cfg = router.cfg
    est0 = env_state[0]
    r, dev = est0.shape[0], est0.device
    period = max(int(router.period), 1)
    if noise is None:
        noise = GeneratorNoise(seed, dev)
    if obs_masked is None:
        obs_masked = bool(getattr(env_step, "emits_mask", False))
    warm = 0 if state_in is not None else _warm_clock(router, carry)
    if warm:
        if t_begin:
            raise ValueError("warm promotion and a resumable t_begin "
                             "cannot be combined")
        if fl.arrival_rate.shape[0] < warm + n_steps:
            raise ValueError(
                f"warm mega promotion indexes the env schedules globally "
                f"(same world): need at least {warm + n_steps} scheduled "
                f"ticks, got {fl.arrival_rate.shape[0]}; build the env_step "
                f"over the whole run's schedules")
        t_begin = warm
    if state_in is None:
        horizon = n_steps if n_total is None else int(n_total)
        state = mega_mod.init_mega_state(
            cfg, r, warm + horizon, router.slot_dtype, dev,
            from_agent_state=carry if warm else None)
    else:
        state = state_in
    if t_begin + n_steps > state.slots.action.shape[1]:
        raise ValueError(
            f"ticks up to {t_begin + n_steps} do not fit the state's "
            f"{state.slots.action.shape[1]} slots: size the first chunk "
            f"with the whole horizon (n_total)")
    statics = dict(cfg=cfg, disc=router.resolved_disc,
                   util_edges=router.resolved_util_edges,
                   util_period=router.util_period, dt=fl.dt,
                   scrape_every=fl.scrape_every,
                   restart_blackout=fl.restart_blackout,
                   emits_mask=obs_masked)
    est = env_state
    obs = (_fresh_obs_carry(r, router.n_modalities, router.n_tiers, dev)
           if obs_carry is None else obs_carry)
    traces = []
    for t_start in range(t_begin, t_begin + n_steps, period):
        w = min(period, t_begin + n_steps - t_start)
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
        env=WindowInfo(*(None if f[0] is None else torch.cat(f)
                         for f in zip(*win))),
        watchdog=torch.cat(wd))
    return state, est, trace, obs


def _warm_clock(router, carry) -> int:
    """The fleet clock of a warm dense carry to promote onto the mega path
    (0 for None or a fresh carry).  It must be uniform and sit on a
    slow-period and dwell boundary."""
    t = getattr(carry, "t", None)
    if t is None or not bool(torch.any(t != 0)):
        return 0
    if isinstance(carry, mega_mod.MegaFleetState):
        raise ValueError(
            "a warm MegaFleetState cannot seed a new rollout (its slots were "
            "sized for the previous horizon): densify it with "
            "repro_torch.core.mega.to_agent_state and pass the dense carry, "
            "which is promoted again at the new size")
    vals = torch.unique(t)
    if vals.numel() != 1:
        raise ValueError(f"warm mega promotion needs a uniform fleet clock; "
                         f"got t in {vals[:8].tolist()}")
    warm = int(vals[0])
    period = max(int(router.period), 1)
    dwell = max(int(router.dwell), 1)
    if warm % period or warm % dwell:
        raise ValueError(
            f"warm mega promotion must start on a slow-period and dwell "
            f"boundary (t % {period} == 0 and % {dwell} == 0), got t={warm}")
    return warm


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

    def window(x):
        return None if x is None else x[sl]

    state, est, obs, ys = efe_ops.mega_window(
        state, est, obs, fl.params, fl.arrival_rate[sl], fl.hazard_scale[sl],
        window(fl.obs_valid), uniforms, gumbel, t_start,
        forced_down=window(fl.forced_down), speed=window(fl.speed),
        graph=fl.graph, **statics)
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


# ------------------------------------------------------- checkpointed chunks
def _check_boundary(router: Router, t_begin: int) -> None:
    period = max(int(router.period), 1)
    dwell = max(int(router.dwell), 1)
    if t_begin % period or t_begin % dwell:
        raise ValueError(
            f"resumable chunks must start on a slow-period and dwell "
            f"boundary (t_begin % {period} == 0 and % {dwell} == 0), got "
            f"t_begin={t_begin}; pick checkpoint_every as a multiple of "
            f"the router's period")


def resumable_rollout(router: Router,
                      carry,
                      env_state,
                      env_step: Callable,
                      n_steps: int,
                      noise: Noise | None = None,
                      *,
                      seed: int = 0,
                      t_begin: int = 0,
                      snapshot=None,
                      obs_masked: bool | None = None,
                      n_total: int | None = None):
    """One chunk of a checkpointable rollout: ticks [t_begin, t_begin + n).

    The chunked twin of :func:`rollout` (per-tick and mega paths).  A fresh
    run is chunk 0 (``t_begin=0, snapshot=None``); every later chunk passes
    the snapshot the previous chunk returned: the telemetry carry
    ``(raw_obs, tier_util, tier_up, tier_queue, obs_mask)`` and the noise
    source's position (:func:`repro_torch.noise.get_state`; a CPU tensor
    for a generator, None for a source indexed by tick).  With the router
    carry and env state it makes stop-and-resume replay the uninterrupted
    run's operations exactly, so the final states are equal to the bit.
    ``noise`` None draws from a generator seeded with ``seed`` and, on a
    later chunk, moved to the snapshot's position.

    Chunks start on a slow-period (and dwell) boundary, so the fleet
    clock's phase is zero.  For ``mega`` routers chunk 0 takes ``n_total``
    (the whole horizon) so the slots are sized once, and a later chunk's
    ``carry`` is the previous chunk's
    :class:`~repro_torch.core.mega.MegaFleetState`; chunk 0's is None, a
    fresh carry, or a warm dense carry to promote (see
    :func:`mega_rollout`).

    Returns (router carry, env state, trace of this chunk, snapshot).
    """
    _check_boundary(router, t_begin)
    if (t_begin == 0) != (snapshot is None):
        raise ValueError(
            "chunk 0 (t_begin=0) takes snapshot=None; resumed chunks "
            "(t_begin>0) need the previous chunk's snapshot")
    if noise is None:
        noise = GeneratorNoise(seed, env_state[0].device)
    obs_init = None
    if snapshot is not None:
        obs_init, noise_state = tuple(snapshot[0]), snapshot[1]
        set_state(noise, noise_state)
    if getattr(router, "mega", False):
        state, est, trace, obs_out = mega_rollout(
            router, env_state, env_step, n_steps, noise,
            obs_masked=obs_masked, n_total=n_total, t_begin=t_begin,
            state_in=None if snapshot is None else carry,
            obs_carry=obs_init, carry=carry if snapshot is None else None)
        return state, est, trace, (obs_out, get_state(noise))
    if obs_masked is None:
        obs_masked = bool(getattr(env_step, "emits_mask", False))
    carry, est, trace, obs_out = _rollout_core(
        router, carry, env_state, env_step, n_steps, noise, clock_phase=0,
        obs_masked=obs_masked, t_begin=t_begin, obs_init=obs_init)
    return carry, est, trace, (obs_out, get_state(noise))
