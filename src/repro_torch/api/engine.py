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
run's operations exactly.

Device sharding (:func:`sharded_rollout`): the fleet's padded cell axis is
cut into row blocks, one a shard, each on its device
(:mod:`repro_torch.api.shard`).  One host loop drives them all, ticks (or
windows) outside and shards inside, so a graph tick's exchange is one
gather between the shards.  Every draw is made at the true R and each
shard takes its rows (:class:`repro_torch.noise.RowBlockNoise`), and the
per-tick trace is replaced by a reducer's O(R) stats
(:class:`repro_torch.api.experiment.FleetMetricsReducer`), summed over the
shards in shard order at the end.  One shard reproduces the unsharded
engine to the bit.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.api import shard as shard_mod
from repro_torch.api.router import Router, RouterObs
from repro_torch.core import mega as mega_mod
from repro_torch.core.fleet import FleetTrace
from repro_torch.envsim.batched import WindowInfo, stack_infos
from repro_torch.kernels.efe import ops as efe_ops
from repro_torch.noise import (GeneratorNoise, Noise, RowBlockNoise,
                               get_state, set_state)


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


def _window_noise(noise, t_start: int, w_ticks: int, r: int, a_n: int,
                  k: int, dev: torch.device):
    """A window's noise block: (W, R, A) Gumbel noise, then (W, 2, R, K)
    restart uniforms, drawn tick by tick."""
    ticks = range(t_start, t_start + w_ticks)
    gumbel = torch.stack([noise.gumbel(t, (r, a_n)) for t in ticks]).to(dev)
    uniforms = torch.stack([torch.stack(noise.env_uniforms(t, (r, k)))
                            for t in ticks]).to(dev)
    return gumbel, uniforms


def _window_slices(fl, t_start: int, w_ticks: int) -> tuple:
    """A window's (params, arrival, hazard, obs_valid) and its keyword
    operands (the fault schedules' slices, the graph), as ``mega_window``
    takes them."""
    sl = slice(t_start, t_start + w_ticks)

    def window(x):
        return None if x is None else x[sl]

    return ((fl.params, fl.arrival_rate[sl], fl.hazard_scale[sl],
             window(fl.obs_valid)),
            dict(forced_down=window(fl.forced_down), speed=window(fl.speed),
                 graph=fl.graph))


def _mega_window(state, est, obs, fl, noise, t_start: int, w_ticks: int, *,
                 do_slow: bool, statics: dict):
    """One window: the noise block, the fused launch, then (at a period
    boundary) the slow step, then the watchdog on the window's result."""
    cfg = statics["cfg"]
    gumbel, uniforms = _window_noise(
        noise, t_start, w_ticks, state.belief.shape[0], cfg.n_actions,
        fl.params.n_tiers, state.belief.device)
    args, kw = _window_slices(fl, t_start, w_ticks)
    state, est, obs, ys = efe_ops.mega_window(
        state, est, obs, *args, uniforms, gumbel, t_start, **kw, **statics)
    state, events = _window_after(state, noise, t_start, w_ticks,
                                  do_slow=do_slow, cfg=cfg)
    return state, est, obs, ys + (events,)


def _window_after(state, noise, t_start: int, w_ticks: int, *,
                  do_slow: bool, cfg):
    """The slow step at a period boundary (replay drawn at the window's
    last tick), then the watchdog.  Returns (state, (W, R) events)."""
    r, dev = state.belief.shape[0], state.belief.device
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
    return state, events


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


# ------------------------------------------------------------ device sharding
def sharded_rollout(router: Router,
                    env_state,
                    env_step: Callable,
                    n_steps: int,
                    noise: Noise | None = None,
                    *,
                    shard,
                    n_cells: int,
                    reducer,
                    seed: int = 0,
                    obs_masked: bool | None = None,
                    mesh: list | None = None):
    """:func:`rollout` over the row blocks of a sharded fleet.

    The padded cell axis is cut into one block of ``R_pad / D`` rows per
    shard, each on its device.  The router carry is initialized per shard;
    each tick (per-tick path) or window (mega path) runs every shard in
    shard order: the router steps with the shard's view of the noise
    (:class:`~repro_torch.noise.RowBlockNoise`: every draw made once at
    the true R), the env steps every block at once
    (``env_step.step_blocks``: on a graph, one exchange between them), and
    each shard's reducer stats take the tick.  A mega router runs kernel
    B3 on each block (:func:`repro_torch.kernels.efe.ops.mega_window_blocks`;
    on a graph, launch by launch across the blocks).  The per-tick trace
    is replaced by ``reducer``'s stats, so memory stays O(R).

    Args:
      router: router spec; its ``init_carry`` is deterministic in its cell
        count.
      env_state: env state **padded** to the shard count's multiple
        (leading dim ``shard.padded(n_cells, ...)[0]`` on every leaf; see
        :func:`repro_torch.envsim.scenarios.pad_scenario`).
      env_step: a shard-aware adapter (``env_step.supports_shard``), e.g.
        :func:`repro_torch.envsim.batched.make_env_step`.
      n_steps: horizon T.
      noise: the run's noise; None draws from a generator seeded with
        ``seed`` on the env state's device.
      shard: a :class:`repro_torch.api.shard.ShardSpec`.
      n_cells: the *true* fleet size R.
      reducer: stats accumulator with ``init(r_local, row0, device)``,
        ``update(stats, t, trace_tick)``, ``update_window(stats, t0,
        trace_window)`` and ``finalize(stacked_stats)``, e.g.
        :class:`repro_torch.api.experiment.FleetMetricsReducer`.
      obs_masked: as for :func:`rollout`.
      mesh: the shards' devices, overriding ``shard.build_mesh``:
        ``[device] * D`` lays D shards on one device.

    Returns:
      (router carry, env state, reduced stats): the carry and the env
      state gathered along the padded cell axis on the env state's device,
      the stats summed over the shards in shard order.  With one shard the
      carry and env state equal the unsharded engine's to the bit.
    """
    carry, est, stats, _ = _sharded_chunk(
        router, None, env_state, env_step, n_steps, noise, shard=shard,
        n_cells=n_cells, reducer=reducer, seed=seed, obs_masked=obs_masked,
        mesh=mesh, t_begin=0, snapshot=None, n_total=None)
    return carry, est, reducer.finalize(stats)


def sharded_resumable_rollout(router: Router,
                              carry,
                              env_state,
                              env_step: Callable,
                              n_steps: int,
                              noise: Noise | None = None,
                              *,
                              shard,
                              n_cells: int,
                              reducer,
                              seed: int = 0,
                              t_begin: int = 0,
                              snapshot=None,
                              obs_masked: bool | None = None,
                              n_total: int | None = None,
                              mesh: list | None = None):
    """One chunk of a checkpointable :func:`sharded_rollout`.

    The contract of :func:`resumable_rollout` on the sharded engine, the
    per-tick and the mega path.  The snapshot is ``(telemetry carry, raw
    stats, noise position)``: the telemetry gathered along the padded
    cell axis, the reducer's unreduced stats stacked with a leading shard
    axis, and the noise source's position.  ``carry`` is the gathered
    router carry (chunk 0 ignores it: each shard starts its own rows
    fresh); for a mega router chunk 0 takes ``n_total``, the whole
    horizon.  The returned stats are raw; :func:`sharded_finalize` of the
    last chunk's equals :func:`sharded_rollout`'s reduction of the
    uninterrupted run.

    Returns (router carry, env state, raw stats, snapshot).
    """
    _check_boundary(router, t_begin)
    if (t_begin == 0) != (snapshot is None):
        raise ValueError(
            "chunk 0 (t_begin=0) takes snapshot=None; resumed chunks "
            "(t_begin>0) need the previous chunk's snapshot")
    return _sharded_chunk(
        router, carry, env_state, env_step, n_steps, noise, shard=shard,
        n_cells=n_cells, reducer=reducer, seed=seed, obs_masked=obs_masked,
        mesh=mesh, t_begin=t_begin, snapshot=snapshot, n_total=n_total)


def sharded_finalize(stats, *, shard, reducer):
    """The reduction of a chunked run's raw stats (see
    :func:`sharded_resumable_rollout`): the shards' stats summed in shard
    order, equal to what :func:`sharded_rollout` returns for the
    uninterrupted run."""
    return reducer.finalize(stats)


def _sharded_chunk(router, carry, env_state, env_step, n_steps, noise, *,
                   shard, n_cells, reducer, seed, obs_masked, mesh, t_begin,
                   snapshot, n_total):
    if not getattr(env_step, "supports_shard", False):
        raise ValueError(
            "env_step does not advertise supports_shard=True: sharded "
            "rollouts need a row_block-aware adapter (see "
            "repro_torch.envsim.batched.make_env_step); rebuild the closure "
            "instead of sharding a schedule-blind one")
    if n_steps < 1:
        raise ValueError("sharded rollouts need n_steps >= 1")
    dev = env_state[0].device
    mesh = (shard.build_mesh(dev) if mesh is None
            else [torch.device(d) for d in mesh])
    r_pad, r_local = shard.padded(n_cells, len(mesh))
    lead = env_state[0].shape[0]
    if lead != r_pad:
        raise ValueError(
            f"env_state leading dim {lead} != padded fleet size {r_pad} "
            f"(R={n_cells} on {len(mesh)} shards): build the world at the "
            f"true R, then pad it (scenarios.pad_scenario, params at the "
            f"padded size)")
    blocks = [(d * r_local, n_cells, r_pad) for d in range(len(mesh))]
    if noise is None:
        noise = GeneratorNoise(seed, dev)
    if obs_masked is None:
        obs_masked = bool(getattr(env_step, "emits_mask", False))
    group = RowBlockNoise(noise, n_cells, r_local, mesh)
    ests = shard_mod.split_rows(env_state, mesh, r_local)
    if snapshot is None:
        carries = None
        obs = [_fresh_obs_carry(r_local, router.n_modalities, router.n_tiers,
                                d) for d in mesh]
        stats = [reducer.init(r_local, row0, d)
                 for (row0, _, _), d in zip(blocks, mesh)]
    else:
        obs_g, stats_g, noise_state = snapshot
        set_state(group, noise_state)
        carries = shard_mod.split_rows(carry, mesh, r_local)
        obs = shard_mod.split_rows(tuple(obs_g), mesh, r_local)
        stats = [tuple(x[d].to(dev_d) for x in stats_g)
                 for d, dev_d in enumerate(mesh)]
    run = dict(group=group, blocks=blocks, reducer=reducer,
               obs_masked=obs_masked, t_begin=t_begin)
    if getattr(router, "mega", False):
        carries = _sharded_mega(router, carries, ests, obs, stats, env_step,
                                n_steps, n_total=n_total, **run)
    else:
        if carries is None:
            carries = [router.init_carry(r_local, d) for d in mesh]
            clock_phase = router.clock_phase(router.init_carry(1, dev))
        else:
            clock_phase = 0
        _sharded_ticks(router, carries, ests, obs, stats, env_step, n_steps,
                       clock_phase=clock_phase, **run)
    stats_g = tuple(torch.stack([s[i].to(dev) for s in stats])
                    for i in range(len(stats[0])))
    snap = (shard_mod.gather_rows(obs, dev), stats_g, get_state(group))
    return (shard_mod.gather_rows(carries, dev),
            shard_mod.gather_rows(ests, dev), stats_g, snap)


def _sharded_ticks(router, carries, ests, obs, stats, env_step, n_steps, *,
                   group, blocks, reducer, obs_masked, t_begin,
                   clock_phase):
    """The per-tick loop over every shard, updating the per-shard lists in
    place: ticks outside, shards inside, in :func:`_rollout_core`'s order
    (every shard's router step, the env over all blocks, the reducer, every
    shard's slow step)."""
    views = [group.block(d) for d in range(len(blocks))]
    r_local = ests[0][0].shape[0]
    k_tiers = router.n_tiers
    period = max(int(router.period), 1)
    dwell = max(int(router.dwell), 1)
    dwell_blocked = (dwell > 1 and clock_phase is not None
                     and (not router.has_slow or period % dwell == 0))
    phase0 = clock_phase or 0
    for i in range(n_steps):
        t = t_begin + i
        group.clear()
        weights = []
        for d, view in enumerate(views):
            raw_obs, tier_util, tier_up, tier_queue, obs_mask = obs[d]
            ro = RouterObs(raw_obs=raw_obs, tier_utilization=tier_util,
                           tier_up=tier_up, tier_queue=tier_queue, t_idx=t)
            mask = obs_mask if obs_masked else None
            if dwell_blocked and (phase0 + i) % dwell != 0:
                carries[d], w, _ = router.light_step(carries[d], ro, mask)
            else:
                carries[d], w, _ = router.step(carries[d], ro, mask, view)
            weights.append(w)
        uniforms = [view.env_uniforms(t, (r_local, k_tiers))
                    for view in views]
        ests[:], wins = env_step.step_blocks(ests, weights, t, uniforms,
                                             blocks)
        for d, win in enumerate(wins):
            stats[d] = reducer.update(stats[d], t, _stats_trace(
                torch.mean(obs[d][4], dim=-1), win))
        if router.has_slow and (clock_phase is None
                                or (clock_phase + i + 1) % period == 0):
            for d, view in enumerate(views):
                carries[d] = router.slow_step(carries[d], view, t)
        for d, win in enumerate(wins):
            obs[d] = (win.raw_obs, win.tier_utilization, win.tier_up,
                      win.tier_queue, win.obs_mask if obs_masked
                      else obs[d][4])


def _sharded_mega(router, states, ests, obs, stats, env_step, n_steps, *,
                  group, blocks, reducer, obs_masked, t_begin, n_total):
    """The mega path over every shard, updating the per-shard lists in
    place: windows outside, shards inside (each shard's noise block, B3 on
    every block, each shard's slow step and watchdog, the reducer).
    Returns the shards' states."""
    fl = getattr(env_step, "fluid", None)
    if fl is None:
        raise ValueError(
            "sharded mega rollouts need the env adapter's whole-window "
            "ingredients (env_step.fluid, set by repro_torch.envsim.batched."
            "make_env_step)")
    cfg = router.cfg
    period = max(int(router.period), 1)
    mesh = group.mesh
    r_local = group.r_local
    views = [group.block(d) for d in range(len(mesh))]
    if states is None:
        horizon = n_steps if n_total is None else int(n_total)
        states = [mega_mod.init_mega_state(cfg, r_local, horizon,
                                           router.slot_dtype, d)
                  for d in mesh]
    if t_begin + n_steps > states[0].slots.action.shape[1]:
        raise ValueError(
            f"ticks up to {t_begin + n_steps} do not fit the state's "
            f"{states[0].slots.action.shape[1]} slots: size the first chunk "
            f"with the whole horizon (n_total)")
    statics = dict(cfg=cfg, disc=router.resolved_disc,
                   util_edges=router.resolved_util_edges,
                   util_period=router.util_period, dt=fl.dt,
                   scrape_every=fl.scrape_every,
                   restart_blackout=fl.restart_blackout,
                   emits_mask=obs_masked)
    for t_start in range(t_begin, t_begin + n_steps, period):
        w = min(period, t_begin + n_steps - t_start)
        group.clear()
        noises = [_window_noise(view, t_start, w, r_local, cfg.n_actions,
                                fl.params.n_tiers, d)
                  for view, d in zip(views, mesh)]
        args, kw = _window_slices(fl, t_start, w)
        outs = efe_ops.mega_window_blocks(
            [(states[d], ests[d], obs[d], u, g, blocks[d])
             for d, (g, u) in enumerate(noises)],
            *args, t_start, **kw, **statics)
        for d, (state, est, o, ys) in enumerate(outs):
            states[d], _ = _window_after(state, views[d], t_start, w,
                                         do_slow=(w == period), cfg=cfg)
            ests[d], obs[d] = est, o
            stats[d] = reducer.update_window(stats[d], t_start,
                                             _stats_trace(ys[4], ys[5]))
    return states


def _stats_trace(obs_frac, env) -> FleetTrace:
    """The trace fields a reducer reads, as a :class:`FleetTrace`."""
    return FleetTrace(actions=None, routing_weights=None, raw_obs=None,
                      unstable=None, obs_frac=obs_frac, env=env)
