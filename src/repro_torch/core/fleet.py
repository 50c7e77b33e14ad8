"""Fleet mode: thousands of AIF routers as one batched program.

At datacenter scale each service cell gets its own router and all of them
share the same control cadence.  Every function here takes and returns a
batched :class:`~repro_torch.core.agent.AgentState` whose tensors carry a
leading router axis R.

Two execution paths for one control tick, as in the reference:

* ``fused=True`` (the port's default) runs the belief update *and* the EFE
  evaluation of every action in one fused launch
  (:func:`repro_torch.kernels.efe.ops.fleet_belief_efe`: kernel B1 for
  tensors on the card, its plain PyTorch version on the CPU);
* ``fused=False`` is the reference's vmapped single-agent step,
  :func:`repro_torch.core.agent.fast_step` over the leading R axis: plain
  PyTorch on every device, as the reference runs it in XLA with no Pallas
  kernel.

Both read the quasi-static :class:`~repro_torch.core.generative.ModelCache`
that :func:`fleet_slow_step` refreshes once per slow period.  A
heterogeneous fleet (:func:`hetero_fleet_rollout`) runs one rollout per
topology group.

Randomness is an operand: the action categorical takes (R, A) Gumbel noise,
``argmax(log p + gumbel)`` — the reference's ``jax.random.categorical``
computes exactly this from its key — and the slow step takes the (R, batch)
replay indices.  The closed loop lives in :func:`repro_torch.api.engine.rollout`.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import agent as agent_mod
from repro_torch.core import belief as belief_mod
from repro_torch.core import efe as efe_mod
from repro_torch.core import generative, learning, policies, preferences
from repro_torch.core import spaces
from repro_torch.device import resolve_device
from repro_torch.kernels.efe import ops as efe_ops


def _batched(t: torch.Tensor, n: int) -> torch.Tensor:
    return t.unsqueeze(0).expand((n,) + tuple(t.shape)).contiguous()


def init_fleet_state(cfg: generative.AifConfig, n_routers: int,
                     device: str | torch.device = "cuda"
                     ) -> agent_mod.AgentState:
    """Batched agent state with leading router axis R = n_routers; every
    router owns its own (materialized) tensors."""
    dev = resolve_device(device)
    single = agent_mod.init_agent_state(cfg, dev)
    return _map_state(lambda x: _batched(x, n_routers), single)


def _map_state(fn, state: agent_mod.AgentState) -> agent_mod.AgentState:
    return agent_mod.AgentState(
        model=generative.GenerativeModel(*(fn(x) for x in state.model)),
        cache=generative.ModelCache(*(fn(x) for x in state.cache)),
        belief=fn(state.belief),
        replay=learning.ReplayBuffer(*(fn(x) for x in state.replay)),
        prev_action=fn(state.prev_action),
        dt_since_change=fn(state.dt_since_change),
        error_ema=fn(state.error_ema),
        unstable=fn(state.unstable),
        t=fn(state.t),
    )


def agent_state_from_numpy(arrays: dict, cfg: generative.AifConfig,
                           device: str | torch.device = "cuda"
                           ) -> agent_mod.AgentState:
    """A batched :class:`AgentState` from the reference's leaves.

    ``arrays`` maps each ``AgentState`` field name to a numpy array, and the
    nested ``model`` / ``cache`` / ``replay`` fields to dicts of their own
    fields (``NamedTuple._asdict()`` of the reference state, leaves through
    ``np.asarray``).  Integer leaves become int64, ``unstable`` bool, the
    rest float32.  ``cfg`` fixes the expected shapes.
    """
    dev = resolve_device(device)
    topo = cfg.topology

    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=dev)

    def i64(x):
        return torch.tensor(x, dtype=torch.int64, device=dev)

    model = generative.GenerativeModel(
        **{k: f32(arrays["model"][k]) for k in generative.GenerativeModel._fields})
    cache = generative.ModelCache(
        **{k: f32(arrays["cache"][k]) for k in generative.ModelCache._fields})
    rp = arrays["replay"]
    replay = learning.ReplayBuffer(
        q_prev=f32(rp["q_prev"]), q_next=f32(rp["q_next"]),
        obs_bins=i64(rp["obs_bins"]), obs_mask=f32(rp["obs_mask"]),
        action=i64(rp["action"]), dt_since_change=f32(rp["dt_since_change"]),
        cursor=i64(rp["cursor"]), size=i64(rp["size"]))
    state = agent_mod.AgentState(
        model=model, cache=cache, belief=f32(arrays["belief"]), replay=replay,
        prev_action=i64(arrays["prev_action"]),
        dt_since_change=f32(arrays["dt_since_change"]),
        error_ema=f32(arrays["error_ema"]),
        unstable=torch.tensor(arrays["unstable"], dtype=torch.bool,
                              device=dev),
        t=i64(arrays["t"]))
    r = state.belief.shape[0]
    want = (r, cfg.n_actions, topo.n_states, topo.n_states)
    if tuple(model.b_counts.shape) != want:
        raise ValueError(f"b_counts has shape {tuple(model.b_counts.shape)},"
                         f" the config expects {want}")
    return state


# ------------------------------------------------------------------ one tick
def _fused_evidence(state: agent_mod.AgentState,
                    obs_bins: torch.Tensor,
                    raw_error_rate: torch.Tensor,
                    cfg: generative.AifConfig,
                    util_bins: torch.Tensor | None, util_valid: bool,
                    obs_mask: torch.Tensor | None = None):
    """Per-tick evidence shared by the fused selecting and held steps:
    adaptive preferences (the only per-tick model change) and the
    observation log-likelihood gathered from the cached normalized A, with
    masked modalities zeroed out of the sum.

    Returns (model-with-updated-c_log, error_ema, unstable, loglik).
    """
    error_ema = agent_mod.masked_error_ema(state.error_ema, raw_error_rate,
                                           cfg, obs_mask)
    c_log, unstable = preferences.adapt_preferences(error_ema, cfg)
    model = state.model._replace(c_log=c_log)
    loglik = belief_mod.log_likelihood_from_normalized(state.cache.na,
                                                       obs_bins, obs_mask)
    if util_bins is not None and util_valid:
        loglik = loglik + belief_mod.util_log_likelihood(util_bins,
                                                         cfg.topology)
    return model, error_ema, unstable, loglik


def _effective_amb(cache: generative.ModelCache,
                   obs_mask: torch.Tensor | None) -> torch.Tensor:
    """Per-state ambiguity under the tick's mask (cached amb when unmasked)."""
    if obs_mask is None:
        return cache.amb
    return generative.masked_ambiguity(cache.amb_m, obs_mask)


def _step_info(action, q_next, unstable, obs_bins, obs_mask, efe, cfg):
    return agent_mod.StepInfo(
        action=action,
        routing_weights=policies.routing_weights(action, cfg.topology),
        efe=efe,
        belief_entropy=belief_mod.belief_entropy(q_next),
        unstable=unstable,
        obs_bins=obs_bins,
        obs_mask=(agent_mod.all_valid_mask(obs_bins)
                  if obs_mask is None else obs_mask),
    )


def _fused_fast_step(state, obs_bins, raw_error_rate, gumbel, cfg,
                     util_bins, util_valid, obs_mask):
    """Selecting tick: belief update and EFE fused into one fleet launch,
    then the Gumbel-argmax categorical, the replay push and the dwell gate.
    ``StepInfo.efe`` carries G and the action probabilities; the fused
    kernel does not split out risk/ambiguity, which read zero."""
    topo = cfg.topology
    cache = state.cache
    model, error_ema, unstable, loglik = _fused_evidence(
        state, obs_bins, raw_error_rate, cfg, util_bins, util_valid, obs_mask)

    logc = generative.masked_log_c(model.c_log, topo)
    g, q_next = efe_ops.fleet_belief_efe(
        cache.nb, cache.na, logc, _effective_amb(cache, obs_mask),
        state.belief, state.prev_action, loglik, cfg, obs_mask=obs_mask)

    probs = torch.softmax(-cfg.beta * g, dim=-1)
    sampled = torch.argmax(torch.log(torch.clamp(probs, min=1e-30)) + gumbel,
                           dim=-1)

    replay = learning.push_transition(
        state.replay, state.belief, q_next, obs_bins, state.prev_action,
        state.dt_since_change, obs_mask)
    new_state, action = agent_mod.apply_action(
        state, model, q_next, replay, error_ema, unstable, sampled, cfg)

    zeros = torch.zeros_like(g)
    cost = cfg.cost_weight * policies.policy_concentration_cost(topo, g.device)
    efe = efe_mod.EfeBreakdown(g=g, risk=zeros, ambiguity=zeros,
                               cost=cost.expand(g.shape), action_probs=probs)
    return new_state, _step_info(action, q_next, unstable, obs_bins,
                                 obs_mask, efe, cfg)


def fleet_fast_step(state: agent_mod.AgentState,
                    obs_bins: torch.Tensor,
                    raw_error_rate: torch.Tensor,
                    gumbel: torch.Tensor,
                    cfg: generative.AifConfig,
                    util_bins: torch.Tensor | None = None,
                    util_valid: bool = False,
                    obs_mask: torch.Tensor | None = None,
                    *,
                    fused: bool = True):
    """One fast step (belief → EFE → action) for the fleet; no slow learning.

    Args:
      obs_bins: (R, M) int observation bins.
      raw_error_rate: (R,) undiscretized error rate (drives the EMA).
      gumbel: (R, A) Gumbel noise of the action categorical.
      util_bins: optional (R, K) utilization scrape in state-factor order.
      util_valid: gate for ``util_bins`` (True on scrape ticks).
      obs_mask: (R, M) telemetry-validity mask (None = every modality fresh).
      fused: the fused belief→EFE launch, or (False) the single-agent step
        batched over R with the full EFE breakdown.
    """
    if fused:
        return _fused_fast_step(state, obs_bins, raw_error_rate, gumbel, cfg,
                                util_bins, util_valid, obs_mask)
    return agent_mod.fast_step(state, obs_bins, raw_error_rate, gumbel, cfg,
                               util_bins, util_valid, obs_mask)


# -------------------------------------------------------- light (held) ticks
def _zero_breakdown(r: int, cfg: generative.AifConfig,
                    device: torch.device) -> efe_mod.EfeBreakdown:
    z = torch.zeros((r, cfg.n_actions), device=device)
    return efe_mod.EfeBreakdown(g=z, risk=z, ambiguity=z, cost=z,
                                action_probs=z)


def fleet_light_step(state: agent_mod.AgentState,
                     obs_bins: torch.Tensor,
                     raw_error_rate: torch.Tensor,
                     cfg: generative.AifConfig,
                     util_bins: torch.Tensor | None = None,
                     util_valid: bool = False,
                     obs_mask: torch.Tensor | None = None,
                     *,
                     fused: bool = True):
    """Fleet fast step for a tick off the action-dwell cadence (``t % dwell
    != 0`` for every router): the sampled action would be discarded, so the
    EFE evaluation — streaming the whole (R, A, S, S) cached B — is skipped
    and only the cached-model belief update runs (fused: the fused
    kernel's posterior math; unfused: the single agent's
    :func:`~repro_torch.core.agent.pre_action`).  ``StepInfo.efe`` reads
    zero."""
    if fused:
        model, error_ema, unstable, loglik = _fused_evidence(
            state, obs_bins, raw_error_rate, cfg, util_bins, util_valid,
            obs_mask)
        q_next = efe_ops.fleet_belief_posterior(
            state.cache.nb, state.belief, state.prev_action, loglik)
        replay = learning.push_transition(
            state.replay, state.belief, q_next, obs_bins, state.prev_action,
            state.dt_since_change, obs_mask)
    else:
        model, q_next, replay, error_ema, unstable = agent_mod.pre_action(
            state, obs_bins, raw_error_rate, cfg, util_bins, util_valid,
            obs_mask)
    new_state, action = agent_mod.apply_action(
        state, model, q_next, replay, error_ema, unstable,
        state.prev_action, cfg)
    efe = _zero_breakdown(action.shape[0], cfg, action.device)
    return new_state, _step_info(action, q_next, unstable, obs_bins,
                                 obs_mask, efe, cfg)


def fleet_slow_step(state: agent_mod.AgentState, idx: torch.Tensor,
                    cfg: generative.AifConfig) -> agent_mod.AgentState:
    """Slow learning + model-cache refresh for routers whose clock is on a
    slow-period boundary (``t % period == 0``); the others add no counts, so
    their model and cache come out unchanged.

    ``idx`` (R, batch) are the replay draws.  The pseudo-counts are updated
    in place; the replay buffer passes through untouched.
    """
    period = max(int(cfg.slow_period_s / cfg.fast_period_s), 1)
    do_learn = (state.t % period) == 0                     # (R,)
    return agent_mod.slow_step(state, idx, cfg, learn=do_learn)


def fleet_tick(state: agent_mod.AgentState,
               obs_bins: torch.Tensor,
               raw_error_rate: torch.Tensor,
               noise,
               t: int,
               cfg: generative.AifConfig,
               util_bins: torch.Tensor | None = None,
               util_valid: bool = False,
               obs_mask: torch.Tensor | None = None,
               *,
               fused: bool = True):
    """One control tick for the whole fleet: the fast step, then the slow
    step for routers whose clock lands on a slow-period boundary.

    ``noise`` (the :mod:`repro_torch.noise` protocol) gives tick ``t``'s
    Gumbel noise and, at a boundary, its replay indices.  The fast step
    updates the replay ring in place: keep the returned state.  Prefer
    :func:`repro_torch.api.engine.rollout` for closed loops, which runs
    held ticks without the EFE.
    """
    if not fused:
        return agent_mod.tick(state, obs_bins, raw_error_rate, cfg, noise, t,
                              util_bins, util_valid, obs_mask)
    r = state.belief.shape[0]
    gumbel = noise.gumbel(t, (r, cfg.n_actions))
    state, info = _fused_fast_step(state, obs_bins, raw_error_rate, gumbel,
                                   cfg, util_bins, util_valid, obs_mask)
    period = max(int(cfg.slow_period_s / cfg.fast_period_s), 1)
    if bool(((state.t % period) == 0).any()):
        idx = noise.replay_indices(t, state.replay.size, cfg.replay_batch)
        state = fleet_slow_step(state, idx, cfg)
    return state, info


# ------------------------------------------------------------------ watchdog
def fleet_watchdog_bad(state: agent_mod.AgentState) -> torch.Tensor:
    """(R,) bool — cells whose carry has diverged numerically.

    A cell is flagged when its posterior stops being a finite distribution
    (NaN/Inf, negative mass, or a sum far from 1), when its observation
    pseudo-counts or cached ambiguity go non-finite, or when the error EMA
    is non-finite.  Cheap: no (R, A, S, S) traffic.
    """
    r = state.belief.shape[0]

    def rows_finite(a):
        return torch.all(torch.isfinite(a.reshape(r, -1)), dim=-1)

    ok = (rows_finite(state.belief)
          & torch.all(state.belief >= 0.0, dim=-1)
          & (torch.abs(torch.sum(state.belief, dim=-1) - 1.0) <= 0.5)
          & rows_finite(state.model.a_counts)
          & rows_finite(state.cache.amb)
          & torch.isfinite(state.error_ema))
    return ~ok


def fleet_quarantine(state: agent_mod.AgentState, bad: torch.Tensor,
                     cfg: generative.AifConfig) -> agent_mod.AgentState:
    """Reinit the flagged cells to their priors; healthy cells unchanged.

    Quarantined cells restart as fresh agents — prior belief and generative
    model (and its cache), an emptied replay ring (contents zeroed, so a NaN
    slot cannot re-poison the next slow update), balanced action, cleared
    EMA.  ``t`` is left untouched so the fleet clock stays aligned.  Every
    tensor is written **in place** at the flagged rows.
    """
    single = agent_mod.init_agent_state(cfg, state.belief.device)
    rows = torch.nonzero(bad).flatten()

    def reset(old: torch.Tensor, fresh: torch.Tensor) -> torch.Tensor:
        old[rows] = fresh.to(old.dtype)
        return old

    def reset_all(olds, fresh):
        return type(olds)(*(reset(o, f) for o, f in zip(olds, fresh)))

    return agent_mod.AgentState(
        model=reset_all(state.model, single.model),
        cache=reset_all(state.cache, single.cache),
        belief=reset(state.belief, single.belief),
        replay=reset_all(state.replay, single.replay),
        prev_action=reset(state.prev_action, single.prev_action),
        dt_since_change=reset(state.dt_since_change, single.dt_since_change),
        error_ema=reset(state.error_ema, single.error_ema),
        unstable=reset(state.unstable, single.unstable),
        t=state.t,
    )


# ------------------------------------------------------------------- rollout
class FleetTrace(NamedTuple):
    """Per-window traces of a fleet rollout (leading time axis T)."""

    actions: torch.Tensor          # (T, R) selected policies
    routing_weights: torch.Tensor  # (T, R, K) applied weights
    raw_obs: torch.Tensor          # (T, R, M) metrics the routers observed
    unstable: torch.Tensor         # (T, R) adaptive-preference mode flag
    # effective-observation fraction: share of modalities that delivered
    # fresh telemetry into this tick's belief update (obs_frac[0] is the
    # all-valid warm-up mask)
    obs_frac: torch.Tensor         # (T, R)
    env: Any                       # environment info (stacked WindowInfo)
    watchdog: Any = None           # (T, R) float 0/1 quarantine events


def fleet_rollout(agent_state: agent_mod.AgentState,
                  env_state,
                  env_step: Callable,
                  n_steps: int,
                  noise,
                  cfg: generative.AifConfig,
                  disc: spaces.DiscretizationConfig | None = None,
                  util_edges: tuple[float, ...] | None = None,
                  util_period: int = 10,
                  *,
                  fused: bool = True,
                  obs_masked: bool | None = None,
                  t0: int | None = None,
                  seed: int = 0):
    """Deprecated AIF-only entry point: use :mod:`repro_torch.api`.

    Packs the old hand-assembled cfg/disc/util_edges/fused signature into a
    :class:`repro_torch.api.aif.AifRouter` and delegates to
    :func:`repro_torch.api.engine.rollout` (``noise`` None draws from a
    generator seeded with ``seed``)::

        router = api.AifRouter(cfg=cfg, disc=disc, fused=fused)
        api.rollout(router, agent_state, env_state, env_step, n_steps, noise)
    """
    warnings.warn(
        "repro_torch.core.fleet.fleet_rollout is deprecated: build a "
        "repro_torch.api.AifRouter and call repro_torch.api.rollout (or run "
        "a declarative repro_torch.api.Experiment); this shim keeps the old "
        "signature working unchanged",
        DeprecationWarning, stacklevel=2)
    from repro_torch.api.aif import AifRouter
    from repro_torch.api.engine import rollout
    router = AifRouter(cfg=cfg, disc=disc,
                       util_edges=(None if util_edges is None
                                   else tuple(util_edges)),
                       util_period=util_period, fused=fused)
    return rollout(router, agent_state, env_state, env_step, n_steps, noise,
                   seed=seed, obs_masked=obs_masked, t0=t0)


# ------------------------------------------------------- heterogeneous fleet
class FleetGroup(NamedTuple):
    """One topology-homogeneous group of a heterogeneous fleet.

    Shapes differ across topologies (|S|, A, K), so cells of different
    topologies cannot share one batched state: the fleet is grouped by
    topology and each group runs its own rollout (its own kernel shapes).
    """

    name: str
    cfg: generative.AifConfig
    agent_state: agent_mod.AgentState    # batched, leading dim R_g
    env_state: Any
    env_step: Callable
    # per-group execution path (a 5-tier group can run fused while a
    # 3-tier group runs the single-agent step)
    fused: bool = True
    # per-group observation discretization (None = paper defaults)
    disc: spaces.DiscretizationConfig | None = None


#: Engine options hetero_fleet_rollout forwards to every group's rollout
#: (per-group options, disc and fused, live on the FleetGroup).
_HETERO_ROLLOUT_KWARGS = frozenset(
    {"util_edges", "util_period", "obs_masked", "t0"})


def group_seed(seed: int, i: int) -> int:
    """Seed of group ``i``'s generator in a run seeded with ``seed``: the
    groups draw independent streams, as the reference folds its key per
    group."""
    return int(np.random.SeedSequence([seed, i]).generate_state(1)[0])


def hetero_fleet_rollout(groups, n_steps: int, noise=None, *, seed: int = 0,
                         **kwargs) -> dict:
    """Run a heterogeneous fleet: one engine rollout per topology group.

    Args:
      groups: sequence of :class:`FleetGroup` (cells pre-grouped by
        topology, each with its own execution path).
      n_steps: shared number of control windows.
      noise: one :mod:`repro_torch.noise` source per group, or None for
        a generator per group seeded with :func:`group_seed` ``(seed, i)``.
      **kwargs: engine options shared by every group, among ``util_edges``,
        ``util_period``, ``obs_masked`` and ``t0``; any other key raises
        ``TypeError`` here, naming the valid options.

    Returns:
      dict group name -> (final agent state, final env state, FleetTrace).
    """
    unknown = set(kwargs) - _HETERO_ROLLOUT_KWARGS
    if unknown:
        raise TypeError(
            f"hetero_fleet_rollout got unknown engine option(s) "
            f"{sorted(unknown)}; shared options are "
            f"{sorted(_HETERO_ROLLOUT_KWARGS)} and per-group options "
            f"(disc, fused) belong on the FleetGroup")
    names = [g.name for g in groups]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate FleetGroup names: {names}")
    if noise is not None and len(noise) != len(groups):
        raise ValueError(f"{len(noise)} noise sources for {len(groups)} "
                         f"groups; pass one per group or None")
    from repro_torch.api.aif import AifRouter
    from repro_torch.api.engine import rollout
    rollout_kwargs = {k: kwargs[k] for k in ("obs_masked", "t0")
                      if k in kwargs}
    util_edges = kwargs.get("util_edges")
    out = {}
    for i, g in enumerate(groups):
        router = AifRouter(
            cfg=g.cfg, disc=g.disc,
            util_edges=None if util_edges is None else tuple(util_edges),
            util_period=kwargs.get("util_period", 10), fused=g.fused)
        out[g.name] = rollout(
            router, g.agent_state, g.env_state, g.env_step, n_steps,
            None if noise is None else noise[i], seed=group_seed(seed, i),
            **rollout_kwargs)
    return out
