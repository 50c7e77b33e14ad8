"""The AIF-Router agent state and its control-step pieces (paper §4, Fig. 1).

All mutable state lives in an :class:`AgentState` of tensors with a leading
router axis R (the fleet); every transition below is elementwise over that
axis.  Fast loop (1 s): observe → adapt preferences → belief update (Eq. 2)
→ EFE action selection (Eq. 1) → record transition.  Slow loop (10 s):
:func:`slow_step`.  The fused fleet composes these pieces with kernel B1
(:mod:`repro_torch.core.fleet`); :func:`fast_step` and :func:`tick` are the
reference's single-agent step (``repro/core/agent.py``) — belief update,
the full EFE breakdown and a sample on every tick — on the same batched
state (R=1 for one router).  Randomness is an operand: the Gumbel noise of
the action categorical, and the replay indices of the slow step, which
:func:`tick` asks of a ``repro_torch.noise`` source.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import belief as belief_mod
from repro_torch.core import efe as efe_mod
from repro_torch.core import generative, learning, policies, preferences


class AgentState(NamedTuple):
    model: generative.GenerativeModel
    # Quasi-static normalized model (refreshed by slow_step only).
    cache: generative.ModelCache
    belief: torch.Tensor             # (..., S) current posterior q(s_t)
    replay: learning.ReplayBuffer
    prev_action: torch.Tensor        # (...) int64 — action currently applied
    dt_since_change: torch.Tensor    # (...) float32 — s since action change
    error_ema: torch.Tensor          # (...) float32 — smoothed error rate
    unstable: torch.Tensor           # (...) bool — adaptive-preference mode
    t: torch.Tensor                  # (...) int64 — fast steps elapsed


class StepInfo(NamedTuple):
    """Diagnostics emitted by each fast step."""

    action: torch.Tensor
    routing_weights: torch.Tensor    # (..., K) applied weights
    efe: efe_mod.EfeBreakdown
    belief_entropy: torch.Tensor
    unstable: torch.Tensor
    obs_bins: torch.Tensor
    obs_mask: torch.Tensor           # (..., M) validity of this tick's evidence


def init_agent_state(cfg: generative.AifConfig,
                     device: torch.device | str) -> AgentState:
    """One fresh agent (no router axis; see ``fleet.init_fleet_state``)."""
    model = generative.init_generative_model(cfg, device)
    return AgentState(
        model=model,
        cache=generative.derive_cache(model, cfg.topology),
        belief=model.d_prior.clone(),
        replay=learning.init_replay(cfg.replay_capacity, cfg.topology,
                                    device),
        prev_action=torch.tensor(policies.BALANCED_ACTION, device=device),
        dt_since_change=torch.zeros((), device=device),
        error_ema=torch.zeros((), device=device),
        unstable=torch.zeros((), dtype=torch.bool, device=device),
        t=torch.zeros((), dtype=torch.int64, device=device),
    )


def all_valid_mask(obs_bins: torch.Tensor) -> torch.Tensor:
    """(..., M) all-ones validity mask matching a batch of observation bins."""
    return torch.ones(obs_bins.shape, device=obs_bins.device)


def masked_error_ema(prev_ema: torch.Tensor,
                     raw_error_rate: torch.Tensor,
                     cfg: generative.AifConfig,
                     obs_mask: torch.Tensor | None) -> torch.Tensor:
    """Adaptive-preference error EMA that respects the telemetry mask: a
    masked error modality is treated as no sample and the EMA holds."""
    new = preferences.ema_update(prev_ema, raw_error_rate, cfg)
    if obs_mask is None:
        return new
    try:
        err_ix = cfg.topology.modalities.index("error")
    except ValueError:
        return new
    return torch.where(obs_mask[..., err_ix] > 0, new, prev_ema)


def pre_action(state: AgentState,
               obs_bins: torch.Tensor,
               raw_error_rate: torch.Tensor,
               cfg: generative.AifConfig,
               util_bins: torch.Tensor | None = None,
               util_valid: bool | torch.Tensor = False,
               obs_mask: torch.Tensor | None = None):
    """Everything in a fast step *before* action selection: adaptive
    preferences (paper §4.2) → belief update (Eq. 2) from the cached model →
    replay push (in place).

    Returns (model, q_next, replay, error_ema, unstable).
    """
    error_ema = masked_error_ema(state.error_ema, raw_error_rate, cfg,
                                 obs_mask)
    c_log, unstable = preferences.adapt_preferences(error_ema, cfg)
    model = state.model._replace(c_log=c_log)
    q_prev = state.belief
    q_next = belief_mod.update_belief(model, q_prev, state.prev_action,
                                      obs_bins, cfg.topology, util_bins,
                                      util_valid, cache=state.cache,
                                      obs_mask=obs_mask)
    replay = learning.push_transition(
        state.replay, q_prev, q_next, obs_bins, state.prev_action,
        state.dt_since_change, obs_mask)
    return model, q_next, replay, error_ema, unstable


def dwell_gate(t: torch.Tensor,
               prev_action: torch.Tensor,
               dt_since_change: torch.Tensor,
               sampled: torch.Tensor,
               cfg: generative.AifConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """Dwell-gate a sampled action against the agent clock.

    Returns (applied action (int64), new dt_since_change).
    """
    dwell_ticks = max(int(cfg.action_dwell_s / cfg.fast_period_s), 1)
    do_select = (t % dwell_ticks) == 0
    action = torch.where(do_select, sampled, prev_action)
    changed = action != prev_action
    dt = torch.where(changed, 0.0, dt_since_change + cfg.fast_period_s)
    return action.long(), dt


def apply_action(state: AgentState,
                 model: generative.GenerativeModel,
                 q_next: torch.Tensor,
                 replay: learning.ReplayBuffer,
                 error_ema: torch.Tensor,
                 unstable: torch.Tensor,
                 sampled: torch.Tensor,
                 cfg: generative.AifConfig) -> tuple[AgentState, torch.Tensor]:
    """Dwell-gate the sampled action and assemble the next AgentState.

    Returns (new_state, applied action).
    """
    action, dt = dwell_gate(state.t, state.prev_action, state.dt_since_change,
                            sampled, cfg)
    new_state = AgentState(
        model=model,
        cache=state.cache,
        belief=q_next,
        replay=replay,
        prev_action=action,
        dt_since_change=dt,
        error_ema=error_ema,
        unstable=unstable,
        t=state.t + 1,
    )
    return new_state, action


def slow_step(state: AgentState, idx: torch.Tensor,
              cfg: generative.AifConfig,
              learn: torch.Tensor | None = None) -> AgentState:
    """One 10-second model-learning step (replay batch update of A and B).

    ``idx`` is the (R, batch) replay draw.  The only in-loop writer of the
    pseudo-counts (in place); refreshing the normalized cache here keeps the
    fast loop's cached tensors consistent by construction.
    """
    model = learning.slow_update(state.model, state.replay, idx, cfg, learn)
    return state._replace(model=model,
                          cache=generative.derive_cache(model, cfg.topology))


def fast_step(state: AgentState,
              obs_bins: torch.Tensor,
              raw_error_rate: torch.Tensor,
              gumbel: torch.Tensor,
              cfg: generative.AifConfig,
              util_bins: torch.Tensor | None = None,
              util_valid: bool | torch.Tensor = False,
              obs_mask: torch.Tensor | None = None
              ) -> tuple[AgentState, StepInfo]:
    """One 1-second control step of the reference's single agent, for each
    of the R routers of ``state``.

    Args:
      obs_bins: (R, M) int discretized observation.
      raw_error_rate: (R,) undiscretized error rate (drives the EMA).
      gumbel: (R, A) Gumbel noise of the action categorical.
      util_bins: optional (R, K) utilization scrape in state-factor order.
      util_valid: gate for ``util_bins`` (True on scrape ticks).
      obs_mask: optional (R, M) float 0/1 telemetry-validity mask.
    """
    model, q_next, replay, error_ema, unstable = pre_action(
        state, obs_bins, raw_error_rate, cfg, util_bins, util_valid, obs_mask)
    sampled, bd = efe_mod.select_action(gumbel, model, q_next, cfg,
                                        state.cache, obs_mask)
    new_state, action = apply_action(state, model, q_next, replay, error_ema,
                                     unstable, sampled, cfg)
    info = StepInfo(
        action=action,
        routing_weights=policies.routing_weights(action, cfg.topology),
        efe=bd,
        belief_entropy=belief_mod.belief_entropy(q_next),
        unstable=unstable,
        obs_bins=obs_bins,
        obs_mask=all_valid_mask(obs_bins) if obs_mask is None else obs_mask,
    )
    return new_state, info


def tick(state: AgentState,
         obs_bins: torch.Tensor,
         raw_error_rate: torch.Tensor,
         cfg: generative.AifConfig,
         noise,
         t: int,
         util_bins: torch.Tensor | None = None,
         util_valid: bool | torch.Tensor = False,
         obs_mask: torch.Tensor | None = None
         ) -> tuple[AgentState, StepInfo]:
    """:func:`fast_step`, then the slow learning step for routers whose
    clock lands on a slow-period boundary (timescale separation).

    ``noise`` (the ``repro_torch.noise`` protocol) gives tick ``t``'s
    Gumbel noise and, at a boundary, its replay indices, drawn after the
    fast step's replay push (they depend on the ring's size).
    """
    r = state.belief.shape[0]
    gumbel = noise.gumbel(t, (r, cfg.n_actions))
    state, info = fast_step(state, obs_bins, raw_error_rate, gumbel, cfg,
                            util_bins, util_valid, obs_mask)
    period = max(int(cfg.slow_period_s / cfg.fast_period_s), 1)
    learn = (state.t % period) == 0
    if bool(learn.any()):
        idx = noise.replay_indices(t, state.replay.size, cfg.replay_batch)
        state = slow_step(state, idx, cfg, learn=learn)
    return state, info
