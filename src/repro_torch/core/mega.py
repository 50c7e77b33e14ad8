"""Whole-window factored fleet state of the mega engine path.

The per-tick fleet keeps dense (R, A, S, S) transition pseudo-counts: the
slow loop rewrites them every period and every belief update streams an
(S, S) row.  The counts are structurally low rank,

    b_counts = b0 + α_B · Σ_j  w_j · 1[act_j = a] · q_next_j ⊗ q_prev_j,

where ``b0`` is the sticky prior (or, for a warm-promoted fleet, the
source fleet's learned dense counts ``b_base``) and the sum runs over the
pushed transition slots ``j`` with weights that change only on slow
boundaries (``w_j = settle(Δt_j) · #times-sampled``).  This module keeps
that factored bookkeeping:

* :class:`MegaSlots` — every pushed transition of the rollout, one slot per
  tick (the horizon is bounded by the replay capacity, so slot index ==
  tick index),
* :class:`MegaCache` — quasi-static derived tensors (per-column B
  normalizers, EFE projection rows, per-slot coefficients), advanced once
  per slow period,
* the factored belief prior and EFE (:func:`factored_prior`,
  :func:`factored_efe`) and the whole window (:func:`mega_window`):
  belief update → EFE → Gumbel-argmax sample → dwell gate → env window,
  W ticks per call, under fault schedules and on fleet graphs too.
  :func:`mega_window` is the plain PyTorch version of the CUDA kernel in
  :mod:`repro_torch.kernels.efe.mega` and what its wrapper runs for CPU
  tensors; :func:`mega_window_launches` is the plain model of the
  kernel's split of a graph window into W + 1 launches, and
  :func:`mega_window_blocks` runs one window for every row block of a
  sharded fleet (on a graph, launch by launch across the blocks).

Slow boundaries stream: :func:`mega_slow_step` folds the replayed batch
into the cached column sums (:func:`_advance_cache`) and bumps the slot-hit
counts ``wcount``, the sufficient statistic that keeps the from-scratch
:func:`_refresh_cache` mathematically identical.

The slot tape is large (R=4096 × J=300 × S=243 f32 slots take 2.4 GB), so
:func:`mega_window` writes each window's pushes **in place** into the
caller's tape; everything else returns new tensors.  Randomness is an
operand: the window takes the Gumbel noise and the env restart uniforms,
the slow step the replay indices.

Warm promotion: ``init_mega_state(from_agent_state=...)`` moves a trained
dense per-tick fleet onto this path mid-life.  Its dense ``b_counts``
become the cache's ``b_base`` baseline (read, never rewritten: only the
slot terms grow), its replay entries the leading slots, and its clock
continues; the prior and the EFE then take the baseline's (S, S) rows in
place of the scalar sticky prior.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import agent as agent_mod
from repro_torch.core import belief as belief_mod
from repro_torch.core import generative, learning, policies, preferences
from repro_torch.core import spaces
from repro_torch.device import resolve_device
from repro_torch.envsim import batched


class MegaSlots(NamedTuple):
    """All pushed transitions of a rollout, slot ``j`` == fast tick ``j``.

    ``wcount`` — how many times slot ``j`` was drawn by the slow steps so
    far — is the only learning state that changes after a push: the
    implicit B-count contribution of slot ``j`` is
    ``α_B · settle(Δt_j) · wcount_j · q_next_j ⊗ q_prev_j``.
    ``q_prev`` / ``q_next`` may be stored in bfloat16; every consumer
    accumulates in float32.
    """

    q_prev: torch.Tensor           # (R, J, S) belief before the tick
    q_next: torch.Tensor           # (R, J, S) posterior after the tick
    obs_bins: torch.Tensor         # (R, J, M) int64
    obs_mask: torch.Tensor         # (R, J, M) float32 validity at push time
    action: torch.Tensor           # (R, J) int64 action in force at the tick
    dt_since_change: torch.Tensor  # (R, J) float32 dwell age at the tick
    wcount: torch.Tensor           # (R, J) float32 times sampled


class MegaCache(NamedTuple):
    """Quasi-static derived tensors, advanced once per slow period.

    With ``u = b_prior_uniform / S`` and ``d = b_prior_sticky``:

      colsum[a, s]  = col0[a, s] + Σ_j coefact[j, a] · Σ_t q_next_j[t] · q_prev_j[s]
                      (col0 the scalar prior column sum u·S + d, or
                      Σ_t b_base[a, t, s] for a warm-promoted fleet)
      coefw[j]      = α_B · settle(Δt_j) · wcount_j
      coefact[j, a] = coefw[j] · 1[action_j = a]
      proj          = the EFE's (P, S) projection rows: the M·NB normalized
                      observation rows, then the M per-modality ambiguity rows
      qnproj[j, p]  = proj[p] · q_next_j
      sumqn[j]      = Σ_t q_next_j[t]
      logna         = log max(na, 1e-16), the evidence gather's rows
      b_base        = None on a fresh fleet (the scalar sticky prior
                      suffices), else the (R, A, S, S) dense transition
                      counts of a warm promotion, read and never rewritten
    """

    colsum: torch.Tensor    # (R, A, S)
    proj: torch.Tensor      # (R, P, S) with P = M·max_bins + M
    projsum: torch.Tensor   # (R, P)
    qnproj: torch.Tensor    # (R, J, P)
    sumqn: torch.Tensor     # (R, J)
    coefw: torch.Tensor     # (R, J)
    coefact: torch.Tensor   # (R, J, A)
    logna: torch.Tensor     # (R, M, max_bins, S)
    b_base: torch.Tensor | None = None


class MegaFleetState(NamedTuple):
    """Factored fleet carry of the mega engine path."""

    a_counts: torch.Tensor         # (R, M, max_bins, S)
    slots: MegaSlots
    cache: MegaCache
    belief: torch.Tensor           # (R, S)
    prev_action: torch.Tensor      # (R,) int64
    dt_since_change: torch.Tensor  # (R,) float32
    error_ema: torch.Tensor        # (R,) float32
    unstable: torch.Tensor         # (R,) bool
    t: torch.Tensor                # (R,) int64 fast ticks elapsed


def n_proj(topo) -> int:
    """Rows of the EFE projection: M·max_bins observation rows + M
    per-modality ambiguity rows."""
    return topo.n_modalities * topo.max_bins + topo.n_modalities


# ------------------------------------------------------------------- cache
def _a_cache(a_counts: torch.Tensor, topo):
    """The observation-model rows of the cache: (proj, projsum, logna)."""
    r = a_counts.shape[0]
    m, nb, s = topo.n_modalities, topo.max_bins, topo.n_states
    mask = spaces.bins_mask(topo, a_counts.device)[:, :, None]
    counts = a_counts * mask
    na = counts / torch.clamp(torch.sum(counts, dim=-2, keepdim=True),
                              min=1e-30)
    logna = torch.log(torch.clamp(na, min=1e-16))
    amb_m = generative.modality_ambiguity_from_normalized(na, topo)
    proj = torch.cat([na.reshape(r, m * nb, s), amb_m], dim=1)
    return proj, torch.sum(proj, dim=-1), logna


def slot_coefficients(slots: MegaSlots, cfg: generative.AifConfig):
    """Per-slot factored B coefficients ``(coefw, coefact)`` from the slots'
    sufficient statistics (linear in ``wcount``)."""
    settle = learning.settle_weight(slots.dt_since_change, cfg)
    coefw = cfg.alpha_b * settle * slots.wcount                    # (R, J)
    onehot = torch.nn.functional.one_hot(slots.action.long(), cfg.n_actions)
    return coefw, coefw[..., None] * onehot.to(torch.float32)


def _qnproj(proj: torch.Tensor, qn: torch.Tensor) -> torch.Tensor:
    """qnproj[r, j, p] = proj[r, p] · qn[r, j]."""
    return torch.bmm(qn, proj.transpose(1, 2))


def _refresh_cache(a_counts: torch.Tensor, slots: MegaSlots,
                   cfg: generative.AifConfig,
                   b_base: torch.Tensor | None = None) -> MegaCache:
    """Recompute every derived tensor from scratch (init, quarantine, warm
    promotion and the tests' full-refresh twin; the engine advances the
    cache with :func:`_advance_cache`).  ``b_base`` replaces the fresh
    sticky prior as the transition-count baseline."""
    qp = slots.q_prev.to(torch.float32)
    qn = slots.q_next.to(torch.float32)
    coefw, coefact = slot_coefficients(slots, cfg)
    sumqn = torch.sum(qn, dim=-1)                                  # (R, J)
    col0 = (cfg.b_prior_uniform + cfg.b_prior_sticky if b_base is None
            else torch.sum(b_base, dim=-2))                        # (R, A, S)
    colsum = col0 + torch.bmm((coefact * sumqn[..., None]).transpose(1, 2),
                              qp)
    proj, projsum, logna = _a_cache(a_counts, cfg.topology)
    return MegaCache(colsum=colsum, proj=proj, projsum=projsum,
                     qnproj=_qnproj(proj, qn), sumqn=sumqn, coefw=coefw,
                     coefact=coefact, logna=logna, b_base=b_base)


def _advance_cache(cache: MegaCache, a_counts: torch.Tensor,
                   slots: MegaSlots, q_prev_b: torch.Tensor,
                   q_next_b: torch.Tensor, action_b: torch.Tensor,
                   dt_b: torch.Tensor, valid: torch.Tensor,
                   cfg: generative.AifConfig) -> MegaCache:
    """Advance the cache by one boundary's replayed batch.

    ``colsum`` gains the batch's O(batch·A·S) delta (the per-tick engine's
    B-count update, summed over s'); the coefficient rows are re-evaluated
    from the bumped ``wcount`` and the A-derived rows from the updated
    ``a_counts``.  No (R, A, S, S) tensor is formed.
    """
    w = learning.settle_weight(dt_b, cfg) * valid                  # (R, n)
    oh = torch.nn.functional.one_hot(action_b.long(), cfg.n_actions).to(
        torch.float32) * w[..., None]
    sumqn_b = torch.sum(q_next_b, dim=-1)                          # (R, n)
    d_col = cfg.alpha_b * torch.bmm(
        (oh * sumqn_b[..., None]).transpose(1, 2), q_prev_b)
    qn = slots.q_next.to(torch.float32)
    coefw, coefact = slot_coefficients(slots, cfg)
    proj, projsum, logna = _a_cache(a_counts, cfg.topology)
    return MegaCache(colsum=cache.colsum + d_col, proj=proj,
                     projsum=projsum, qnproj=_qnproj(proj, qn),
                     sumqn=torch.sum(qn, dim=-1), coefw=coefw,
                     coefact=coefact, logna=logna, b_base=cache.b_base)


def init_mega_state(cfg: generative.AifConfig, r: int, n_slots: int,
                    slot_dtype: torch.dtype = torch.float32,
                    device: str | torch.device = "cuda",
                    from_agent_state=None) -> MegaFleetState:
    """Factored fleet state with ``n_slots`` (== rollout horizon) slots on
    ``device``.

    Raises if the horizon exceeds the replay capacity: the factored form
    relies on the per-tick engine's replay ring never wrapping (slot ==
    tick).

    ``from_agent_state`` promotes a trained dense per-tick
    :class:`~repro_torch.core.agent.AgentState` (the per-tick engine's
    carry, or :func:`to_agent_state`'s output) onto the mega path: its
    dense ``b_counts`` become the cache's ``b_base``, its replay entries the
    leading slots (in tick order, so the ring must not have wrapped) and
    its clock continues; it needs a uniform fleet clock.  Every tensor is
    copied, so the source stays untouched.  ``init_mega_state(
    from_agent_state=to_agent_state(s))`` is an exact round trip.
    """
    if n_slots > cfg.replay_capacity:
        raise ValueError(
            f"the mega path supports horizons up to the replay capacity "
            f"({cfg.replay_capacity}); got {n_slots} ticks — beyond that "
            f"the per-tick replay ring overwrites slots and the factored "
            f"slot==tick invariant breaks.  Raise cfg.replay_capacity or "
            f"split the run into shorter rollouts (promote the carry again "
            f"with init_mega_state(from_agent_state=to_agent_state(...)) "
            f"between them).")
    if slot_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"slot_dtype must be float32 or bfloat16, got "
                        f"{slot_dtype}")
    dev = resolve_device(device)
    topo = cfg.topology
    s, m, nb = topo.n_states, topo.n_modalities, topo.max_bins
    if from_agent_state is not None:
        return _promote(from_agent_state, cfg, r, n_slots, slot_dtype, dev)
    a0 = generative.init_generative_model(cfg, dev).a_counts
    a0 = a0.expand(r, m, nb, s).clone()
    slots = MegaSlots(
        q_prev=torch.zeros((r, n_slots, s), dtype=slot_dtype, device=dev),
        q_next=torch.zeros((r, n_slots, s), dtype=slot_dtype, device=dev),
        obs_bins=torch.zeros((r, n_slots, m), dtype=torch.int64, device=dev),
        obs_mask=torch.ones((r, n_slots, m), device=dev),
        action=torch.zeros((r, n_slots), dtype=torch.int64, device=dev),
        dt_since_change=torch.zeros((r, n_slots), device=dev),
        wcount=torch.zeros((r, n_slots), device=dev),
    )
    return MegaFleetState(
        a_counts=a0,
        slots=slots,
        cache=_refresh_cache(a0, slots, cfg),
        belief=torch.full((r, s), 1.0 / s, device=dev),
        prev_action=torch.full((r,), policies.BALANCED_ACTION,
                               dtype=torch.int64, device=dev),
        dt_since_change=torch.zeros((r,), device=dev),
        error_ema=torch.zeros((r,), device=dev),
        unstable=torch.zeros((r,), dtype=torch.bool, device=dev),
        t=torch.zeros((r,), dtype=torch.int64, device=dev),
    )


def _promote(src, cfg: generative.AifConfig, r: int, n_slots: int,
             slot_dtype: torch.dtype, dev: torch.device) -> MegaFleetState:
    """The warm branch of :func:`init_mega_state`."""
    t = src.t
    if t.shape[0] != r:
        raise ValueError(
            f"from_agent_state carries {t.shape[0]} cells, expected {r}")
    vals = torch.unique(t)
    if vals.numel() != 1:
        raise ValueError(
            "warm promotion needs a uniform fleet clock (every cell at the "
            "same t): mixed-phase fleets cannot share the slot==tick "
            "invariant")
    t_warm = int(vals[0])
    if t_warm > cfg.replay_capacity:
        raise ValueError(
            f"warm promotion at t={t_warm} > replay_capacity="
            f"{cfg.replay_capacity}: the source ring has wrapped, so its "
            f"entries no longer sit at their tick index")
    if t_warm > n_slots:
        raise ValueError(
            f"warm promotion needs n_slots >= the source clock ({t_warm}); "
            f"got {n_slots}: size the slots to the promoted fleet's whole "
            f"remaining horizon")

    def head(arr, fill, dtype):
        out = torch.full((r, n_slots) + tuple(arr.shape[2:]), fill,
                         dtype=dtype, device=dev)
        n = min(n_slots, arr.shape[1])
        out[:, :n] = arr[:, :n].to(device=dev, dtype=dtype)
        return out

    def copy(x, dtype=None):
        return x.to(device=dev, dtype=dtype or x.dtype, copy=True)

    rep = src.replay
    slots = MegaSlots(
        q_prev=head(rep.q_prev, 0.0, slot_dtype),
        q_next=head(rep.q_next, 0.0, slot_dtype),
        obs_bins=head(rep.obs_bins, 0, torch.int64),
        obs_mask=head(rep.obs_mask, 1.0, torch.float32),
        action=head(rep.action, 0, torch.int64),
        dt_since_change=head(rep.dt_since_change, 0.0, torch.float32),
        wcount=torch.zeros((r, n_slots), device=dev),
    )
    a_counts = copy(src.model.a_counts)
    return MegaFleetState(
        a_counts=a_counts,
        slots=slots,
        cache=_refresh_cache(a_counts, slots, cfg,
                             b_base=copy(src.model.b_counts)),
        belief=copy(src.belief),
        prev_action=copy(src.prev_action, torch.int64),
        dt_since_change=copy(src.dt_since_change),
        error_ema=copy(src.error_ema),
        unstable=copy(src.unstable),
        t=copy(src.t, torch.int64),
    )


def mega_state_from_numpy(arrays: dict, cfg: generative.AifConfig,
                          device: str | torch.device = "cuda",
                          slot_dtype: torch.dtype | None = None
                          ) -> MegaFleetState:
    """A :class:`MegaFleetState` from the reference's leaves.

    ``arrays`` maps each field name to a numpy array, and ``slots`` /
    ``cache`` to dicts of their own fields (``NamedTuple._asdict()`` of the
    reference state, leaves through ``np.asarray``).  Integer leaves become
    int64, ``unstable`` bool, the rest float32; the slot planes keep
    ``slot_dtype`` (None: bfloat16 if the source is bfloat16, else
    float32).  A non-None ``cache["b_base"]`` is a warm-promoted fleet's
    dense baseline.
    """
    dev = resolve_device(device)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=dev)

    def i64(x):
        return torch.tensor(np.asarray(x, np.int64), device=dev)

    sl = arrays["slots"]
    if slot_dtype is None:
        slot_dtype = (torch.bfloat16 if "bfloat16" in str(sl["q_prev"].dtype)
                      else torch.float32)
    slots = MegaSlots(
        q_prev=f32(sl["q_prev"]).to(slot_dtype),
        q_next=f32(sl["q_next"]).to(slot_dtype),
        obs_bins=i64(sl["obs_bins"]), obs_mask=f32(sl["obs_mask"]),
        action=i64(sl["action"]),
        dt_since_change=f32(sl["dt_since_change"]),
        wcount=f32(sl["wcount"]))
    b_base = arrays["cache"].get("b_base")
    cache = MegaCache(**{k: f32(arrays["cache"][k])
                         for k in MegaCache._fields if k != "b_base"},
                      b_base=None if b_base is None else f32(b_base))
    state = MegaFleetState(
        a_counts=f32(arrays["a_counts"]), slots=slots, cache=cache,
        belief=f32(arrays["belief"]), prev_action=i64(arrays["prev_action"]),
        dt_since_change=f32(arrays["dt_since_change"]),
        error_ema=f32(arrays["error_ema"]),
        unstable=torch.tensor(np.asarray(arrays["unstable"]),
                              dtype=torch.bool, device=dev),
        t=i64(arrays["t"]))
    want = (state.belief.shape[0], cfg.n_actions, cfg.topology.n_states)
    if tuple(cache.colsum.shape) != want:
        raise ValueError(f"cache.colsum has shape {tuple(cache.colsum.shape)}"
                         f", the config expects {want}")
    return state


# ------------------------------------------------------------ factored math
def _rows(x: torch.Tensor) -> torch.Tensor:
    return torch.arange(x.shape[0], device=x.device)


def factored_prior(cache: MegaCache, slots: MegaSlots, belief: torch.Tensor,
                   prev_action: torch.Tensor,
                   cfg: generative.AifConfig) -> torch.Tensor:
    """Normalized belief prior ``B_{a_prev} q`` without materializing B.

    With ``q̃ = q / colsum[a_prev]``:

      prior[t] ∝ base[t] + Σ_j pend_j · q_next_j[t],
      pend_j = coefact[j, a_prev] · (q_prev_j · q̃),

    where ``base`` is ``u·Σ_s q̃[s] + d·q̃[t]`` on a fresh fleet and the
    warm baseline's (S, S) matvec ``b_base[a_prev] q̃`` otherwise.
    """
    s = belief.shape[-1]
    rows = _rows(belief)
    qp = slots.q_prev.to(torch.float32)
    qn = slots.q_next.to(torch.float32)
    a = prev_action.long()
    qt = belief / cache.colsum[rows, a]                            # (R, S)
    cw = cache.coefact[rows, :, a]                                 # (R, J)
    pend = cw * torch.bmm(qp, qt[..., None])[..., 0]
    slot_term = torch.bmm(pend[:, None], qn)[:, 0]                 # (R, S)
    if cache.b_base is None:
        u = cfg.b_prior_uniform / s
        d = cfg.b_prior_sticky
        num = u * torch.sum(qt, -1, keepdim=True) + d * qt + slot_term
    else:
        brow = cache.b_base[rows, a]                               # (R, S, S)
        num = torch.bmm(brow, qt[..., None])[..., 0] + slot_term
    return num / torch.clamp(torch.sum(num, -1, keepdim=True), min=1e-30)


def factored_efe(cache: MegaCache, slots: MegaSlots, q: torch.Tensor,
                 logc: torch.Tensor, cost: torch.Tensor,
                 cfg: generative.AifConfig,
                 obs_mask: torch.Tensor | None = None) -> torch.Tensor:
    """G (R, A) from the factored model.

    The predicted state ``ŝ_a ∝ B_a q`` is never formed: the predicted
    observation and the ambiguity term are both linear in it, so only its
    P projections through ``cache.proj`` are computed, with the slot sum
    entering through ``qnproj``.  A warm baseline adds its dense
    contraction ``s_num[a] = b_base[a] qa[a]`` (the one path that streams
    ``b_base``).
    """
    topo = cfg.topology
    r, s = q.shape
    m, nb = topo.n_modalities, topo.max_bins
    qp = slots.q_prev.to(torch.float32)
    qa = q[:, None, :] / cache.colsum                              # (R, A, S)
    sqa = torch.sum(qa, dim=-1)                                    # (R, A)
    dots = torch.bmm(qp, qa.transpose(1, 2))                       # (R, J, A)
    pend = (cache.coefact * dots).transpose(1, 2)                  # (R, A, J)
    slot_o = torch.bmm(pend, cache.qnproj)                         # (R, A, P)
    slot_den = torch.bmm(pend, cache.sumqn[..., None])[..., 0]     # (R, A)
    if cache.b_base is None:
        u = cfg.b_prior_uniform / s
        d = cfg.b_prior_sticky
        o_num = (u * sqa[:, :, None] * cache.projsum[:, None, :]
                 + d * torch.bmm(qa, cache.proj.transpose(1, 2)) + slot_o)
        sden = torch.clamp((u * s + d) * sqa + slot_den, min=1e-30)
    else:
        a_n = qa.shape[1]
        s_num = torch.bmm(cache.b_base.reshape(r * a_n, s, s),
                          qa.reshape(r * a_n, s, 1)).reshape(r, a_n, s)
        o_num = torch.bmm(s_num, cache.proj.transpose(1, 2)) + slot_o
        sden = torch.clamp(torch.sum(s_num, dim=-1) + slot_den, min=1e-30)
    o_pred = o_num / sden[..., None]
    o_obs = o_pred[:, :, :m * nb].reshape(r, -1, m, nb)
    terms = torch.where(o_obs > 1e-20,
                        o_obs * (torch.log(torch.clamp(o_obs, min=1e-30))
                                 - logc[:, None]), 0.0)
    amb_rows = o_pred[:, :, m * nb:]                               # (R, A, M)
    if obs_mask is not None:
        terms = terms * obs_mask[:, None, :, None]
        ambiguity = torch.sum(amb_rows * obs_mask[:, None, :], dim=-1)
    else:
        ambiguity = torch.sum(amb_rows, dim=-1)
    risk = torch.sum(terms, dim=(2, 3))
    return risk + ambiguity + cost[None, :]


def _push_slot(slots: MegaSlots, idx: int | slice, q_prev, q_next,
               obs_bins, obs_mask, action, dt_since_change) -> MegaSlots:
    """Write transitions at slot ``idx`` (one column, or a slice of them
    with the values stacked on axis 1) on every router, in place."""
    for arr, val in ((slots.q_prev, q_prev), (slots.q_next, q_next),
                     (slots.obs_bins, obs_bins), (slots.obs_mask, obs_mask),
                     (slots.action, action),
                     (slots.dt_since_change, dt_since_change)):
        arr[:, idx] = val.to(arr.dtype)
    return slots


def block_window(state, params, window: tuple, row_block, graph) -> tuple:
    """A window's ``params`` and (W, R_pad, ...) ``window`` schedules cut to
    ``row_block``'s rows, the rows ``state`` holds (None: unchanged).  A
    graph window's block must be the whole fleet (one shard): several
    blocks of a graph exchange spillover every tick
    (:func:`mega_window_blocks`).  Returns (params, *window)."""
    if row_block is None:
        return (params,) + tuple(window)
    if graph is not None and \
            state.belief.shape[0] != graph.has_out.shape[0]:
        raise ValueError(
            "a graph window's spillover crosses row blocks: run every block "
            "of the window at once with mega_window_blocks")
    return batched.block_inputs(params, row_block, state.belief, window,
                                axis=1)


# -------------------------------------------------------------- hot window
def mega_window(state: MegaFleetState, est, obs_carry, params,
                arrival: torch.Tensor, hazard: torch.Tensor,
                obs_valid: torch.Tensor | None, uniforms: torch.Tensor,
                gumbel: torch.Tensor, t0: int, *,
                cfg: generative.AifConfig, disc, util_edges,
                util_period: int, dt: float, scrape_every: int,
                restart_blackout: bool, emits_mask: bool,
                forced_down=None, speed=None, row_block=None, graph=None):
    """W fused fast ticks: belief → EFE → sample → dwell → preferences → env.

    The plain PyTorch version of the CUDA kernel B3: the cache stays fixed
    for the whole window (the engine calls :func:`mega_slow_step` between
    windows).  Ticks with ``w % dwell == 0`` run the EFE and the sampling;
    the others hold the previous action.

    Args:
      obs_carry: (raw_obs, tier_util, tier_up, tier_queue, obs_mask) — the
        telemetry published by the previous tick.
      arrival / hazard / obs_valid: this window's (W, ...) schedule slices.
      uniforms: (W, 2, R, K) env restart uniforms (fire, duration).
      gumbel: (W, R, A) Gumbel noise of the action categorical.
      t0: global tick of the window's first tick; on a dwell boundary.
      forced_down / speed: optional (W, R, K) fault schedules of the
        window (admin-down tiers, service-speed multipliers).
      graph: optional :class:`repro_torch.core.graph.GraphData`: the
        env's cross-cell spillover runs in every tick, and the fifth
        (neighbor-pressure) telemetry column rides the obs carry, so the
        slots' ``obs_bins``/``obs_mask`` and ``cache.logna`` are M=5 wide.
      row_block: a shard's block ``(row_start, n_true, n_pad)`` of the
        padded fleet: the carries, ``uniforms`` and ``gumbel`` hold its
        rows alone (the shard's view of the noise, drawn at the true R),
        ``params`` and the schedules the whole padded fleet, cut to the
        block here (:func:`block_window`).

    The window's W slot pushes land in place in ``state.slots`` at columns
    ``[t0, t0 + W)`` after the loop: in-window slots carry ``coefact == 0``
    until the next boundary, so the prior and EFE never read them.

    Returns (state, env state, obs_carry, trace) with the trace tuple
    (action, weights, raw_obs, unstable, obs_frac, WindowInfo), each leaf
    stacked (W, ...) in tick order.
    """
    params, arrival, hazard, obs_valid, forced_down, speed = block_window(
        state, params, (arrival, hazard, obs_valid, forced_down, speed),
        row_block, graph)
    ctx = _WindowContext(cfg, disc, util_edges, util_period, emits_mask,
                         state.belief.device)
    ys, pushes = [], []
    for w in range(gumbel.shape[0]):
        state, push, y = ctx.agent_tick(state, obs_carry, w, t0 + w,
                                        gumbel[w])
        pushes.append(push)
        est, win = batched.fluid_window_step(
            params, est, y[1], arrival[w], hazard[w],
            (uniforms[w, 0], uniforms[w, 1]), t0 + w, dt=dt,
            scrape_every=scrape_every, obs_valid=_at(obs_valid, w),
            restart_blackout=restart_blackout,
            forced_down=_at(forced_down, w), speed=_at(speed, w),
            graph=graph)
        ys.append(y + (win,))
        obs_carry = ctx.next_carry(obs_carry, win)
    return _land_window(state, est, obs_carry, ys, pushes, t0)


def mega_window_launches(state: MegaFleetState, est, obs_carry, params,
                         arrival: torch.Tensor, hazard: torch.Tensor,
                         obs_valid: torch.Tensor | None,
                         uniforms: torch.Tensor, gumbel: torch.Tensor,
                         t0: int, *, cfg: generative.AifConfig, disc,
                         util_edges, util_period: int, dt: float,
                         scrape_every: int, restart_blackout: bool,
                         emits_mask: bool, forced_down=None, speed=None,
                         row_block=None, graph=None):
    """Plain model of kernel B3's launch split of a graph window.

    Arguments and results as :func:`mega_window`.  The window runs as the
    kernel runs it, W + 1 launches: launch i publishes tick i - 1
    (:func:`repro_torch.envsim.batched.fluid_publish`, whose spillover
    reads every cell's :class:`~repro_torch.envsim.batched.FlowMid` of
    that tick, the kernel's exchange rows), then runs tick i's agent step
    and :func:`~repro_torch.envsim.batched.fluid_flow`.  Across a launch
    boundary only what the kernel keeps in global memory survives: the
    router and env carries, the telemetry carry, the exchange rows, and
    the traces and slot pushes written so far.  Returns what
    :func:`mega_window` returns, to the bit.
    """
    inputs = block_window(state, params,
                          (arrival, hazard, obs_valid, forced_down, speed),
                          row_block, graph)
    ctx = _WindowContext(cfg, disc, util_edges, util_period, emits_mask,
                         state.belief.device)
    return _launch_split([[state, est, obs_carry, inputs, uniforms, gumbel,
                           row_block]], [ctx], t0, dt=dt,
                         scrape_every=scrape_every,
                         restart_blackout=restart_blackout, graph=graph)[0]


def mega_window_blocks(blocks: list, params, arrival: torch.Tensor,
                       hazard: torch.Tensor, obs_valid: torch.Tensor | None,
                       t0: int, *, cfg: generative.AifConfig, disc,
                       util_edges, util_period: int, dt: float,
                       scrape_every: int, restart_blackout: bool,
                       emits_mask: bool, forced_down=None, speed=None,
                       graph=None) -> list:
    """One window for every row block of a sharded fleet.

    ``blocks`` holds, in shard order, one ``(state, est, obs_carry,
    uniforms, gumbel, row_block)`` per shard (its rows, on its device);
    the other arguments are :func:`mega_window`'s, for the whole padded
    fleet.  Without a graph, or with one block, each block is one
    :func:`mega_window` on its row block.  On a graph the blocks run as
    kernel B3 runs them, launch by launch (:func:`mega_window_launches`):
    every block's launch i before any block's launch i + 1, the exchange
    read from every block's rows of the tick
    (:func:`~repro_torch.envsim.batched.block_exchange`).  Returns one
    :func:`mega_window` result per block.
    """
    kw = dict(cfg=cfg, disc=disc, util_edges=util_edges,
              util_period=util_period, dt=dt, scrape_every=scrape_every,
              restart_blackout=restart_blackout, emits_mask=emits_mask,
              forced_down=forced_down, speed=speed, graph=graph)
    if graph is None or len(blocks) == 1:
        return [mega_window(st, est, obs, params, arrival, hazard, obs_valid,
                            u, g, t0, row_block=rb, **kw)
                for st, est, obs, u, g, rb in blocks]
    runs, ctxs = [], []
    for st, est, obs, u, g, rb in blocks:
        inputs = batched.block_inputs(
            params, rb, st.belief,
            (arrival, hazard, obs_valid, forced_down, speed), axis=1)
        runs.append([st, est, obs, inputs, u, g, rb])
        ctxs.append(_WindowContext(cfg, disc, util_edges, util_period,
                                   emits_mask, st.belief.device))
    return _launch_split(runs, ctxs, t0, dt=dt, scrape_every=scrape_every,
                         restart_blackout=restart_blackout, graph=graph)


def _launch_split(runs: list, ctxs: list, t0: int, *, dt: float,
                  scrape_every: int, restart_blackout: bool, graph) -> list:
    """W + 1 launches over the row blocks ``runs`` (each ``[state, est,
    obs_carry, (params, arrival, hazard, obs_valid, forced_down, speed),
    uniforms, gumbel, row_block]``, its inputs cut to its rows): launch i
    publishes every block's tick i - 1 from the exchange over all of them,
    then runs every block's tick i up to the flow."""
    w_ticks = runs[0][5].shape[0]
    n = len(runs)
    ys = [[] for _ in runs]
    pushes = [[] for _ in runs]
    mids, tiers, y = [None] * n, [None] * n, [None] * n
    for i in range(w_ticks + 1):
        if i > 0:
            xs = ([None] * n if graph is None else batched.block_exchange(
                mids, graph, [run[6] for run in runs]))
            for b, run in enumerate(runs):
                params, arrival, _, obs_valid, forced_down, speed = run[3]
                run[1], win = batched.fluid_publish(
                    params, run[1], mids[b], tiers[b], arrival[i - 1], dt=dt,
                    obs_valid=_at(obs_valid, i - 1),
                    restart_blackout=restart_blackout,
                    forced_down=_at(forced_down, i - 1),
                    speed=_at(speed, i - 1), graph=graph, exchange=xs[b])
                ys[b].append(y[b] + (win,))
                run[2] = ctxs[b].next_carry(run[2], win)
        if i < w_ticks:
            for b, run in enumerate(runs):
                params, arrival, hazard, _, forced_down, speed = run[3]
                uniforms, gumbel = run[4], run[5]
                run[0], push, y[b] = ctxs[b].agent_tick(run[0], run[2], i,
                                                        t0 + i, gumbel[i])
                pushes[b].append(push)
                run[1], mids[b], tiers[b] = batched.fluid_flow(
                    params, run[1], y[b][1], arrival[i], hazard[i],
                    (uniforms[i, 0], uniforms[i, 1]), t0 + i, dt=dt,
                    scrape_every=scrape_every,
                    restart_blackout=restart_blackout,
                    forced_down=_at(forced_down, i), speed=_at(speed, i),
                    spill=graph is not None)
    return [_land_window(run[0], run[1], run[2], ys[b], pushes[b], t0)
            for b, run in enumerate(runs)]


def _at(x, w: int):
    return None if x is None else x[w]


class _WindowContext:
    """The tables and settings one window's agent ticks share."""

    def __init__(self, cfg, disc, util_edges, util_period, emits_mask, dev):
        topo = cfg.topology
        self.cfg, self.disc, self.topo = cfg, disc, topo
        self.util_period, self.emits_mask = util_period, emits_mask
        self.dwell = max(int(cfg.action_dwell_s / cfg.fast_period_s), 1)
        self.logc_nom, self.logc_uns = preferences.preference_log_tables(
            cfg, dev)
        self.cost = cfg.cost_weight * policies.policy_concentration_cost(
            topo, dev)
        self.edges = torch.tensor(util_edges, dtype=torch.float32,
                                  device=dev)
        self.err_ix = topo.modalities.index("error")

    def agent_tick(self, state: MegaFleetState, obs_carry, w: int,
                   t_idx: int, gumbel_w: torch.Tensor):
        """Tick ``w`` of the window up to the env: observe, belief, EFE and
        sample on selecting ticks, dwell gate.  Returns (state, the slot
        push, the trace's (action, weights, raw_obs, unstable, obs_frac))."""
        cfg, topo = self.cfg, self.topo
        raw_obs, tier_util, _, _, obs_mask = obs_carry
        mask = obs_mask if self.emits_mask else None

        # --- observe
        obs_bins = spaces.discretize_observation(raw_obs, self.disc)
        util_hml = torch.flip(tier_util, dims=(-1,))
        util_bins = torch.sum(util_hml[..., None] >= self.edges, dim=-1)
        util_valid = (t_idx % self.util_period) == 0 and t_idx > 0

        # --- adaptive preferences + evidence
        error_ema = agent_mod.masked_error_ema(
            state.error_ema, raw_obs[:, self.err_ix], cfg, mask)
        unstable = error_ema > cfg.error_trigger
        idx = obs_bins[..., None, None].expand(
            obs_bins.shape + (1, state.cache.logna.shape[-1]))
        per_mod = torch.gather(state.cache.logna, -2, idx)[..., 0, :]
        if mask is not None:
            per_mod = per_mod * mask[..., None]
        loglik = torch.sum(per_mod, dim=-2)
        if util_valid:
            loglik = loglik + belief_mod.util_log_likelihood(util_bins, topo)

        # --- belief update (factored prior, posterior guards)
        prior = factored_prior(state.cache, state.slots, state.belief,
                               state.prev_action, cfg)
        logp = loglik + torch.log(torch.clamp(prior, min=1e-30))
        logp = logp - torch.amax(logp, dim=-1, keepdim=True)
        q_unnorm = torch.exp(logp)
        q_next = q_unnorm / torch.clamp(
            torch.sum(q_unnorm, -1, keepdim=True), min=1e-30)

        # --- EFE + categorical via the Gumbel noise
        if w % self.dwell == 0:
            logc = torch.where(unstable[:, None, None], self.logc_uns,
                               self.logc_nom)
            g = factored_efe(state.cache, state.slots, q_next, logc,
                             self.cost, cfg, obs_mask=mask)
            probs = torch.softmax(-cfg.beta * g, dim=-1)
            sampled = torch.argmax(
                torch.log(torch.clamp(probs, min=1e-30)) + gumbel_w, dim=-1)
        else:
            sampled = state.prev_action

        push = (state.belief, q_next, obs_bins,
                mask if mask is not None else torch.ones_like(obs_mask),
                state.prev_action, state.dt_since_change)

        # --- dwell gate
        action, dtc = agent_mod.dwell_gate(
            state.t, state.prev_action, state.dt_since_change, sampled, cfg)
        state = state._replace(
            belief=q_next, prev_action=action, dt_since_change=dtc,
            error_ema=error_ema, unstable=unstable, t=state.t + 1)
        weights = policies.routing_weights(action, topo)
        return state, push, (action, weights, raw_obs, unstable,
                             torch.mean(obs_mask, dim=-1))

    def next_carry(self, obs_carry, win):
        """The telemetry carry after a tick's published window."""
        obs_mask = win.obs_mask if self.emits_mask else obs_carry[4]
        return (win.raw_obs, win.tier_utilization, win.tier_up,
                win.tier_queue, obs_mask)


def _land_window(state, est, obs_carry, ys, pushes, t0: int):
    """Land the window's slot block (one contiguous write per buffer) and
    stack the trace: (state, env state, obs_carry, trace)."""
    _push_slot(state.slots, slice(t0, t0 + len(pushes)),
               *(torch.stack(vals, dim=1) for vals in zip(*pushes)))
    trace = tuple(torch.stack(xs) for xs in zip(*(y[:5] for y in ys)))
    trace = trace + (batched.stack_infos([y[5] for y in ys]),)
    return state, est, obs_carry, trace


# -------------------------------------------------------------- slow update
def mega_slow_step(state: MegaFleetState, idx: torch.Tensor,
                   cfg: generative.AifConfig, *,
                   incremental: bool = True) -> MegaFleetState:
    """One slow boundary: learn A exactly from the replayed slots, bump
    their hit counts, advance the factored cache by the batch's delta.

    ``idx`` (R, batch) are the replay draws, uniform in ``[0, max(size,
    1))`` with ``size = min(t, J)`` (slot == tick, so they index slots
    directly).  ``incremental=False`` refreshes the cache from scratch (the
    mathematically identical twin).  Returns new tensors; the slot tape is
    shared with the input state.
    """
    topo = cfg.topology
    slots = state.slots
    r, j = slots.action.shape
    idx = idx.long()
    size = torch.clamp(state.t, max=j)
    valid = (size > 0).to(torch.float32)[:, None].expand(idx.shape)
    rows = _rows(idx)[:, None]
    qp_b = slots.q_prev[rows, idx].to(torch.float32)
    qn_b = slots.q_next[rows, idx].to(torch.float32)
    ob_b = slots.obs_bins[rows, idx]
    om_b = slots.obs_mask[rows, idx]
    act_b = slots.action[rows, idx]
    dt_b = slots.dt_since_change[rows, idx]

    # exact observation-model update on the gathered slots
    onehot = spaces.one_hot_observation(ob_b, topo.max_bins)       # (R,n,M,NB)
    wgt = onehot * valid[..., None, None] * om_b[..., None]
    n, m, nb = wgt.shape[1:]
    upd = torch.bmm(wgt.reshape(r, n, m * nb).transpose(1, 2), qn_b)
    a_counts = state.a_counts + cfg.alpha_a * upd.reshape(
        state.a_counts.shape)

    # slot-hit counts: the B update's sufficient statistic
    wcount = slots.wcount.clone()
    wcount.index_put_((rows.expand_as(idx), idx), valid, accumulate=True)
    slots = slots._replace(wcount=wcount)
    if incremental:
        cache = _advance_cache(state.cache, a_counts, slots, qp_b, qn_b,
                               act_b, dt_b, valid, cfg)
    else:
        cache = _refresh_cache(a_counts, slots, cfg,
                               b_base=state.cache.b_base)
    return state._replace(a_counts=a_counts, slots=slots, cache=cache)


# ---------------------------------------------------------------- watchdog
def mega_watchdog_bad(state: MegaFleetState) -> torch.Tensor:
    """(R,) bool — cells whose factored carry has diverged numerically:
    a posterior that is not a finite distribution, non-finite observation
    pseudo-counts or column sums, or a non-finite error EMA."""
    r = state.belief.shape[0]

    def rows_finite(a):
        return torch.all(torch.isfinite(a.reshape(r, -1)), dim=-1)

    ok = (rows_finite(state.belief)
          & torch.all(state.belief >= 0.0, dim=-1)
          & (torch.abs(torch.sum(state.belief, dim=-1) - 1.0) <= 0.5)
          & rows_finite(state.a_counts)
          & rows_finite(state.cache.colsum)
          & torch.isfinite(state.error_ema))
    return ~ok


def mega_quarantine(state: MegaFleetState, bad: torch.Tensor,
                    cfg: generative.AifConfig) -> MegaFleetState:
    """Reinit the flagged cells to priors; healthy cells unchanged.

    A bad cell's belief returns to uniform, its pseudo-counts to the fresh
    prior and its slots are cleared (a NaN slot would re-poison the next A
    update through ``NaN * 0``); its cache rows are recomputed from the
    cleaned rows.  A warm-promoted cell's baseline returns to the fresh
    dense prior too (the baseline is part of the possibly poisoned model).
    ``t`` is untouched: slot index == global tick is a fleet-wide
    invariant.  Every tensor is written **in place** at the flagged rows.
    """
    rows = torch.nonzero(bad).flatten()
    sl = state.slots
    fresh = init_mega_state(cfg, int(rows.numel()), sl.action.shape[1],
                            sl.q_prev.dtype, state.belief.device)
    if state.cache.b_base is not None:
        fresh = fresh._replace(cache=_refresh_cache(
            fresh.a_counts, fresh.slots, cfg,
            b_base=_dense_prior(cfg, state.belief.device).expand(
                (rows.numel(),) + state.cache.b_base.shape[1:])))

    def reset_all(olds, news):
        for old, new in zip(olds, news):
            if old is not None:
                old[rows] = new.to(old.dtype)

    reset_all(state.slots, fresh.slots)
    reset_all(state.cache, fresh.cache)
    reset_all((state.a_counts, state.belief, state.prev_action,
               state.dt_since_change, state.error_ema, state.unstable),
              (fresh.a_counts, fresh.belief, fresh.prev_action,
               fresh.dt_since_change, fresh.error_ema, fresh.unstable))
    return state


# ----------------------------------------------------------------- densify
def _dense_prior(cfg: generative.AifConfig,
                 device: torch.device) -> torch.Tensor:
    """The fresh sticky prior as one dense (S, S) count matrix."""
    s = cfg.topology.n_states
    return (cfg.b_prior_uniform / s
            + cfg.b_prior_sticky * torch.eye(s, device=device))


def to_agent_state(state: MegaFleetState,
                   cfg: generative.AifConfig) -> agent_mod.AgentState:
    """Densify the factored carry into a batched per-tick
    :class:`~repro_torch.core.agent.AgentState`: the (R, A, S, S) transition
    counts (the baseline — the sticky prior or a warm promotion's
    ``b_base`` — plus the slots' weighted outer products) and the replay
    ring.  Expensive by design; for interop and tests, not the hot loop."""
    topo = cfg.topology
    slots = state.slots
    r, j = slots.action.shape
    s, a_n = topo.n_states, cfg.n_actions
    dev = state.belief.device
    qp = slots.q_prev.to(torch.float32)
    qn = slots.q_next.to(torch.float32)
    if state.cache.b_base is None:
        base_rows = [_dense_prior(cfg, dev)] * a_n
    else:
        base_rows = [state.cache.b_base[:, a] for a in range(a_n)]
    coefact = state.cache.coefact                                 # (R, J, A)
    # one action at a time keeps the peak temp at (R, J, S), not (R, A, S, S)
    b_counts = torch.stack(
        [base_rows[a]
         + torch.bmm((coefact[:, :, a, None] * qn).transpose(1, 2), qp)
         for a in range(a_n)], dim=1)

    cap = cfg.replay_capacity

    def pad(arr, fill):
        tail = torch.full((r, cap - j) + tuple(arr.shape[2:]), fill,
                          dtype=arr.dtype, device=dev)
        return torch.cat([arr, tail], dim=1)

    replay = learning.ReplayBuffer(
        q_prev=pad(qp, 0.0), q_next=pad(qn, 0.0),
        obs_bins=pad(slots.obs_bins, 0), obs_mask=pad(slots.obs_mask, 1.0),
        action=pad(slots.action, 0),
        dt_since_change=pad(slots.dt_since_change, 0.0),
        cursor=torch.clamp(state.t, max=j) % cap,
        size=torch.clamp(state.t, max=cap))
    c_nom = generative.nominal_c_log(cfg, dev)
    c_uns = generative.unstable_c_log(cfg, dev)
    model = generative.GenerativeModel(
        a_counts=state.a_counts,
        b_counts=b_counts,
        c_log=torch.where(state.unstable[:, None, None], c_uns, c_nom),
        d_prior=torch.full((r, s), 1.0 / s, device=dev))
    return agent_mod.AgentState(
        model=model, cache=generative.derive_cache(model, topo),
        belief=state.belief, replay=replay, prev_action=state.prev_action,
        dt_since_change=state.dt_since_change, error_ema=state.error_ema,
        unstable=state.unstable, t=state.t)
