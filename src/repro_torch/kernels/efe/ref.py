"""Plain PyTorch versions of the fleet EFE kernels.

Inputs are *normalized* distributions (the kernel fuses the inference-time
hot path, not the pseudo-count normalization, which runs on the slow loop):

  b_norm: (R, A, S, S) — p(s'|s,a) per router, column-stochastic over s'.
  q:      (R, S)       — current beliefs.
  a_norm: (R, M, NB, S) — p(o_m=b | s) per router (padded bins are zero).
  logc:   (R, M, NB)   — log σ(C) preference distributions (padded -60).
  amb:    (R, S)       — per-state ambiguity (mask-effective when masked).
  cost:   (A,)         — policy concentration regularizer.

Output: G (R, A) — expected free energy per router × action:
  ŝ_a = B_a q;  ô = A ŝ_a;  risk = Σ ô·(log ô − logC);  G = risk + ŝ_a·amb + cost.

``obs_mask`` ((R, M) float 0/1) drops masked modalities from the risk term;
the fused ``loglik`` then arrives mask-zeroed.  ``obs_mask=None`` is the
unmasked program.  These are what the CUDA kernel
(:mod:`repro_torch.kernels.efe.efe`) is held against, and what its wrapper
runs for tensors on the CPU.  Their steps (:func:`propagate`,
:func:`posterior`, :func:`posterior_from_logp`, :func:`risk_ambiguity`)
take any leading axes and are also the single-agent belief update and EFE
of :mod:`repro_torch.core`.
"""
from __future__ import annotations

import torch


def gather_prev_b(nb: torch.Tensor, prev_action: torch.Tensor) -> torch.Tensor:
    """(R, S', S) transition row of each router's currently applied action
    (a copy, as the reference's ``take_along_axis`` makes)."""
    rows = torch.arange(nb.shape[0], device=nb.device)
    return nb[rows, prev_action.long()]


def propagate(b: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Renormalized one-step prediction ``B q``: b (..., S', S) and q
    (..., S) over broadcast leading axes -> (..., S')."""
    p = torch.matmul(b, q[..., None])[..., 0]
    return p / torch.clamp(torch.sum(p, -1, keepdim=True), min=1e-30)


def posterior_from_logp(logp: torch.Tensor) -> torch.Tensor:
    """Normalize a log-posterior (..., S) into a distribution."""
    logp = logp - torch.amax(logp, dim=-1, keepdim=True)
    q = torch.exp(logp)
    return q / torch.clamp(torch.sum(q, -1, keepdim=True), min=1e-30)


def posterior(prior: torch.Tensor, loglik: torch.Tensor) -> torch.Tensor:
    """Normalized ``exp(loglik) * prior`` over the last axis (Eq. 2)."""
    return posterior_from_logp(loglik + torch.log(torch.clamp(prior,
                                                              min=1e-30)))


def risk_ambiguity(s_pred: torch.Tensor, a_norm: torch.Tensor,
                   logc: torch.Tensor, amb: torch.Tensor,
                   obs_mask: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Risk and ambiguity of Eq. 1 from the predicted states ŝ_a
    (..., A, S): ô = A ŝ_a, risk = Σ ô·(log ô − logC) over the bins ô
    reaches (padded bins predict 0 and drop out), ambiguity = ŝ_a·amb.
    Shapes as in the module docstring, over any leading axes."""
    m, nbin = a_norm.shape[-3:-1]
    o_pred = torch.matmul(s_pred, a_norm.flatten(-3, -2).transpose(-1, -2)
                          ).unflatten(-1, (m, nbin))          # (..., A, M, NB)
    terms = torch.where(o_pred > 1e-20,
                        o_pred * (torch.log(torch.clamp(o_pred, min=1e-30))
                                  - logc[..., None, :, :]), 0.0)
    if obs_mask is not None:
        terms = terms * obs_mask[..., None, :, None]
    risk = torch.sum(terms, dim=(-2, -1))
    return risk, torch.matmul(s_pred, amb[..., :, None])[..., 0]


def efe_fleet_ref(b_norm: torch.Tensor, q: torch.Tensor, a_norm: torch.Tensor,
                  logc: torch.Tensor, amb: torch.Tensor, cost: torch.Tensor,
                  obs_mask: torch.Tensor | None = None) -> torch.Tensor:
    s_pred = propagate(b_norm, q[:, None, :])                     # (R, A, S)
    risk, ambiguity = risk_ambiguity(s_pred, a_norm, logc, amb, obs_mask)
    return risk + ambiguity + cost[None, :]


def belief_posterior_ref(b_prev: torch.Tensor, q_prev: torch.Tensor,
                         loglik: torch.Tensor) -> torch.Tensor:
    """Batched Bayesian belief update (paper Eq. 2), the belief half of the
    fused tick, also the whole of a held (non-selecting) tick.

      b_prev: (R, S, S) — the previously applied action's transition row.
      q_prev: (R, S)    — belief before the tick.
      loglik: (R, S)    — log p(o_t|s) summed over modalities (+ any gated
              utilization-scrape evidence).
    """
    return posterior(propagate(b_prev, q_prev), loglik)


def belief_efe_fleet_ref(b_prev: torch.Tensor, q_prev: torch.Tensor,
                         loglik: torch.Tensor, b_norm: torch.Tensor,
                         a_norm: torch.Tensor, logc: torch.Tensor,
                         amb: torch.Tensor, cost: torch.Tensor,
                         obs_mask: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused belief update → EFE, one tick (paper Eq. 2 then Eq. 1).

    Returns (G (R, A), q (R, S)).
    """
    q = belief_posterior_ref(b_prev, q_prev, loglik)
    return efe_fleet_ref(b_norm, q, a_norm, logc, amb, cost, obs_mask), q
