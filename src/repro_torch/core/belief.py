"""Fast-loop Bayesian state inference (paper §4.4, Eq. 2).

Every second the router updates its belief over the hidden states:

    q(s_t | o_{1:t})  ∝  p(o_t | s_t) · p(s_t | o_{1:t-1})
    p(s_t | o_{1:t-1}) = B_{a_{t-1}} · q(s_{t-1})

The likelihood factorizes over the observation modalities.  Every function
takes an explicit leading batch shape (the fleet passes (R, ...)).  A
masked modality (``obs_mask`` 0) contributes zero log-evidence — the
Bayesian treatment of a missing observation.
"""
from __future__ import annotations

import torch

from repro_torch.core import generative, spaces
from repro_torch.core.topology import Topology
from repro_torch.kernels.efe.ref import posterior, propagate
from repro_torch.kernels.efe.ref import posterior_from_logp  # noqa: F401

#: Misreading probability of the utilization scrape (paper §3): the scrape
#: reads a tier's level right with probability ``1 - UTIL_SCRAPE_EPS``.
UTIL_SCRAPE_EPS = 0.15


def _action_row(x: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """``x[..., action, :, :]`` per leading index: (..., A, S', S) and
    (...) actions -> (..., S', S)."""
    idx = action.long().reshape(action.shape + (1, 1, 1)).expand(
        action.shape + (1,) + tuple(x.shape[-2:]))
    return torch.gather(x, -3, idx)[..., 0, :, :]


def predict_prior(b_counts: torch.Tensor, belief: torch.Tensor,
                  prev_action: torch.Tensor) -> torch.Tensor:
    """One-step state prediction ``B_a · q`` (the filter's prior), from the
    pseudo-counts: only the applied action's (S', S) row is normalized."""
    row = _action_row(b_counts, prev_action)
    b = row / torch.clamp(torch.sum(row, dim=-2, keepdim=True), min=1e-30)
    return propagate(b, belief)


def prior_from_normalized(b_row: torch.Tensor,
                          belief: torch.Tensor) -> torch.Tensor:
    """``B_a · q`` for an already-normalized (..., S', S) transition row and
    (..., S) beliefs, renormalized."""
    return propagate(b_row, belief)


def log_likelihood(a_counts: torch.Tensor, obs_bins: torch.Tensor,
                   topo: Topology,
                   obs_mask: torch.Tensor | None = None) -> torch.Tensor:
    """``log p(o_t | s)`` for every state from the pseudo-counts, summed
    over modalities (masked modalities contribute zero)."""
    na = generative.normalize_a(a_counts, topo)
    return log_likelihood_from_normalized(na, obs_bins, obs_mask)


def log_likelihood_from_normalized(na: torch.Tensor,
                                   obs_bins: torch.Tensor,
                                   obs_mask: torch.Tensor | None = None
                                   ) -> torch.Tensor:
    """``log p(o_t | s)`` summed over modalities, from a normalized A.

    Args:
      na: (..., M, max_bins, S) normalized observation model.
      obs_bins: (..., M) int observation bin per modality.
      obs_mask: optional (..., M) float validity mask; a masked modality's
        log-likelihood row is zeroed (uniform evidence).
    Returns:
      (..., S) log-likelihood.
    """
    idx = obs_bins.long()[..., None, None].expand(
        obs_bins.shape + (1, na.shape[-1]))
    per_modality = torch.gather(na, -2, idx)[..., 0, :]     # (..., M, S)
    logp = torch.log(torch.clamp(per_modality, min=1e-16))
    if obs_mask is not None:
        logp = logp * obs_mask[..., None]
    return torch.sum(logp, dim=-2)


def util_log_likelihood(util_bins: torch.Tensor, topo: Topology,
                        eps: float = UTIL_SCRAPE_EPS) -> torch.Tensor:
    """Log-likelihood of the 10-second per-tier utilization scrape (paper §3).

    The per-tier state factors are the discretized utilizations, so the
    scrape is a noisy direct reading of state factors 2..2+K:
    ``p(û = b | s) = 1-eps`` if the factor level matches, else spread over
    the other levels.

    Args:
      util_bins: (..., K) int utilization bins in state-factor order
        (heaviest tier first).
    Returns:
      (..., S) log-likelihood.
    """
    k = topo.n_tiers
    tbl = torch.tensor(spaces.state_factor_table(topo)[:, 2:2 + k],
                       device=util_bins.device)               # (S, K)
    match = tbl == util_bins[..., None, :].to(tbl.dtype)     # (..., S, K)
    p = torch.where(match, 1.0 - eps, eps / (topo.n_levels - 1))
    return torch.sum(torch.log(p), dim=-1)


def update_belief(model: generative.GenerativeModel,
                  belief: torch.Tensor,
                  prev_action: torch.Tensor,
                  obs_bins: torch.Tensor,
                  topo: Topology,
                  util_bins: torch.Tensor | None = None,
                  util_valid: bool | torch.Tensor = False,
                  cache: generative.ModelCache | None = None,
                  obs_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Posterior ``q(s_t) ∝ p(o_t|s_t) · B_{a_{t-1}} q(s_{t-1})`` (Eq. 2),
    batched over any leading axes of ``belief`` (..., S).

    With ``cache`` the pre-normalized tensors are read instead of
    re-normalizing the pseudo-counts.  A fresh utilization scrape
    (``util_valid``, a bool or a (...) bool tensor) adds its likelihood.
    With *every* modality masked and no scrape, the Bayesian answer is the
    renormalized prior, returned directly so a fully dark tick cannot turn a
    borderline prior into a 0/0 posterior.
    """
    if cache is not None:
        prior = propagate(_action_row(cache.nb, prev_action), belief)
        loglik = log_likelihood_from_normalized(cache.na, obs_bins, obs_mask)
    else:
        prior = predict_prior(model.b_counts, belief, prev_action)
        loglik = log_likelihood(model.a_counts, obs_bins, topo, obs_mask)
    valid = torch.as_tensor(util_valid, device=belief.device)
    if util_bins is not None:
        loglik = loglik + torch.where(valid[..., None],
                                      util_log_likelihood(util_bins, topo),
                                      0.0)
    q = posterior(prior, loglik)
    if obs_mask is not None:
        all_masked = torch.sum(obs_mask, dim=-1) <= 0
        if util_bins is not None:
            all_masked = all_masked & ~valid
        fallback = prior / torch.clamp(torch.sum(prior, dim=-1, keepdim=True),
                                       min=1e-30)
        q = torch.where(all_masked[..., None], fallback, q)
    return q


def belief_entropy(belief: torch.Tensor) -> torch.Tensor:
    """Shannon entropy of the belief over the last axis (monitoring)."""
    p = torch.clamp(belief, 1e-16, 1.0)
    return -torch.sum(p * torch.log(p), dim=-1)
