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

from repro_torch.core import spaces
from repro_torch.core.topology import Topology

#: Misreading probability of the utilization scrape (paper §3): the scrape
#: reads a tier's level right with probability ``1 - UTIL_SCRAPE_EPS``.
UTIL_SCRAPE_EPS = 0.15


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


def posterior_from_logp(logp: torch.Tensor) -> torch.Tensor:
    """Normalize a log-posterior (..., S) into a distribution."""
    logp = logp - torch.amax(logp, dim=-1, keepdim=True)
    q = torch.exp(logp)
    return q / torch.clamp(torch.sum(q, dim=-1, keepdim=True), min=1e-30)


def belief_entropy(belief: torch.Tensor) -> torch.Tensor:
    """Shannon entropy of the belief over the last axis (monitoring)."""
    p = torch.clamp(belief, 1e-16, 1.0)
    return -torch.sum(p * torch.log(p), dim=-1)
