"""Expected free energy (paper §4.3, Eq. 1): the breakdown type.

    G(a) = Risk(a) + Ambiguity(a) + Cost(a),   p(a) ∝ exp(−β · G(a))

The fused fleet computes G through kernel B1
(:mod:`repro_torch.kernels.efe`).  :func:`expected_free_energy` is the
single-agent computation of the reference (``repro/core/efe.py``), batched
over any leading axes, with risk, ambiguity and cost split out; the
single-agent tick (:func:`repro_torch.core.agent.tick`) and the serving
router use it, through the steps of the fleet's plain version
(:mod:`repro_torch.kernels.efe.ref`).  The action categorical takes its
Gumbel noise as an operand: ``argmax(log p + gumbel)`` is what
``jax.random.categorical`` computes from its key.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import generative, policies
from repro_torch.kernels.efe import ref


class EfeBreakdown(NamedTuple):
    g: torch.Tensor             # (..., A) expected free energy
    risk: torch.Tensor          # (..., A)
    ambiguity: torch.Tensor     # (..., A)
    cost: torch.Tensor          # (..., A)
    action_probs: torch.Tensor  # (..., A) softmax(−β G)


def expected_free_energy(model: generative.GenerativeModel,
                         belief: torch.Tensor,
                         cfg: generative.AifConfig,
                         cache: generative.ModelCache | None = None,
                         obs_mask: torch.Tensor | None = None
                         ) -> EfeBreakdown:
    """G(a) for all candidate actions (Eq. 1), beliefs (..., S).

    With ``cache`` the quasi-static normalized model (nb, na, amb) is read;
    only the preference term, which follows the per-tick ``c_log``, is
    computed fresh.  ``obs_mask`` ((..., M) float 0/1) drops a dark
    modality's risk and ambiguity.
    """
    topo = cfg.topology
    if cache is not None:
        nb, na, amb_s, amb_m = cache.nb, cache.na, cache.amb, cache.amb_m
    else:
        nb = generative.normalize_b(model.b_counts)
        na = generative.normalize_a(model.a_counts, topo)
        amb_m = generative.modality_ambiguity_from_normalized(na, topo)
        amb_s = torch.sum(amb_m, dim=-2)
    s_pred = ref.propagate(nb, belief[..., None, :])                # (.., A, S)
    logc = torch.log(torch.clamp(generative.c_probs(model.c_log, topo),
                                 min=1e-16))                        # (.., M, B)
    if obs_mask is not None:
        amb_s = generative.masked_ambiguity(amb_m, obs_mask)
    risk, ambiguity = ref.risk_ambiguity(s_pred, na, logc, amb_s, obs_mask)

    cost = cfg.cost_weight * policies.policy_concentration_cost(
        topo, belief.device)
    g = risk + ambiguity + cost
    probs = torch.softmax(-cfg.beta * g, dim=-1)
    return EfeBreakdown(g=g, risk=risk, ambiguity=ambiguity,
                        cost=cost.expand(g.shape), action_probs=probs)


def select_action(gumbel: torch.Tensor,
                  model: generative.GenerativeModel,
                  belief: torch.Tensor,
                  cfg: generative.AifConfig,
                  cache: generative.ModelCache | None = None,
                  obs_mask: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, EfeBreakdown]:
    """Sample ``a ~ softmax(−β G)`` as ``argmax(log p + gumbel)`` with the
    (..., A) Gumbel noise given.  Returns (action, EfeBreakdown)."""
    bd = expected_free_energy(model, belief, cfg, cache, obs_mask)
    logits = torch.log(torch.clamp(bd.action_probs, min=1e-30))
    return torch.argmax(logits + gumbel, dim=-1), bd
