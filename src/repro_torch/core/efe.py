"""Expected free energy (paper §4.3, Eq. 1): the breakdown type.

    G(a) = Risk(a) + Ambiguity(a) + Cost(a),   p(a) ∝ exp(−β · G(a))

The fleet computes G through the fused kernel
(:mod:`repro_torch.kernels.efe`); the single-agent oracle of the reference
(``repro.core.efe.expected_free_energy``) comes with the unfused path.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class EfeBreakdown(NamedTuple):
    g: torch.Tensor             # (..., A) expected free energy
    risk: torch.Tensor          # (..., A)
    ambiguity: torch.Tensor     # (..., A)
    cost: torch.Tensor          # (..., A)
    action_probs: torch.Tensor  # (..., A) softmax(−β G)
