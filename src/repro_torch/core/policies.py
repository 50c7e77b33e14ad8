"""Generated discrete routing-policy sets (paper §4.1, Action Space).

An action specifies routing weights ``(w_0, ..., w_{K-1})`` over the
topology's K tiers (lightest → heaviest).  The paper predefines 20 discrete
policies for its 3-tier testbed (1 balanced, 5 heavy-, 4 medium- and 4
light-biased, 6 adaptive/exploratory).  Rather than hard-coding those rows,
this module *generates* the table for any
:class:`~repro_torch.core.topology.Topology` from the family structure the
paper's table follows (balanced + per-tier concentration ramps + pairwise
splits + soft concentrations + optional simplex lattice, see
:class:`~repro_torch.core.topology.PolicySpec`); the default 3-tier topology
reproduces the paper's 20 rows exactly.

The table itself is host-side numpy; :func:`policy_table`,
:func:`routing_weights` and :func:`policy_concentration_cost` hand it to
PyTorch on the caller's device.
"""
from __future__ import annotations

import functools
import itertools
import math

import numpy as np
import torch

from repro_torch.core.topology import PolicySpec, Topology

BALANCED_ACTION = 0  # the balanced row always generates first


# ------------------------------------------------------------------ families
def balanced_weights(k: int) -> np.ndarray:
    """Near-uniform row: two-decimal rounding, remainder on the heaviest
    tier — ``(0.33, 0.33, 0.34)`` for K=3, matching the paper.

    For large K (where ``(k-1)·round(1/k, 2)`` drifts toward or past 1) it
    falls back to the exact uniform split.
    """
    w = np.full(k, round(1.0 / k, 2), dtype=np.float64)
    w[-1] = 1.0 - w[:-1].sum()
    if w[-1] < 0.5 / k or w[-1] > 2.0 / k:
        return np.full(k, 1.0 / k, dtype=np.float64)
    return w


def _ramp_rows(k: int, tier: int, spec: PolicySpec) -> list[np.ndarray]:
    """Concentration ramp on ``tier``: remainder split equally over the other
    tiers, with ``neighbor_shift`` moved from the farthest to the nearest
    tier (no shift when the extremes tie, e.g. the middle tier of 3)."""
    levels = sorted(spec.ramp_levels)
    if tier == k - 1 and spec.heavy_extra_level is not None:
        levels = sorted(set(levels) | {spec.heavy_extra_level})
    overrides = {(t, lv): row for t, lv, row in spec.ramp_overrides
                 if len(row) == k}   # pins are dimension-specific
    rows = []
    for c in levels:
        if (tier, c) in overrides:
            rows.append(np.asarray(overrides[(tier, c)], np.float64))
            continue
        w = np.full(k, (1.0 - c) / max(k - 1, 1), dtype=np.float64)
        w[tier] = c
        others = [i for i in range(k) if i != tier]
        if len(others) > 1:
            dist = [abs(i - tier) for i in others]
            near, far = others[int(np.argmin(dist))], others[int(np.argmax(dist))]
            if abs(near - tier) != abs(far - tier):
                delta = min(spec.neighbor_shift, w[far])
                w[far] -= delta
                w[near] += delta
        rows.append(w)
    return rows


def _pair_rows(k: int, spec: PolicySpec) -> list[np.ndarray]:
    if k < 3:
        return []   # a pair split needs a third tier to carry the remainder
    rest = (1.0 - 2.0 * spec.pair_weight) / (k - 2)
    rows = []
    for i, j in itertools.combinations(range(k), 2):
        w = np.full(k, rest, dtype=np.float64)
        w[i] = w[j] = spec.pair_weight
        rows.append(w)
    return rows


def _soft_rows(k: int, spec: PolicySpec) -> list[np.ndarray]:
    rows = []
    for tier in range(k):
        w = np.full(k, (1.0 - spec.soft_weight) / max(k - 1, 1),
                    dtype=np.float64)
        w[tier] = spec.soft_weight
        rows.append(w)
    return rows


def _lattice_rows(k: int, resolution: int) -> list[np.ndarray]:
    """All compositions of ``resolution`` into K parts, as simplex points."""
    rows = []
    for comp in itertools.combinations_with_replacement(range(k), resolution):
        w = np.zeros(k, dtype=np.float64)
        for i in comp:
            w[i] += 1.0 / resolution
        rows.append(w)
    return rows


@functools.lru_cache(maxsize=None)
def generate_policy_table(topo: Topology) -> np.ndarray:
    """(A, K) float32 routing-weight table generated from the topology.

    Family order: balanced, biased ramps (heaviest tier first), pairwise
    splits, soft concentrations, optional simplex lattice.  Duplicate rows
    are dropped (first occurrence wins).  Cached per topology; read-only.
    """
    k, spec = topo.n_tiers, topo.policy_spec
    rows: list[np.ndarray] = [balanced_weights(k)]
    for tier in range(k - 1, -1, -1):
        rows.extend(_ramp_rows(k, tier, spec))
    rows.extend(_pair_rows(k, spec))
    rows.extend(_soft_rows(k, spec))
    if spec.lattice_resolution > 0:
        rows.extend(_lattice_rows(k, spec.lattice_resolution))

    table: list[np.ndarray] = []
    for w in rows:
        w = np.round(w, 6)
        if abs(w.sum() - 1.0) > 1e-6 or (w < -1e-12).any():
            raise ValueError(
                f"policy spec {spec} generates an invalid simplex row {w} "
                f"for K={k} (weights must be >= 0 and sum to 1); check the "
                f"family parameters (ramp_levels / pair_weight / "
                f"soft_weight / ramp_overrides)")
        if not any(np.allclose(w, t, atol=1e-6) for t in table):
            table.append(w)
    out = np.asarray(table, dtype=np.float32)
    out.setflags(write=False)
    return out


# ----------------------------------------------------------------- accessors
def n_actions(topo: Topology) -> int:
    """Number of generated policies A for this topology (20 for the paper)."""
    return generate_policy_table(topo).shape[0]


def policy_table(topo: Topology,
                 device: torch.device | str) -> torch.Tensor:
    """(A, K) float32 routing-weight table on ``device``."""
    return torch.tensor(generate_policy_table(topo), device=device)


def routing_weights(action: torch.Tensor, topo: Topology) -> torch.Tensor:
    """Routing weights (..., K) for a tensor of action indices."""
    return policy_table(topo, action.device)[action.long()]


def policy_concentration_cost(topo: Topology,
                              device: torch.device | str
                              ) -> torch.Tensor:
    """Per-action regularization Cost(a) (paper Eq. 1, third term), (A,).

    Penalizes extreme routing policies: ``log(K) - H(w)``, the entropy gap
    to the uniform split.  Zero for the balanced policy, ``log K`` for full
    concentration on one tier.
    """
    w = torch.clamp(policy_table(topo, device), 1e-12, 1.0)
    ent = -torch.sum(w * torch.log(w), dim=-1)
    return math.log(float(topo.n_tiers)) - ent
