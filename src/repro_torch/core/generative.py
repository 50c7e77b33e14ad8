"""Generative model of AIF-Router (paper §4.2): A, B, C (+ initial prior D).

Observation model **A** — ``p(o_t | s_t)`` per modality, an
``(max_bins, n_states)`` likelihood (padded bins carry zero mass), stored as
Dirichlet pseudo-counts.  Transition model **B** — ``p(s_{t+1} | s_t, a)``,
one column-stochastic ``(n_states, n_states)`` matrix per action
(``B[a][s', s]``), also pseudo-counts, initialized with a weak
sticky-identity prior.  Preferences **C** — per-modality log-preferences over
observation bins (see :mod:`repro_torch.core.preferences`).

Every function takes tensors with any leading batch shape; the fleet passes
the (R, ...)-batched model directly.  All shapes derive from
``AifConfig.topology``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import policies, spaces
from repro_torch.core.topology import Topology, default_topology


class GenerativeModel(NamedTuple):
    """Learnable pseudo-count parameters + current preferences."""

    a_counts: torch.Tensor   # (..., M, max_bins, S) Dirichlet counts
    b_counts: torch.Tensor   # (..., A, S, S) Dirichlet counts
    c_log: torch.Tensor      # (..., M, max_bins) log-preferences
    d_prior: torch.Tensor    # (..., S) initial state prior


class ModelCache(NamedTuple):
    """Normalized tensors derived from the pseudo-counts.

    The paper's 1 s / 10 s timescale separation makes the generative model
    quasi-static: A and B counts change only on slow-update ticks, so
    everything derived from them is computed once per slow period by
    :func:`derive_cache` and read by the fast loop.  Any write to
    ``a_counts`` / ``b_counts`` must be paired with a :func:`derive_cache`
    refresh (``agent.slow_step`` is the single in-loop writer).
    """

    nb: torch.Tensor     # (..., A, S, S) normalized transitions p(s'|s,a)
    na: torch.Tensor     # (..., M, max_bins, S) normalized observations p(o|s)
    amb: torch.Tensor    # (..., S) per-state ambiguity Σ_m H[A_m(·|s)]
    amb_m: torch.Tensor  # (..., M, S) per-modality ambiguity H[A_m(·|s)]


@dataclasses.dataclass(frozen=True)
class AifConfig:
    """Static hyper-parameters (all defaults = paper values)."""

    topology: Topology = dataclasses.field(default_factory=default_topology)

    # Action selection (paper §4.3)
    beta: float = 5.0                     # softmax inverse temperature
    cost_weight: float = 0.2              # scale of Cost(a) regularizer
    # Re-evaluate the policy every `action_dwell_s` seconds while observing
    # at 1 Hz (the settle-weighted learning needs actions to persist).
    action_dwell_s: float = 5.0
    # Beyond-paper information-gain bonus; the fused kernel drops it.
    novelty_weight: float = 0.0

    # Online learning (paper §4.4)
    alpha_a: float = 0.05                 # A pseudo-count learning rate
    alpha_b: float = 0.05                 # B pseudo-count learning rate
    replay_capacity: int = 5000           # replay buffer size
    replay_batch: int = 100               # transitions sampled per slow update
    settle_midpoint_s: float = 2.0        # sigmoid weight w(dt)=1/(1+e^-(dt-2)/2)
    settle_scale_s: float = 2.0
    fast_period_s: float = 1.0            # belief update cadence
    slow_period_s: float = 10.0           # model learning cadence

    # Priors
    a_prior_count: float = 1.0            # uniform Dirichlet prior on A
    b_prior_uniform: float = 0.1          # uniform floor on B columns
    b_prior_sticky: float = 1.0           # identity (stay-put) prior on B

    # Preferences (log space, by modality name)
    c_latency: tuple[float, float, float] = (0.0, -1.5, -4.0)
    c_rps: tuple[float, float, float] = (-1.0, -0.25, 0.0)
    c_queue: tuple[float, float, float] = (0.0, -1.0, -3.0)
    c_error_ok: tuple[float, float] = (0.0, -3.0)      # nominal: mild avoidance
    c_error_unstable: tuple[float, float] = (0.0, -11.5)  # instability: strong
    error_trigger: float = 0.15           # error-rate threshold for adaptation
    latency_relax_factor: float = 0.3     # relax C_latency under instability
    error_ema_halflife_s: float = 20.0    # smoothing of the observed error rate

    # Numerical watchdog: before every engine tick the incoming carry is
    # checked for divergence and flagged cells are quarantined back to
    # their priors (see repro_torch.core.fleet.fleet_watchdog_bad).
    watchdog: bool = True

    @property
    def n_states(self) -> int:
        return self.topology.n_states

    @property
    def n_actions(self) -> int:
        return policies.n_actions(self.topology)


def _fit_prefs(prefs: tuple[float, ...], n_bins: int) -> tuple[float, ...]:
    """Truncate / extend a preference tuple to exactly ``n_bins`` entries
    (the tail repeats the last, most extreme, preference)."""
    if not prefs:
        return tuple(0.0 for _ in range(n_bins))
    return (prefs + (prefs[-1],) * n_bins)[:n_bins]


def _modality_prefs(cfg: AifConfig, name: str,
                    n_bins: int) -> tuple[float, ...]:
    """Nominal preference row for one modality (flat for unknown names)."""
    table = {"latency": cfg.c_latency, "rps": cfg.c_rps,
             "queue": cfg.c_queue, "error": cfg.c_error_ok}
    return _fit_prefs(tuple(table.get(name, ())), n_bins)


def _nominal_c_rows(cfg: AifConfig) -> np.ndarray:
    topo = cfg.topology
    rows = np.full((topo.n_modalities, topo.max_bins), -30.0, dtype=np.float32)
    for m, name in enumerate(topo.modalities):
        prefs = _modality_prefs(cfg, name, topo.n_bins[m])
        rows[m, : len(prefs)] = prefs
    return rows


def nominal_c_log(cfg: AifConfig,
                  device: torch.device | str) -> torch.Tensor:
    """(M, max_bins) nominal log-preferences, padded bins = -30."""
    return torch.tensor(_nominal_c_rows(cfg), device=device)


def unstable_c_log(cfg: AifConfig,
                   device: torch.device | str) -> torch.Tensor:
    """Log-preferences during instability: deep error avoidance, relaxed lat."""
    topo = cfg.topology
    rows = _nominal_c_rows(cfg).copy()
    for m, name in enumerate(topo.modalities):
        if name == "latency":
            prefs = _modality_prefs(cfg, name, topo.n_bins[m])
            rows[m, : len(prefs)] = (
                np.asarray(prefs, dtype=np.float32) * cfg.latency_relax_factor)
        elif name == "error":
            prefs = _fit_prefs(tuple(cfg.c_error_unstable), topo.n_bins[m])
            rows[m, : len(prefs)] = prefs
    return torch.tensor(rows, device=device)


def init_generative_model(cfg: AifConfig,
                          device: torch.device | str
                          ) -> GenerativeModel:
    """Paper-faithful initialization: uniform A, weakly-sticky B, uniform D."""
    topo = cfg.topology
    s, a_n = topo.n_states, policies.n_actions(topo)
    mask = spaces.bins_mask_np(topo)
    a0 = cfg.a_prior_count * mask[:, :, None] * np.ones(
        (topo.n_modalities, topo.max_bins, s), dtype=np.float32)
    b0 = (cfg.b_prior_uniform / s
          + cfg.b_prior_sticky * np.eye(s, dtype=np.float32))
    d0 = np.full((s,), 1.0 / s, dtype=np.float32)
    return GenerativeModel(
        a_counts=torch.tensor(a0, device=device),
        b_counts=torch.tensor(b0, device=device).expand(a_n, s, s).clone(),
        c_log=nominal_c_log(cfg, device),
        d_prior=torch.tensor(d0, device=device),
    )


# ---------------------------------------------------------------------------
# Normalization helpers (pseudo-counts -> distributions)
# ---------------------------------------------------------------------------
def normalize_a(a_counts: torch.Tensor, topo: Topology) -> torch.Tensor:
    """p(o_m = i | s): normalize counts over bins per (modality, state)."""
    mask = spaces.bins_mask(topo, a_counts.device)[:, :, None]
    counts = a_counts * mask
    denom = torch.sum(counts, dim=-2, keepdim=True)
    return counts / torch.clamp(denom, min=1e-30)


def normalize_b(b_counts: torch.Tensor) -> torch.Tensor:
    """p(s' | s, a): normalize counts over s' per (action, s) column."""
    denom = torch.sum(b_counts, dim=-2, keepdim=True)     # sum over s'
    return b_counts / torch.clamp(denom, min=1e-30)


def c_probs(c_log: torch.Tensor, topo: Topology) -> torch.Tensor:
    """Normalized preference distribution σ(C) per modality (padded bins
    carry zero mass)."""
    mask = spaces.bins_mask(topo, c_log.device) > 0
    return torch.softmax(torch.where(mask, c_log, float("-inf")), dim=-1)


def masked_log_c(c_log: torch.Tensor, topo: Topology) -> torch.Tensor:
    """``log σ(C)`` per modality, padded bins clamped to a finite -60 floor
    (they carry zero predicted mass, so the value never contributes)."""
    mask = spaces.bins_mask(topo, c_log.device) > 0
    logits = torch.where(mask, c_log, float("-inf"))
    logc = torch.log_softmax(logits, dim=-1)
    return torch.where(mask, logc, -60.0)


def modality_ambiguity_from_normalized(na: torch.Tensor,
                                       topo: Topology) -> torch.Tensor:
    """Per-modality conditional observation entropy H[A_m(· | s)]:
    (..., M, max_bins, S) -> (..., M, S)."""
    mask = spaces.bins_mask(topo, na.device)[:, :, None] > 0
    ent = torch.where(mask, na * torch.log(torch.clamp(na, min=1e-16)), 0.0)
    return -torch.sum(ent, dim=-2)


def ambiguity_from_normalized(na: torch.Tensor,
                              topo: Topology) -> torch.Tensor:
    """Σ_m H[A_m(· | s)] per state from a normalized A ((..., S))."""
    return torch.sum(modality_ambiguity_from_normalized(na, topo), dim=-2)


def masked_ambiguity(amb_m: torch.Tensor,
                     obs_mask: torch.Tensor) -> torch.Tensor:
    """Effective per-state ambiguity ``Σ_m mask_m · H[A_m(·|s)]`` — a dark
    modality delivers no information, so its entropy drops out.

    Args:
      amb_m: (..., M, S) per-modality ambiguity (``ModelCache.amb_m``).
      obs_mask: (..., M) float validity mask.
    """
    return torch.sum(amb_m * obs_mask[..., None], dim=-2)


def derive_cache(model: GenerativeModel, topo: Topology) -> ModelCache:
    """Normalize the quasi-static model once (called on slow-update ticks)."""
    na = normalize_a(model.a_counts, topo)
    amb_m = modality_ambiguity_from_normalized(na, topo)
    return ModelCache(
        nb=normalize_b(model.b_counts),
        na=na,
        amb=torch.sum(amb_m, dim=-2),
        amb_m=amb_m,
    )
