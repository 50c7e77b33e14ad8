"""State / action / observation space design (paper §4.1), topology-generic.

State space: ``s_t = (ell, r, u_{K-1}, ..., u_0)`` — latency level,
request-rate level and one hidden per-tier utilization level per tier
(reverse tier order, heaviest first), each over ``topology.n_levels``
levels; ``|S| = 3^5 = 243`` for the paper's 3-tier topology.  States are
flattened row-major with the latency level as the most-significant digit.

Observation space: every second the router observes the topology's metric
modalities (default ``(p95_latency, rps, queue_depth, error_rate)``), each
discretized into its bin count.  Modalities are stored padded to
``topology.max_bins`` bins with a validity mask; padded bins carry zero
probability everywhere.

Action space: discrete routing policies over the K-tier weight simplex, see
:mod:`repro_torch.core.policies`.
"""
from __future__ import annotations

import dataclasses
import functools
import numpy as np
import torch

from repro_torch.core.topology import Topology


# ---------------------------------------------------------------------------
# Observation-bin mask
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def bins_mask_np(topo: Topology) -> np.ndarray:
    """(n_modalities, max_bins) float32 mask of valid observation bins."""
    mask = np.zeros((topo.n_modalities, topo.max_bins), dtype=np.float32)
    for m, nb in enumerate(topo.n_bins):
        mask[m, :nb] = 1.0
    mask.setflags(write=False)
    return mask


def bins_mask(topo: Topology,
              device: torch.device | str) -> torch.Tensor:
    """(n_modalities, max_bins) mask of valid observation bins on ``device``."""
    return torch.tensor(bins_mask_np(topo), device=device)


# ---------------------------------------------------------------------------
# State indexing
# ---------------------------------------------------------------------------
def state_index(levels, topo: Topology) -> int:
    """Flatten a factor-level tuple into a state index in [0, n_states)."""
    idx = 0
    for lv in levels:
        idx = idx * topo.n_levels + int(lv)
    return idx


def state_levels(index, topo: Topology) -> torch.Tensor:
    """Inverse of :func:`state_index`: (...) int indices -> (...,
    n_state_factors) int64 levels, latency level first."""
    index = torch.as_tensor(index)
    digits = []
    for f in range(topo.n_state_factors):
        power = topo.n_levels ** (topo.n_state_factors - 1 - f)
        digits.append((index // power) % topo.n_levels)
    return torch.stack(digits, dim=-1)


@functools.lru_cache(maxsize=None)
def state_factor_table(topo: Topology) -> np.ndarray:
    """(n_states, n_state_factors) int table: level of each factor per state."""
    tbl = np.zeros((topo.n_states, topo.n_state_factors), dtype=np.int32)
    for s in range(topo.n_states):
        x = s
        for f in reversed(range(topo.n_state_factors)):
            tbl[s, f] = x % topo.n_levels
            x //= topo.n_levels
    tbl.setflags(write=False)
    return tbl


# ---------------------------------------------------------------------------
# Observation discretization
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DiscretizationConfig:
    """Bin edges mapping raw metrics -> observation bins.

    Defaults are calibrated to the paper's testbed scale (P50 ~2-3 s at
    50 RPS on ResNet-50 CPU tiers).  ``latency_edges_s = (1.0, 3.0)`` means
    p95 < 1 s -> bin 0 (low), < 3 s -> bin 1 (medium), else bin 2 (high).
    For non-default modality sets pass ``edges`` explicitly — one edge tuple
    per modality, in the topology's modality order.
    """

    latency_edges_s: tuple[float, float] = (1.0, 3.0)
    rps_edges: tuple[float, float] = (48.0, 62.0)
    queue_edges: tuple[float, float] = (20.0, 80.0)
    error_edges: tuple[float, ...] = (0.15,)   # 2 bins: low / high error
    edges: tuple[tuple[float, ...], ...] | None = None   # generic override

    def modality_edges(self) -> tuple[tuple[float, ...], ...]:
        if self.edges is not None:
            return self.edges
        return (self.latency_edges_s, self.rps_edges,
                self.queue_edges, self.error_edges)

    def as_padded_edges(self, device: torch.device | str
                        ) -> torch.Tensor:
        """(n_modalities, max_edges) float32 edge table padded with +inf."""
        all_edges = self.modality_edges()
        width = max(len(e) for e in all_edges)
        rows = [list(e) + [np.inf] * (width - len(e)) for e in all_edges]
        return torch.tensor(rows, dtype=torch.float32, device=device)


def discretize_observation(raw: torch.Tensor,
                           cfg: DiscretizationConfig) -> torch.Tensor:
    """Map raw metric values (..., M) to per-modality bin ids (..., M).

    Out-of-range values clamp to the edge bins explicitly: a ``+inf``
    metric would otherwise count the +inf padding edges too and index past
    the modality's last real bin; ``NaN`` compares false everywhere and
    lands in bin 0.
    """
    raw = raw.to(torch.float32)
    edges = cfg.as_padded_edges(raw.device)              # (M, width)
    bins = torch.sum(raw[..., :, None] >= edges, dim=-1)
    top_bin = torch.tensor([len(e) for e in cfg.modality_edges()],
                           device=raw.device)
    return torch.minimum(bins, top_bin)


def one_hot_observation(obs_bins: torch.Tensor,
                        max_bins: int) -> torch.Tensor:
    """(..., M) int bins -> (..., M, max_bins) float one-hot."""
    ar = torch.arange(max_bins, device=obs_bins.device)
    return (obs_bins[..., None] == ar).to(torch.float32)
