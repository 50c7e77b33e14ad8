"""Slow-loop online model learning (paper §4.4).

Every 10 seconds each router batch-updates its generative model from a
replay buffer of recent transitions:

* observation model A — ``A[m][o_m, :] += α · q(s_t)`` per replayed
  transition; masked (stale/missing) modalities accumulate no counts,
* transition model B — ``B[a] += α_B · w(Δt) · q(s_{t+1}) q(s_t)^T`` with the
  sigmoid settle weight ``w(Δt) = 1 / (1 + e^{−(Δt−2)/2})``,
* replay buffer — ring buffer of 5000 transitions; each slow update samples
  a batch of 100 uniformly over the valid entries.

Every function is batched over the leading router axis R.  The replay ring
and the pseudo-counts are large (at R=1024 the ring alone is ~10 GB), so
:func:`push_transition`, :func:`update_observation_model` and
:func:`update_transition_model` write into their input tensors in place.

The sampling randomness is an operand: :func:`sample_batch` takes the
(R, batch) raw indices drawn by the caller's noise source.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import generative, spaces
from repro_torch.core.topology import Topology


class ReplayBuffer(NamedTuple):
    """Fixed-capacity ring buffer of transitions, one ring per router."""

    q_prev: torch.Tensor      # (..., cap, S) posterior at t
    q_next: torch.Tensor      # (..., cap, S) posterior at t+1
    obs_bins: torch.Tensor    # (..., cap, M) int64 observation at t+1
    obs_mask: torch.Tensor    # (..., cap, M) float32 validity of each modality
    action: torch.Tensor      # (..., cap) int64 action taken at t
    dt_since_change: torch.Tensor  # (..., cap) float32 s since action change
    cursor: torch.Tensor      # (...) int64 next write slot
    size: torch.Tensor        # (...) int64 number of valid entries


def init_replay(capacity: int, topo: Topology,
                device: torch.device | str) -> ReplayBuffer:
    """An empty single-router ring."""
    s, m = topo.n_states, topo.n_modalities
    return ReplayBuffer(
        q_prev=torch.zeros((capacity, s), device=device),
        q_next=torch.zeros((capacity, s), device=device),
        obs_bins=torch.zeros((capacity, m), dtype=torch.int64, device=device),
        obs_mask=torch.ones((capacity, m), device=device),
        action=torch.zeros((capacity,), dtype=torch.int64, device=device),
        dt_since_change=torch.zeros((capacity,), device=device),
        cursor=torch.zeros((), dtype=torch.int64, device=device),
        size=torch.zeros((), dtype=torch.int64, device=device),
    )


def push_transition(buf: ReplayBuffer,
                    q_prev: torch.Tensor,
                    q_next: torch.Tensor,
                    obs_bins: torch.Tensor,
                    action: torch.Tensor,
                    dt_since_change: torch.Tensor,
                    obs_mask: torch.Tensor | None = None) -> ReplayBuffer:
    """Write one transition per router at its ring cursor.

    Batched over R: ``q_prev``/``q_next`` (R, S), ``obs_bins`` (R, M),
    ``action``/``dt_since_change`` (R,), ``obs_mask`` (R, M) or None (all
    modalities fresh).  The ring tensors are written **in place**; the
    returned buffer shares them and carries the advanced cursor and size.
    """
    cap = buf.q_prev.shape[-2]
    rows = torch.arange(q_prev.shape[0], device=q_prev.device)
    i = buf.cursor
    if obs_mask is None:
        obs_mask = torch.ones(obs_bins.shape, device=q_prev.device)
    buf.q_prev[rows, i] = q_prev
    buf.q_next[rows, i] = q_next
    buf.obs_bins[rows, i] = obs_bins.long()
    buf.obs_mask[rows, i] = obs_mask.to(torch.float32)
    buf.action[rows, i] = action.long()
    buf.dt_since_change[rows, i] = dt_since_change.to(torch.float32)
    return buf._replace(cursor=(i + 1) % cap,
                        size=torch.clamp(buf.size + 1, max=cap))


def settle_weight(dt: torch.Tensor, cfg: generative.AifConfig) -> torch.Tensor:
    """Sigmoid settle weight ``w(Δt) = 1/(1+exp(−(Δt − mid)/scale))``."""
    return torch.sigmoid((dt - cfg.settle_midpoint_s) / cfg.settle_scale_s)


def sample_batch(buf: ReplayBuffer, idx: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Replay indices and validity weights for one slow update.

    ``idx`` (R, batch) are the raw uniform draws in ``[0, max(size, 1))``
    from the caller's noise source (the reference draws them with
    ``jax.random.randint``).  Returns (ring indices, (R, batch) validity
    weight); an empty ring weighs every sample 0, making the update a no-op.
    """
    cap = buf.q_prev.shape[-2]
    valid = (buf.size > 0).to(torch.float32)[..., None].expand(idx.shape)
    return idx.long() % cap, valid


def update_observation_model(a_counts: torch.Tensor,
                             q_next: torch.Tensor,
                             obs_bins: torch.Tensor,
                             weight: torch.Tensor,
                             cfg: generative.AifConfig,
                             obs_mask: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """Batched ``A[m][o_m, :] += α · q(s)``, **in place** on ``a_counts``.

    Args:
      a_counts: (R, M, max_bins, S).
      q_next:   (R, n, S) posteriors.
      obs_bins: (R, n, M) observed bins.
      weight:   (R, n) 0/1 validity weights.
      obs_mask: optional (R, n, M) per-modality validity.
    """
    w = spaces.one_hot_observation(obs_bins, cfg.topology.max_bins)
    w = w * weight[..., None, None]                          # (R, n, M, B)
    if obs_mask is not None:
        w = w * obs_mask[..., None]
    r, n, m, b = w.shape
    upd = torch.bmm(w.reshape(r, n, m * b).transpose(1, 2), q_next)
    return a_counts.add_(upd.reshape(a_counts.shape).mul_(cfg.alpha_a))


def update_transition_model(b_counts: torch.Tensor,
                            q_prev: torch.Tensor,
                            q_next: torch.Tensor,
                            action: torch.Tensor,
                            dt_since_change: torch.Tensor,
                            weight: torch.Tensor,
                            cfg: generative.AifConfig) -> torch.Tensor:
    """Batched ``B[a] += α_B · w(Δt) · q_next q_prev^T``, **in place** on
    ``b_counts`` (R, A, S, S); the other operands are (R, n, ...)."""
    w = settle_weight(dt_since_change, cfg) * weight          # (R, n)
    n_act = b_counts.shape[-3]
    a_onehot = torch.nn.functional.one_hot(action.long(), n_act).to(
        q_prev.dtype) * w[..., None]                          # (R, n, A)
    # (R, A, n, S') weighted successors, contracted with (R, n, S) over n
    lhs = a_onehot.transpose(1, 2)[..., None] * q_next[:, None]
    upd = torch.matmul(lhs.transpose(-1, -2), q_prev[:, None])
    return b_counts.add_(upd.mul_(cfg.alpha_b))


def slow_update(model: generative.GenerativeModel,
                buf: ReplayBuffer,
                idx: torch.Tensor,
                cfg: generative.AifConfig,
                learn: torch.Tensor | None = None
                ) -> generative.GenerativeModel:
    """One 10-second learning step: replay batch update of A and B.

    ``idx`` are the (R, batch) raw replay draws (see :func:`sample_batch`);
    ``learn`` optionally gates the update per router ((R,) bool) — a router
    with ``learn`` False adds zero counts.  Counts are updated in place.
    """
    ring_idx, valid = sample_batch(buf, idx)
    if learn is not None:
        valid = valid * learn.to(valid.dtype)[:, None]
    rows = torch.arange(ring_idx.shape[0], device=ring_idx.device)[:, None]
    q_prev = buf.q_prev[rows, ring_idx]
    q_next = buf.q_next[rows, ring_idx]
    obs = buf.obs_bins[rows, ring_idx]
    mask = buf.obs_mask[rows, ring_idx]
    act = buf.action[rows, ring_idx]
    dts = buf.dt_since_change[rows, ring_idx]
    a_new = update_observation_model(model.a_counts, q_next, obs, valid, cfg,
                                     obs_mask=mask)
    b_new = update_transition_model(model.b_counts, q_prev, q_next, act, dts,
                                    valid, cfg)
    return model._replace(a_counts=a_new, b_counts=b_new)
