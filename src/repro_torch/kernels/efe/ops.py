"""Public wrappers of the fleet EFE kernel stack.

* ``fleet_efe`` adapts a batched generative model (pseudo-counts) into the
  kernel's normalized inputs.
* ``fleet_efe_cached`` / ``fleet_belief_efe`` take the quasi-static
  :class:`~repro_torch.core.generative.ModelCache` tensors that
  ``agent.slow_step`` refreshes once per slow period, so the fast loop never
  re-materializes a normalized (R, A, S, S) transition stack;
  ``fleet_belief_efe`` also fuses the belief update (Eq. 2) into the same
  launch.
* ``fleet_belief_posterior`` is the belief update alone (held ticks).
* ``mega_window`` runs W fused ticks of the whole-window engine path, and
  ``mega_window_blocks`` one window for every row block of a sharded
  fleet.

The device of the tensors decides between the CUDA kernel and its plain
PyTorch version (see :mod:`repro_torch.kernels.efe.efe` and
:mod:`repro_torch.kernels.efe.mega`).
"""
from __future__ import annotations

import torch

from repro_torch.core import generative, policies
from repro_torch.core import mega as mega_core
from repro_torch.kernels.efe import efe, ref
from repro_torch.kernels.efe import mega as mega_kernel


def _cost(cfg: generative.AifConfig, device: torch.device) -> torch.Tensor:
    return cfg.cost_weight * policies.policy_concentration_cost(
        cfg.topology, device)


def fleet_belief_posterior(nb: torch.Tensor, beliefs: torch.Tensor,
                           prev_action: torch.Tensor,
                           loglik: torch.Tensor) -> torch.Tensor:
    """Cached-model belief update alone (held ticks — no EFE launch)."""
    return ref.belief_posterior_ref(ref.gather_prev_b(nb, prev_action),
                                    beliefs, loglik)


def _normalized_inputs(a_counts: torch.Tensor, b_counts: torch.Tensor,
                       c_log: torch.Tensor, cfg: generative.AifConfig):
    """Batched (R, ...) counts -> kernel inputs (normalized, fused terms)."""
    topo = cfg.topology
    na = generative.normalize_a(a_counts, topo)
    nb = generative.normalize_b(b_counts)
    logc = generative.masked_log_c(c_log, topo)
    amb = generative.ambiguity_from_normalized(na, topo)
    return nb, na, logc, amb


def fleet_efe_cached(nb: torch.Tensor, na: torch.Tensor, logc: torch.Tensor,
                     amb: torch.Tensor, beliefs: torch.Tensor,
                     cfg: generative.AifConfig, *,
                     obs_mask: torch.Tensor | None = None) -> torch.Tensor:
    """G (R, A) from pre-normalized (cached) model tensors.

    Args:
      nb:   (R, A, S, S) normalized transitions (``ModelCache.nb``).
      na:   (R, M, max_bins, S) normalized observations (``ModelCache.na``).
      logc: (R, M, max_bins) masked log σ(C).
      amb:  (R, S) per-state ambiguity; with ``obs_mask`` the
        mask-effective one (:func:`generative.masked_ambiguity`).
      beliefs: (R, S) posteriors.
      obs_mask: optional (R, M) observation-validity mask.
    """
    return efe.efe_fleet(nb, beliefs, na, logc, amb, _cost(cfg, nb.device),
                         obs_mask)


def fleet_belief_efe(nb: torch.Tensor, na: torch.Tensor, logc: torch.Tensor,
                     amb: torch.Tensor, beliefs: torch.Tensor,
                     prev_action: torch.Tensor, loglik: torch.Tensor,
                     cfg: generative.AifConfig, *,
                     obs_mask: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused belief update → EFE for one fleet tick.

    Same cached inputs as :func:`fleet_efe_cached` plus ``beliefs`` (R, S)
    before the tick, ``prev_action`` (R,) int64 and ``loglik`` (R, S) — the
    observation log-likelihood, mask-zeroed under partial observability.

    Returns (G (R, A), posterior (R, S)).
    """
    return efe.belief_efe_fleet(nb, prev_action.long(), beliefs, loglik, na,
                                logc, amb, _cost(cfg, nb.device), obs_mask)


def fleet_efe(a_counts: torch.Tensor, b_counts: torch.Tensor,
              c_log: torch.Tensor, beliefs: torch.Tensor,
              cfg: generative.AifConfig, *,
              obs_mask: torch.Tensor | None = None) -> torch.Tensor:
    """G (R, A) for a fleet of routers, from raw pseudo-counts.

    Args:
      a_counts: (R, M, max_bins, S) observation-model pseudo-counts.
      b_counts: (R, A, S, S) transition pseudo-counts.
      c_log:    (R, M, max_bins) current log-preferences.
      beliefs:  (R, S) posteriors.
      obs_mask: optional (R, M) observation-validity mask.
    """
    nb, na, logc, amb = _normalized_inputs(a_counts, b_counts, c_log, cfg)
    if obs_mask is not None:
        amb_m = generative.modality_ambiguity_from_normalized(na,
                                                              cfg.topology)
        amb = generative.masked_ambiguity(amb_m, obs_mask)
    return fleet_efe_cached(nb, na, logc, amb, beliefs, cfg,
                            obs_mask=obs_mask)


def mega_window(state, est, obs_carry, params,
                arrival: torch.Tensor, hazard: torch.Tensor,
                obs_valid: torch.Tensor | None, uniforms: torch.Tensor,
                gumbel: torch.Tensor, t0: int, *,
                cfg: generative.AifConfig, disc, util_edges,
                util_period: int, dt: float, scrape_every: int,
                restart_blackout: bool, emits_mask: bool,
                forced_down=None, speed=None, row_block=None, graph=None):
    """One whole window: W fused fast ticks of the mega engine path.

    Arguments and results are those of
    :func:`repro_torch.core.mega.mega_window`.  CPU tensors run that plain
    version; CUDA tensors run kernel B3
    (:func:`repro_torch.kernels.efe.mega.mega_window_cuda`), which raises on
    what it does not take — a CUDA tensor never reaches the plain version.
    """
    kw = dict(cfg=cfg, disc=disc, util_edges=util_edges,
              util_period=util_period, dt=dt, scrape_every=scrape_every,
              restart_blackout=restart_blackout, emits_mask=emits_mask,
              forced_down=forced_down, speed=speed, row_block=row_block,
              graph=graph)
    fn = (mega_core.mega_window if state.belief.device.type == "cpu"
          else mega_kernel.mega_window_cuda)
    return fn(state, est, obs_carry, params, arrival, hazard, obs_valid,
              uniforms, gumbel, t0, **kw)


def mega_window_blocks(blocks: list, params, arrival: torch.Tensor,
                       hazard: torch.Tensor, obs_valid: torch.Tensor | None,
                       t0: int, **kw) -> list:
    """One window for every row block of a sharded fleet.

    Arguments and results are those of
    :func:`repro_torch.core.mega.mega_window_blocks`.  Blocks on the CPU
    run that plain version; blocks on CUDA run kernel B3
    (:func:`repro_torch.kernels.efe.mega.mega_window_blocks_cuda`), a
    graph window launch by launch across the blocks.
    """
    fn = (mega_core.mega_window_blocks
          if blocks[0][0].belief.device.type == "cpu"
          else mega_kernel.mega_window_blocks_cuda)
    return fn(blocks, params, arrival, hazard, obs_valid, t0, **kw)
