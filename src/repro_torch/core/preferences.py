"""Adaptive preference adjustment (paper §4.2).

When the smoothed error rate exceeds 15%, AIF-Router deepens the
error-avoidance preference ``C_e`` from −3.0 to −11.5 (log space) and relaxes
the latency preference ``C_ℓ``; when it recovers, nominal preferences are
restored.  The error rate is smoothed with an exponential moving average.
"""
from __future__ import annotations

import torch

from repro_torch.core import generative


def ema_update(error_ema: torch.Tensor, error_rate: torch.Tensor,
               cfg: generative.AifConfig) -> torch.Tensor:
    """One fast-loop EMA step of the observed error rate."""
    decay = 0.5 ** (cfg.fast_period_s / cfg.error_ema_halflife_s)
    return decay * error_ema + (1.0 - decay) * error_rate


def adapt_preferences(error_ema: torch.Tensor, cfg: generative.AifConfig
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (c_log (..., M, B), unstable (...)) for the smoothed error
    rate; both tables are materialized and selected per router."""
    unstable = error_ema > cfg.error_trigger
    dev = error_ema.device
    c_nom = generative.nominal_c_log(cfg, dev)
    c_uns = generative.unstable_c_log(cfg, dev)
    cond = unstable.reshape(unstable.shape + (1, 1))
    return torch.where(cond, c_uns, c_nom), unstable


def preference_log_tables(cfg: generative.AifConfig,
                          device: torch.device | str
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Both masked log-σ(C) tables, precomputed: (nominal, unstable)."""
    topo = cfg.topology
    return (generative.masked_log_c(generative.nominal_c_log(cfg, device),
                                    topo),
            generative.masked_log_c(generative.unstable_c_log(cfg, device),
                                    topo))
