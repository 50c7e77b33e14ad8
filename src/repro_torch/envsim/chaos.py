"""Fault-injection vocabulary for chaos campaigns on the fleet engine.

The paper claims stable online learning *despite device instability*; the
base scenario registry (:mod:`repro_torch.envsim.scenarios`) only exercises that
through per-window restart hazards and telemetry masks.  This module adds
the fault classes real deployments are defined by, each as a composable
:class:`~repro_torch.envsim.scenarios.Profile` primitive:

* :func:`zone_outage` — correlated multi-cell outages: a *zone* (contiguous
  cell grouping) loses selected tiers for a fixed interval via the
  ``forced_down`` schedule, independent of the probabilistic restart
  machinery (and therefore able to outlive ``restart_max_s``),
* :func:`straggler_episodes` — latency inflation without liveness loss:
  random (cell, tier) episodes where the service-speed multiplier drops
  below 1, shrinking capacity and inflating latency,
* :func:`capacity_flap` — a square-wave service-speed flap (periodic
  brown-outs) on selected tiers,
* :func:`crash_restart_storm` — a renewal process of crash/repair cycles
  with configurable MTTF/MTTR per (cell, tier), drawn host-side with numpy
  so the whole storm is a static ``forced_down`` schedule,
* :func:`long_outage` — a single outage on a cell subset whose duration
  dwarfs the restart machinery's ``restart_max_s``.

Everything compiles to static (T, R, K) host-side numpy schedules that
the env indexes per window (:func:`repro_torch.envsim.batched.make_env_step`);
this module is the reference's ``repro/envsim/chaos.py`` carried over as
code, so the schedules are equal to the reference's to the bit.  Importing
it registers the presets below into
:data:`repro_torch.envsim.scenarios.SCENARIOS`; :data:`CHAOS_INFO`
records, per preset, the uninjured *control* scenario and the fault window
— the two ingredients of the recovery metrics
(:mod:`repro_torch.api.experiment`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.envsim import scenarios
from repro_torch.envsim.scenarios import (Profile, compile_scenario, compose,
                                    paper_bursts)


def _zone_ids(n_cells: int, n_zones: int) -> np.ndarray:
    """Contiguous zone assignment: cell r -> zone (r * n_zones) // n_cells."""
    if n_zones < 1:
        raise ValueError(f"n_zones must be >= 1, got {n_zones}")
    return (np.arange(n_cells) * n_zones) // max(n_cells, 1)


# ----------------------------------------------------------------- primitives
def zone_outage(n_windows: int, n_cells: int, window_s: float = 1.0,
                start_s: float = 60.0, duration_s: float = 30.0,
                zone: int = 0, n_zones: int = 2,
                tiers: tuple[int, ...] = (0, 1),
                n_tiers: int = 3) -> Profile:
    """A correlated zone failure: every cell of ``zone`` loses ``tiers``.

    Cells are grouped into ``n_zones`` contiguous zones; during
    [``start_s``, ``start_s + duration_s``) the selected tiers of the
    affected zone are administratively down — arrivals refused, in-system
    mass killed, liveness probe down.  Leaving at least one tier (the
    cloud tier by default) up keeps a recovery path for the router.
    """
    fd = np.zeros((n_windows, n_cells, n_tiers), np.float32)
    k0 = int(start_s / window_s)
    k1 = int((start_s + duration_s) / window_s)
    cells = _zone_ids(n_cells, n_zones) == zone
    for tier in tiers:
        fd[max(k0, 0):max(k1, 0), cells, tier] = 1.0
    return Profile(forced_down=fd)


def straggler_episodes(n_windows: int, n_cells: int, window_s: float = 1.0,
                       every_s: float = 60.0, len_s: float = 15.0,
                       slowdown: float = 0.25, frac: float = 0.5,
                       seed: int = 0, n_tiers: int = 3) -> Profile:
    """Straggler episodes: latency inflation without any liveness loss.

    A ``frac`` subset of cells independently enters episodes (exponential
    gaps of mean ``every_s``, fixed length ``len_s``) during which one
    random tier serves at ``slowdown`` × its nominal speed — capacity
    shrinks and latency inflates but the tier stays up and keeps emitting
    telemetry, the classic gray-failure signature.
    """
    if not 0.0 < slowdown <= 1.0:
        raise ValueError(f"slowdown must be in (0, 1], got {slowdown}")
    rng = np.random.default_rng(seed)
    sp = np.ones((n_windows, n_cells, n_tiers), np.float32)
    flen = max(int(round(len_s / window_s)), 1)
    for r in range(n_cells):
        if rng.random() >= frac:
            continue
        t = rng.exponential(every_s) / window_s
        while t < n_windows:
            k0 = int(t)
            tier = int(rng.integers(n_tiers))
            sp[k0:k0 + flen, r, tier] = slowdown
            t = k0 + flen + rng.exponential(every_s) / window_s
    return Profile(speed=sp)


def capacity_flap(n_windows: int, n_cells: int, window_s: float = 1.0,
                  period_s: float = 20.0, duty: float = 0.5,
                  factor: float = 0.3, tiers: tuple[int, ...] = (0,),
                  n_tiers: int = 3) -> Profile:
    """A square-wave capacity flap: selected tiers periodically brown out.

    For the first ``duty`` fraction of every ``period_s`` cycle the tier
    serves at ``factor`` × nominal speed — a flapping autoscaler or a
    noisy co-tenant periodically stealing the cores.
    """
    t = (np.arange(n_windows, dtype=np.float64) + 0.5) * window_s
    phase = (t % period_s) / period_s
    low = phase < duty
    sp = np.ones((n_windows, n_cells, n_tiers), np.float32)
    for tier in tiers:
        sp[low, :, tier] = factor
    return Profile(speed=sp)


def crash_restart_storm(n_windows: int, n_cells: int, window_s: float = 1.0,
                        mttf_s: float = 40.0, mttr_s: float = 8.0,
                        tiers: tuple[int, ...] = (0, 1), seed: int = 0,
                        n_tiers: int = 3) -> Profile:
    """Crash/repair renewal process with configurable MTTF/MTTR.

    Each selected (cell, tier) alternates exponentially-distributed up
    intervals (mean ``mttf_s``) with exponentially-distributed repair
    intervals (mean ``mttr_s``), drawn host-side — the storm is one static
    ``forced_down`` schedule, reproducible from ``seed``.
    """
    rng = np.random.default_rng(seed)
    fd = np.zeros((n_windows, n_cells, n_tiers), np.float32)
    horizon = n_windows * window_s
    for r in range(n_cells):
        for tier in tiers:
            t = rng.exponential(mttf_s)
            while t < horizon:
                repair = max(rng.exponential(mttr_s), window_s)
                k0, k1 = int(t / window_s), int((t + repair) / window_s) + 1
                fd[k0:min(k1, n_windows), r, tier] = 1.0
                t = t + repair + rng.exponential(mttf_s)
    return Profile(forced_down=fd)


def long_outage(n_windows: int, n_cells: int, window_s: float = 1.0,
                start_s: float | None = None, duration_s: float | None = None,
                cells: tuple[int, ...] | None = None,
                tiers: tuple[int, ...] = (0, 1),
                n_tiers: int = 3) -> Profile:
    """An outage that outlives the restart machinery (>> ``restart_max_s``).

    Defaults: the first quarter of the fleet loses its edge tiers for 40%
    of the horizon starting at 30% — long enough that no probabilistic
    restart cycle could model it.
    """
    horizon = n_windows * window_s
    start_s = 0.3 * horizon if start_s is None else start_s
    duration_s = 0.4 * horizon if duration_s is None else duration_s
    fd = np.zeros((n_windows, n_cells, n_tiers), np.float32)
    k0 = int(start_s / window_s)
    k1 = int((start_s + duration_s) / window_s)
    rows = (list(range(max(n_cells // 4, 1))) if cells is None
            else list(cells))
    for tier in tiers:
        fd[max(k0, 0):max(k1, 0), rows, tier] = 1.0
    return Profile(forced_down=fd)


# ------------------------------------------------------------------- registry
class ChaosInfo(NamedTuple):
    """Recovery-metric ingredients for one chaos preset."""

    base: str           # the uninjured control scenario's registry name
    fault_frac: tuple[float, float]  # fault window as fractions of horizon


def _zone_outage_preset(cfg, r, t, w, seed):
    k = len(cfg.tiers)
    return compile_scenario(
        compose(paper_bursts(cfg, t, r, w),
                zone_outage(t, r, w, start_s=t * w * 0.3,
                            duration_s=t * w * 0.2, zone=0, n_zones=2,
                            tiers=tuple(range(max(k - 1, 1))), n_tiers=k)),
        cfg, r, t)


def _straggler_storm_preset(cfg, r, t, w, seed):
    return compile_scenario(
        compose(paper_bursts(cfg, t, r, w),
                straggler_episodes(t, r, w, every_s=max(20.0, t * w / 8),
                                   len_s=max(8.0, t * w / 15),
                                   slowdown=0.25, frac=0.75, seed=seed,
                                   n_tiers=len(cfg.tiers))),
        cfg, r, t)


def _capacity_flap_preset(cfg, r, t, w, seed):
    return compile_scenario(
        compose(paper_bursts(cfg, t, r, w),
                capacity_flap(t, r, w, period_s=max(10.0, t * w / 10),
                              duty=0.4, factor=0.3, tiers=(0,),
                              n_tiers=len(cfg.tiers))),
        cfg, r, t)


def _mttf_mttr_preset(cfg, r, t, w, seed):
    return compile_scenario(
        compose(paper_bursts(cfg, t, r, w),
                crash_restart_storm(t, r, w, mttf_s=max(15.0, t * w / 10),
                                    mttr_s=max(4.0, t * w / 40),
                                    tiers=(0, 1), seed=seed,
                                    n_tiers=len(cfg.tiers))),
        cfg, r, t)


def _long_outage_preset(cfg, r, t, w, seed):
    k = len(cfg.tiers)
    return compile_scenario(
        compose(paper_bursts(cfg, t, r, w),
                long_outage(t, r, w, tiers=tuple(range(max(k - 1, 1))),
                            n_tiers=k)),
        cfg, r, t)


CHAOS_PRESETS = {
    "zone-outage": _zone_outage_preset,
    "straggler-storm": _straggler_storm_preset,
    "capacity-flap": _capacity_flap_preset,
    "mttf-mttr": _mttf_mttr_preset,
    "long-outage": _long_outage_preset,
}

# Per preset: the uninjured control run and the injected fault window —
# what the recovery metrics (time-to-recover, regret-vs-control) condition
# on.  Steady-state storms (mttf-mttr, capacity-flap, straggler-storm) span
# (almost) the whole horizon: regret is still well-defined, time-to-recover
# measures re-entry after the *last* injected window.
CHAOS_INFO: dict[str, ChaosInfo] = {
    "zone-outage": ChaosInfo(base="paper-burst", fault_frac=(0.3, 0.5)),
    "straggler-storm": ChaosInfo(base="paper-burst", fault_frac=(0.0, 1.0)),
    "capacity-flap": ChaosInfo(base="paper-burst", fault_frac=(0.0, 1.0)),
    "mttf-mttr": ChaosInfo(base="paper-burst", fault_frac=(0.0, 1.0)),
    "long-outage": ChaosInfo(base="paper-burst", fault_frac=(0.3, 0.7)),
}

# register the presets alongside the base scenarios (idempotent), so that
# Experiment(scenario=...) sees them
scenarios.SCENARIOS.update(CHAOS_PRESETS)
