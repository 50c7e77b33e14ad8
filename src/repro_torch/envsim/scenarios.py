"""Named, composable load/instability scenarios for the batched fleet engine.

A scenario is assembled from multiplicative :class:`Profile` primitives:

* ``rate``      — (T, R) multiplier on the configured base RPS,
* ``hazard``    — (T, R, K) multiplier on the per-tier restart hazard,
* ``capacity``  — (R, K) per-cell multiplier on tier capacity,
* ``obs_valid`` — (T, R, M) 0/1 observation-validity mask over the engine's
  telemetry modalities (1 = a fresh sample arrives this window, 0 = the
  modality is missing: a scrape gap, a restarting exporter, a frozen gauge),
* ``blackout``  — bool: couple telemetry to pod liveness (a down pod emits
  nothing, so every modality is masked while any tier of the cell is down),

where K is the tier count of the simulator config (any topology; build one
with :func:`repro_torch.envsim.config.sim_config_for`) and M is the engine's
telemetry modality count (:data:`N_OBS_MODALITIES`).

Primitives compose by elementwise product (:func:`compose`; ``obs_valid``
masks intersect, ``blackout`` flags OR), so "diurnal load on a heterogeneous
fleet with a mid-run flash crowd" is three primitives multiplied together.
:func:`compile_scenario` materializes the concrete (T, R) arrival-rate,
(T, R, K) hazard and optional (T, R, M) observation-validity schedules the
engine consumes, and :data:`SCENARIOS` names ready-made presets for
benchmarks / examples / CLI.

Telemetry-degradation semantics downstream: the batched engine re-emits the
last published value for a masked modality (a Prometheus gauge holds between
scrapes) and flags it in ``WindowInfo.obs_mask``; mask-aware consumers (the
AIF fleet) treat masked modalities as zero evidence, mask-oblivious routers
consume the stale value — exactly the failure mode real pipelines exhibit.

All builders are host-side numpy: schedules are *inputs* to the rollout,
generated once per experiment.  The fault-injection presets live in
:mod:`repro_torch.envsim.chaos`, which registers them here when the
package is imported.  The graph presets (``ring-spillover``,
``grid-hotspot``, ``hier-continuum``) concentrate load on a subset of
cells so a fleet graph has excess to shed to neighbors; an experiment
attaches their graph (:data:`repro_torch.core.graph.GRAPH_SCENARIOS`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np

from repro_torch.envsim.batched import N_OBS_MODALITIES
from repro_torch.envsim.config import SimConfig


class ScenarioBatch(NamedTuple):
    """Concrete schedules for one fleet rollout."""

    arrival_rate: np.ndarray    # (T, R) offered RPS per window
    hazard_scale: np.ndarray    # (T, R, K) restart-hazard multiplier
    capacity_scale: np.ndarray  # (R, K) per-cell tier-capacity multiplier
    # (T, R, M) 0/1 observation-validity schedule, or None when the scenario
    # has no telemetry degradation (None keeps the engine on the exact
    # pre-mask code path — bit-identical clean rollouts).
    obs_valid: np.ndarray | None = None
    # couple telemetry to pod liveness: a down pod emits nothing
    restart_blackout: bool = False
    # (T, R, K) 0/1 administrative-down schedule (fault injection: zone
    # outages, MTTF/MTTR churn, outages longer than the restart machinery
    # can represent), or None for no injected downtime.  None keeps the
    # engine on the exact pre-chaos program.
    forced_down: np.ndarray | None = None
    # (T, R, K) service-speed multiplier (straggler episodes: <1 inflates
    # latency and shrinks capacity without a liveness loss), or None.
    speed: np.ndarray | None = None


@dataclasses.dataclass(frozen=True)
class Profile:
    """Multiplicative scenario component (any field may be None = neutral)."""

    rate: np.ndarray | None = None       # (T, R)
    hazard: np.ndarray | None = None     # (T, R, K)
    capacity: np.ndarray | None = None   # (R, K)
    obs_valid: np.ndarray | None = None  # (T, R, M) 0/1 validity mask
    blackout: bool = False               # down pods emit no telemetry
    forced_down: np.ndarray | None = None  # (T, R, K) 0/1 injected downtime
    speed: np.ndarray | None = None      # (T, R, K) service-speed multiplier


def _mul(a: np.ndarray | None, b: np.ndarray | None) -> np.ndarray | None:
    if a is None:
        return b
    if b is None:
        return a
    return a * b


def _union(a: np.ndarray | None, b: np.ndarray | None) -> np.ndarray | None:
    if a is None:
        return b
    if b is None:
        return a
    return np.maximum(a, b)


def compose(*profiles: Profile) -> Profile:
    """Elementwise product of profiles (None fields stay neutral).

    ``obs_valid`` masks compose by product too — validity intersects (a
    modality is fresh only if every component says so) — ``blackout`` flags
    OR together, ``forced_down`` schedules union (a tier is down if any
    component takes it down) and ``speed`` multipliers compound.
    """
    out = Profile()
    for p in profiles:
        out = Profile(rate=_mul(out.rate, p.rate),
                      hazard=_mul(out.hazard, p.hazard),
                      capacity=_mul(out.capacity, p.capacity),
                      obs_valid=_mul(out.obs_valid, p.obs_valid),
                      blackout=out.blackout or p.blackout,
                      forced_down=_union(out.forced_down, p.forced_down),
                      speed=_mul(out.speed, p.speed))
    return out


def compile_scenario(profile: Profile, cfg: SimConfig, n_cells: int,
                     n_windows: int,
                     n_modalities: int = N_OBS_MODALITIES) -> ScenarioBatch:
    """Materialize a profile into the engine's concrete schedules.

    Schedules are per *window*; any real-time scaling belongs in the
    primitive builders (which take ``window_s``), not here.  ``obs_valid``
    stays None (not an all-ones array) for degradation-free profiles so the
    engine compiles the mask-free program.
    """
    t, r, k = n_windows, n_cells, len(cfg.tiers)
    rate = np.ones((t, r), np.float32) if profile.rate is None else (
        np.broadcast_to(profile.rate, (t, r)).astype(np.float32))
    hazard = np.ones((t, r, k), np.float32) if profile.hazard is None else (
        np.broadcast_to(profile.hazard, (t, r, k)).astype(np.float32))
    cap = np.ones((r, k), np.float32) if profile.capacity is None else (
        np.broadcast_to(profile.capacity, (r, k)).astype(np.float32))
    obs_valid = None if profile.obs_valid is None else np.broadcast_to(
        profile.obs_valid, (t, r, n_modalities)).astype(np.float32)
    forced_down = None if profile.forced_down is None else np.broadcast_to(
        profile.forced_down, (t, r, k)).astype(np.float32)
    speed = None if profile.speed is None else np.broadcast_to(
        profile.speed, (t, r, k)).astype(np.float32)
    return ScenarioBatch(arrival_rate=cfg.rps * rate,
                         hazard_scale=hazard,
                         capacity_scale=cap,
                         obs_valid=obs_valid,
                         restart_blackout=profile.blackout,
                         forced_down=forced_down,
                         speed=speed)


# ----------------------------------------------------------------- primitives
def steady() -> Profile:
    """Flat offered load at the configured base RPS (paper: 50)."""
    return Profile()


def paper_bursts(cfg: SimConfig, n_windows: int, n_cells: int,
                 window_s: float = 1.0) -> Profile:
    """The event simulator's burst cycle, sampled per control window.

    Matches ``EdgeSimulator._rate_at`` exactly (same duty cycle / factors) so
    parity tests can drive both engines with the same offered-load shape.
    """
    t = (np.arange(n_windows, dtype=np.float64) + 0.5) * window_s
    phase = (t % cfg.burst_period_s) / cfg.burst_period_s
    mult = np.where(phase < cfg.burst_duty, cfg.burst_factor,
                    cfg.off_burst_factor())
    return Profile(rate=np.tile(mult[:, None].astype(np.float32),
                                (1, n_cells)))


def diurnal(n_windows: int, n_cells: int, window_s: float = 1.0,
            period_s: float = 600.0, amplitude: float = 0.5,
            phase_spread: float = 0.0) -> Profile:
    """Sinusoidal load: 1 + amplitude·sin(2πt/period), optional per-cell phase.

    ``phase_spread`` in [0, 1] staggers cell phases across one period —
    regional fleets don't peak simultaneously.
    """
    t = (np.arange(n_windows, dtype=np.float64) + 0.5) * window_s
    phases = phase_spread * 2.0 * math.pi * (
        np.arange(n_cells, dtype=np.float64) / max(n_cells, 1))
    mult = 1.0 + amplitude * np.sin(
        2.0 * math.pi * t[:, None] / period_s + phases[None, :])
    return Profile(rate=np.maximum(mult, 0.05).astype(np.float32))


def flash_crowd(n_windows: int, n_cells: int, window_s: float = 1.0,
                start_s: float = 120.0, duration_s: float = 60.0,
                magnitude: float = 3.0, stagger_s: float = 0.0) -> Profile:
    """A sudden load spike (×magnitude), optionally sweeping across cells."""
    t = (np.arange(n_windows, dtype=np.float64) + 0.5) * window_s
    starts = start_s + stagger_s * np.arange(n_cells, dtype=np.float64)
    inside = (t[:, None] >= starts[None, :]) & (
        t[:, None] < starts[None, :] + duration_s)
    mult = np.where(inside, magnitude, 1.0)
    return Profile(rate=mult.astype(np.float32))


def localized_surge(n_windows: int, n_cells: int, window_s: float = 1.0,
                    start_s: float = 120.0, duration_s: float = 60.0,
                    magnitude: float = 5.0,
                    cells: tuple[int, ...] | None = None,
                    frac: float = 0.25) -> Profile:
    """A flash crowd confined to a subset of cells (the rest stay at ×1).

    Unlike :func:`flash_crowd` — which lifts the whole fleet — this drives a
    *spatially localized* hotspot: by default the first ``frac`` of the cell
    axis surges ×``magnitude`` while its neighbors idle, exactly the regime
    where cross-cell spillover (``FleetGraph``) pays off and an ungraphed
    fleet just refuses the excess.  Pass ``cells`` for an explicit hot set.
    """
    t = (np.arange(n_windows, dtype=np.float64) + 0.5) * window_s
    inside_t = (t >= start_s) & (t < start_s + duration_s)
    hot = np.zeros(n_cells, bool)
    if cells is None:
        hot[:max(int(round(frac * n_cells)), 1)] = True
    else:
        hot[list(cells)] = True
    mult = np.where(inside_t[:, None] & hot[None, :], magnitude, 1.0)
    return Profile(rate=mult.astype(np.float32))


def cascading_restarts(n_windows: int, n_cells: int, window_s: float = 1.0,
                       start_s: float = 60.0, wave_interval_s: float = 5.0,
                       tiers: tuple[int, ...] = (0, 1),
                       boost: float = 1e6, n_tiers: int = 3) -> Profile:
    """A restart wave rolling across the fleet's edge tiers.

    Cell r gets a one-window hazard boost at ``start_s + r·wave_interval_s``
    on the selected tiers, reproducing correlated edge outages (rolling
    firmware updates, zone-wide thermal events).  The boost multiplies the
    tier's own hazard; the default saturates even the bare base hazard
    (light tier: 1e6 · ~7e-5/s ⇒ p_restart ≈ 1 − e⁻⁷⁰ ≈ 1) so the wave is
    deterministic, not a high-probability draw.
    """
    hz = np.ones((n_windows, n_cells, n_tiers), np.float64)
    for r in range(n_cells):
        k = int((start_s + r * wave_interval_s) / window_s)
        if 0 <= k < n_windows:
            for tier in tiers:
                hz[k, r, tier] = boost
    return Profile(hazard=hz.astype(np.float32))


def heterogeneous_capacity(n_cells: int, spread: float = 0.35,
                           seed: int = 0, n_tiers: int = 3) -> Profile:
    """Per-cell lognormal tier-capacity multipliers (heterogeneous fleet)."""
    rng = np.random.default_rng(seed)
    cap = np.exp(rng.normal(0.0, spread, size=(n_cells, n_tiers)))
    return Profile(capacity=cap.astype(np.float32))


# ------------------------------------------------- telemetry degradation
def telemetry_dropout(n_windows: int, n_cells: int, drop_p: float = 0.35,
                      modalities: tuple[int, ...] | None = None,
                      seed: int = 0,
                      n_modalities: int = N_OBS_MODALITIES) -> Profile:
    """I.i.d. per-(window, cell, modality) scrape misses.

    Each selected modality independently fails to deliver a fresh sample
    with probability ``drop_p`` — the baseline failure mode of pull-based
    telemetry (scrape timeouts, dropped UDP stats packets).  Unselected
    modalities stay always-valid.
    """
    if not 0.0 <= drop_p < 1.0:
        raise ValueError(f"drop_p must be in [0, 1), got {drop_p}")
    rng = np.random.default_rng(seed)
    mask = np.ones((n_windows, n_cells, n_modalities), np.float32)
    cols = range(n_modalities) if modalities is None else modalities
    for m in cols:
        mask[:, :, m] = (rng.random((n_windows, n_cells)) >= drop_p)
    return Profile(obs_valid=mask)


def stale_replay(n_windows: int, n_cells: int, window_s: float = 1.0,
                 freeze_every_s: float = 60.0, freeze_len_s: float = 15.0,
                 modalities: tuple[int, ...] | None = None,
                 seed: int = 0,
                 n_modalities: int = N_OBS_MODALITIES) -> Profile:
    """Frozen-gauge episodes: contiguous runs where an exporter stops
    refreshing and the last-seen value is re-emitted every window.

    Each (cell, modality) independently enters a freeze roughly every
    ``freeze_every_s`` (exponential gaps) lasting ``freeze_len_s``.  The
    engine's stale-hold emission turns these invalid runs into literally
    re-played gauge values, so mask-oblivious routers act on data up to
    ``freeze_len_s`` old.
    """
    rng = np.random.default_rng(seed)
    mask = np.ones((n_windows, n_cells, n_modalities), np.float32)
    flen = max(int(round(freeze_len_s / window_s)), 1)
    cols = range(n_modalities) if modalities is None else modalities
    for r in range(n_cells):
        for m in cols:
            t = rng.exponential(freeze_every_s) / window_s
            while t < n_windows:
                k0 = int(t)
                mask[k0:k0 + flen, r, m] = 0.0
                t = k0 + flen + rng.exponential(freeze_every_s) / window_s
    return Profile(obs_valid=mask)


def scrape_blackout() -> Profile:
    """Couple telemetry to pod liveness: a down pod emits nothing, so the
    whole cell's scrape goes dark (every modality masked) while any tier is
    restarting.  Pure flag — the engine derives the mask from live state."""
    return Profile(blackout=True)


# ------------------------------------------------------------------- registry
# Presets take (cfg, n_cells, n_windows, window_s, seed) -> ScenarioBatch.
def _steady(cfg, r, t, w, seed):
    return compile_scenario(steady(), cfg, r, t)


def _paper_burst(cfg, r, t, w, seed):
    return compile_scenario(paper_bursts(cfg, t, r, w), cfg, r, t)


def _diurnal(cfg, r, t, w, seed):
    return compile_scenario(
        diurnal(t, r, w, period_s=max(600.0, t * w / 3), phase_spread=0.5),
        cfg, r, t)


def _flash(cfg, r, t, w, seed):
    return compile_scenario(
        compose(paper_bursts(cfg, t, r, w),
                flash_crowd(t, r, w, start_s=t * w * 0.3,
                            duration_s=max(30.0, t * w * 0.1),
                            magnitude=2.5)),
        cfg, r, t)


def _cascade(cfg, r, t, w, seed):
    return compile_scenario(
        compose(paper_bursts(cfg, t, r, w),
                cascading_restarts(t, r, w, start_s=t * w * 0.2,
                                   wave_interval_s=max(1.0, t * w * 0.5 / max(r, 1)),
                                   n_tiers=len(cfg.tiers))),
        cfg, r, t)


def _hetero_diurnal(cfg, r, t, w, seed):
    return compile_scenario(
        compose(heterogeneous_capacity(r, seed=seed, n_tiers=len(cfg.tiers)),
                diurnal(t, r, w, period_s=max(600.0, t * w / 3),
                        phase_spread=0.5)),
        cfg, r, t)


def _flaky_telemetry(cfg, r, t, w, seed):
    """Paper burst traffic under >=35% i.i.d. modality dropout — the
    unreliable-telemetry acceptance scenario."""
    return compile_scenario(
        compose(paper_bursts(cfg, t, r, w),
                telemetry_dropout(t, r, drop_p=0.35, seed=seed)),
        cfg, r, t)


def _scrape_blackout(cfg, r, t, w, seed):
    """Cascading restart waves whose down pods emit no telemetry at all."""
    return compile_scenario(
        compose(paper_bursts(cfg, t, r, w),
                cascading_restarts(t, r, w, start_s=t * w * 0.2,
                                   wave_interval_s=max(1.0, t * w * 0.5
                                                       / max(r, 1)),
                                   n_tiers=len(cfg.tiers)),
                scrape_blackout()),
        cfg, r, t)


def _stale_cascade(cfg, r, t, w, seed):
    """Frozen-gauge episodes on top of a restart cascade: stale values are
    re-played exactly while the world is moving fastest."""
    return compile_scenario(
        compose(paper_bursts(cfg, t, r, w),
                stale_replay(t, r, w, freeze_every_s=max(20.0, t * w / 8),
                             freeze_len_s=max(10.0, t * w / 20), seed=seed),
                cascading_restarts(t, r, w, start_s=t * w * 0.3,
                                   wave_interval_s=max(1.0, t * w * 0.4
                                                       / max(r, 1)),
                                   n_tiers=len(cfg.tiers))),
        cfg, r, t)


# --------------------------------------------- graph / spillover presets
# Load shapes tuned for the networked-continuum engine: each concentrates
# offered load on a subset of cells so a FleetGraph has excess to shed to
# neighbors.  Experiment auto-attaches the matching graph preset (see
# repro_torch.core.graph.GRAPH_SCENARIOS) when run with graph=None.
def _ring_spillover(cfg, r, t, w, seed):
    """Moderate base load plus a ×6 flash crowd on the first quarter of a
    ring — the canonical spillover demo (hot arc sheds around the ring)."""
    return compile_scenario(
        compose(Profile(rate=np.full((t, r), 0.6, np.float32)),
                localized_surge(t, r, w, start_s=t * w * 0.3,
                                duration_s=max(30.0, t * w * 0.4),
                                magnitude=6.0, frac=0.25)),
        cfg, r, t)


def _grid_hotspot(cfg, r, t, w, seed):
    """Diurnal fleet with a persistent corner hotspot on a 2-D grid."""
    side = max(int(math.isqrt(max(r, 1))), 1)
    corner = tuple(i * side + j
                   for i in range(min(2, side)) for j in range(min(2, side))
                   if i * side + j < r)
    return compile_scenario(
        compose(Profile(rate=np.full((t, r), 0.55, np.float32)),
                diurnal(t, r, w, period_s=max(600.0, t * w / 3),
                        amplitude=0.3, phase_spread=0.5),
                localized_surge(t, r, w, start_s=t * w * 0.2,
                                duration_s=t * w * 0.6,
                                magnitude=5.0, cells=corner)),
        cfg, r, t)


def _hier_continuum(cfg, r, t, w, seed):
    """Heterogeneous leaf capacity plus a leaf-side surge on a hierarchy —
    leaves shed upward to cluster heads over the uplink edges."""
    leaves = tuple(i for i in range(r) if i % 4 != 0)  # graph.hier cluster=4
    return compile_scenario(
        compose(Profile(rate=np.full((t, r), 0.6, np.float32)),
                heterogeneous_capacity(r, spread=0.45, seed=seed,
                                       n_tiers=len(cfg.tiers)),
                localized_surge(t, r, w, start_s=t * w * 0.25,
                                duration_s=max(30.0, t * w * 0.45),
                                magnitude=4.0, cells=leaves or (0,))),
        cfg, r, t)


SCENARIOS: dict[str, Callable[..., ScenarioBatch]] = {
    "steady": _steady,
    "paper-burst": _paper_burst,
    "diurnal": _diurnal,
    "flash-crowd": _flash,
    "cascade": _cascade,
    "hetero-diurnal": _hetero_diurnal,
    "flaky-telemetry": _flaky_telemetry,
    "scrape-blackout": _scrape_blackout,
    "stale-cascade": _stale_cascade,
    "ring-spillover": _ring_spillover,
    "grid-hotspot": _grid_hotspot,
    "hier-continuum": _hier_continuum,
}

def pad_cells(arr: np.ndarray | None, n_pad: int, fill: float,
              cell_axis: int = 0) -> np.ndarray | None:
    """``arr`` with its cell axis padded to ``n_pad`` rows of ``fill``
    (None passes through)."""
    if arr is None:
        return None
    arr = np.asarray(arr)
    pad = n_pad - arr.shape[cell_axis]
    if pad < 0:
        raise ValueError(f"cell axis already has {arr.shape[cell_axis]} "
                         f"rows > n_pad={n_pad}")
    if pad == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[cell_axis] = (0, pad)
    return np.pad(arr, widths, constant_values=fill)


def pad_scenario(sc: ScenarioBatch, n_pad: int) -> ScenarioBatch:
    """A scenario's cell axis extended to ``n_pad`` cells with phantom rows.

    A sharded run rounds R up to a multiple of its shard count
    (:meth:`repro_torch.api.shard.ShardSpec.padded`); the phantom cells get
    zero arrivals, zero hazard, unit capacity, all-valid telemetry, no
    injected downtime and unit speed, so they stay quiescent and add
    nothing to any fleet reduction.  The real cells' schedules are those
    of the unpadded build: a scenario is built at the true R (its per-cell
    randomness depends on R) and padded afterwards.  A fleet graph is built
    at the true R too, so phantom rows stay edge-less
    (:meth:`repro_torch.core.graph.FleetGraph.validate_true_rows`).
    """
    return ScenarioBatch(
        arrival_rate=pad_cells(sc.arrival_rate, n_pad, 0.0, cell_axis=1),
        hazard_scale=pad_cells(sc.hazard_scale, n_pad, 0.0, cell_axis=1),
        capacity_scale=pad_cells(sc.capacity_scale, n_pad, 1.0,
                                 cell_axis=0),
        obs_valid=pad_cells(sc.obs_valid, n_pad, 1.0, cell_axis=1),
        restart_blackout=sc.restart_blackout,
        forced_down=pad_cells(sc.forced_down, n_pad, 0.0, cell_axis=1),
        speed=pad_cells(sc.speed, n_pad, 1.0, cell_axis=1),
    )


#: Presets of the reference that wait for a later slice of the port (name
#: -> ROADMAP item); :func:`build_scenario` raises for them.
WAITING: dict[str, str] = {}


def build_scenario(name: str, cfg: SimConfig, n_cells: int, n_windows: int,
                   window_s: float = 1.0, seed: int = 0) -> ScenarioBatch:
    """Look up and materialize a named scenario preset."""
    if name in WAITING:
        raise NotImplementedError(
            f"scenario {name!r} is not ported yet (ROADMAP item "
            f"{WAITING[name]})")
    try:
        builder = SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"available: {sorted(SCENARIOS)}") from None
    return builder(cfg, n_cells, n_windows, window_s, seed)
