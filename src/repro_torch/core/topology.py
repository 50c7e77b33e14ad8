"""Topology: the single source of truth for AIF-Router shapes.

The paper fixes one 3-tier testbed — ``|S| = 3^5`` hidden states, 4
observation modalities, 20 hand-written routing policies.  A
:class:`Topology` lifts every one of those numbers into explicit
configuration so the same core runs cloud–edge continua of any depth:

* ``tier_names`` — K service tiers ordered lightest → heaviest (the paper's
  ``(light, medium, heavy)``); routing weights, tier capacities and fluid
  backlogs all carry this order,
* ``tier_classes`` — per-tier *capacity class* label resolved by
  :mod:`repro_torch.envsim.config` into concrete tier parameters (cores, service
  time, restart hazards),
* state-factor layout — ``(latency, rate, u_{tier K-1}, ..., u_{tier 0})``
  with ``n_levels`` levels per factor, i.e. per-tier utilization factors in
  *reverse* tier order, matching the paper's ``(ell, r, u_H, u_M, u_L)``,
* observation modalities + per-modality bin counts (padded to ``max_bins``
  with a validity mask so every array stays statically shaped),
* a :class:`PolicySpec` from which the discrete policy set is *generated*
  (:func:`repro_torch.core.policies.generate_policy_table`) instead of hand-written.

``default_topology()`` reproduces the paper's setup exactly (including the
20-row policy table, pinned by regression test); ``five_tier_topology()`` is
the cloud / regional / metro / far-edge / device continuum preset.  Every
public entry point (``init_agent_state``, the engine rollout, the EFE kernel
stack, the batched env) reads its shapes from here — no module-level shape
constants remain anywhere in the core.
"""
from __future__ import annotations

import dataclasses
import functools


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """Recipe for generating the discrete routing-policy set.

    Families (in table order):

    1. *balanced* — one near-uniform row (two-decimal rounding, remainder on
       the heaviest tier: ``(0.33, 0.33, 0.34)`` for K=3),
    2. *biased ramps* — per tier (heaviest first), concentration ramps over
       ``ramp_levels``; the heaviest tier additionally gets
       ``heavy_extra_level``.  The remainder ``1 − c`` is split equally over
       the other tiers, then ``neighbor_shift`` mass moves from the farthest
       tier to the nearest (none when they tie, e.g. the middle tier of 3),
    3. *pairwise splits* — ``pair_weight`` on each unordered tier pair
       (skipped for K < 3),
    4. *soft concentrations* — ``soft_weight`` on each tier, rest uniform,
    5. optional *simplex lattice* — all compositions of ``lattice_resolution``
       into K parts (0 = off), for dense exploratory coverage at large K.

    Duplicate rows are dropped (first occurrence wins), so the generated set
    stays minimal for degenerate K.  ``ramp_overrides`` pins individual ramp
    rows ``(tier, level) -> row``; the paper's hand-written table deviates
    from the closed form in exactly one row (light tier at 0.80), which the
    default spec pins to stay bit-compatible with the paper.
    """

    ramp_levels: tuple[float, ...] = (0.6, 0.7, 0.8, 1.0)
    heavy_extra_level: float | None = 0.9
    neighbor_shift: float = 0.05
    pair_weight: float = 0.45
    soft_weight: float = 0.5
    lattice_resolution: int = 0
    ramp_overrides: tuple[tuple[int, float, tuple[float, ...]], ...] = ()


# The paper's 20-policy table is the K=3 instance of the generic families
# with one hand-tuned irregularity (§4.1): light-biased @0.80 splits the
# remainder evenly instead of shifting toward the medium tier.
PAPER_POLICY_SPEC = PolicySpec(
    ramp_overrides=((0, 0.8, (0.80, 0.10, 0.10)),))


@dataclasses.dataclass(frozen=True)
class Topology:
    """Static description of one cloud–edge continuum (hashable: it keys the policy-table cache).

    Defaults are the paper's 3-tier testbed; see :func:`five_tier_topology`
    for a deeper preset and the README section "Topologies & policy sets"
    for how to define your own.
    """

    tier_names: tuple[str, ...] = ("light", "medium", "heavy")
    tier_classes: tuple[str, ...] = ("edge-light", "edge-medium", "server")
    n_levels: int = 3                  # levels per state factor
    modalities: tuple[str, ...] = ("latency", "rps", "queue", "error")
    n_bins: tuple[int, ...] = (3, 3, 3, 2)
    util_edges: tuple[float, ...] = (0.5, 0.9)   # raw util -> level edges
    policy_spec: PolicySpec = PAPER_POLICY_SPEC

    def __post_init__(self):
        if len(self.tier_classes) != len(self.tier_names):
            raise ValueError("tier_classes must match tier_names")
        if len(self.n_bins) != len(self.modalities):
            raise ValueError("n_bins must match modalities")
        if len(self.util_edges) != self.n_levels - 1:
            raise ValueError(
                f"util_edges needs {self.n_levels - 1} edges for "
                f"{self.n_levels} levels, got {len(self.util_edges)}")
        if self.n_levels < 2 or not self.tier_names:
            raise ValueError("need >= 2 levels and >= 1 tier")

    # ------------------------------------------------------- derived shapes
    @property
    def n_tiers(self) -> int:
        return len(self.tier_names)

    @property
    def n_state_factors(self) -> int:
        """(latency, rate) + one hidden utilization factor per tier."""
        return 2 + self.n_tiers

    @property
    def n_states(self) -> int:
        return self.n_levels ** self.n_state_factors

    @property
    def n_modalities(self) -> int:
        return len(self.modalities)

    @property
    def max_bins(self) -> int:
        return max(self.n_bins)

    def describe(self) -> str:
        """One-line human summary (examples / benches)."""
        return (f"{self.n_tiers}-tier ({', '.join(self.tier_names)}): "
                f"|S|={self.n_states} ({self.n_levels}^{self.n_state_factors}),"
                f" {self.n_modalities} modalities")


@functools.lru_cache(maxsize=None)
def default_topology() -> Topology:
    """The paper's 3-tier testbed: |S|=3^5=243, 20 generated policies."""
    return Topology()


@functools.lru_cache(maxsize=None)
def five_tier_topology() -> Topology:
    """Cloud / regional / metro / far-edge / device continuum (K=5).

    Binary state levels keep |S| = 2^7 = 128 so a fleet of these agents is
    *lighter* than the paper's 243-state routers despite the deeper
    hierarchy; the generated policy set has 37 actions (balanced + 21 ramp +
    10 pairwise + 5 soft-concentration rows).
    """
    return Topology(
        tier_names=("device", "far-edge", "metro", "regional", "cloud"),
        tier_classes=("device", "far-edge", "metro", "regional", "cloud"),
        n_levels=2,
        util_edges=(0.8,),
        policy_spec=PolicySpec(),
    )


#: Named presets for CLIs / examples / benches.
TOPOLOGIES = {
    "paper-3tier": default_topology,
    "continuum-5tier": five_tier_topology,
}


def get_topology(name: str) -> Topology:
    try:
        return TOPOLOGIES[name]()
    except KeyError:
        raise KeyError(f"unknown topology {name!r}; "
                       f"available: {sorted(TOPOLOGIES)}") from None
