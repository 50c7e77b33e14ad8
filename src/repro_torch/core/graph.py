"""Fleet graphs: the networked continuum's cross-cell edge structure.

The fleet engine advances R service cells that are independent columns —
the continuum is vertical-only (device -> edge -> cloud *within* a cell).
A :class:`FleetGraph` adds the horizontal dimension: a static directed edge
list with per-edge hop latencies over which a saturated cell re-offers the
load it would otherwise reject (the spillover term of
:func:`repro_torch.envsim.batched.fluid_window_step`) and from which each
cell observes a neighbor-pressure summary (the fifth telemetry modality).

Design constraints, in order:

* **Static & hashable.**  The spec is a frozen dataclass of tuples, so it
  can key a cache; the engine never inspects the topology per tick, it
  reads the index tensors :meth:`FleetGraph.device_data` builds once.
* **None-gated.**  ``graph=None`` (or any graph with an empty edge list —
  the :func:`none` preset) runs the *exact* ungraphed program: no
  spillover, no neighbor modality.
* **Deterministic sums.**  The three per-cell segment sums of the
  spillover are gathers through per-cell edge lists padded to the largest
  degree, then a reduction over the list in edge order: no float atomics,
  so the same inputs give the same bits on every run and device.
* **Pad-safe.**  A graph is built at the *true* fleet size R; a padded
  world's phantom rows stay edge-less (:meth:`FleetGraph.validate_true_rows`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device

#: Bin count of the neighbor-pressure observation modality (low/ok/high).
NEIGHBOR_BINS = 3

#: Discretization edges of the neighbor-pressure modality: mean neighbor
#: backlog as a fraction of live system capacity.  Below 0.3 the
#: neighborhood has headroom, above 0.7 it is near saturation — shedding
#: sideways will mostly bounce.
NEIGHBOR_EDGES = (0.3, 0.7)


class GraphData(NamedTuple):
    """Edge tensors of one :class:`FleetGraph` on one device.

    ``in_edges`` / ``out_edges`` list, for each cell, the indices of the
    edges that end / start there in edge order, padded with ``E`` (the
    index of a zero appended to every per-edge vector before the gather),
    so each segment sum is a gather followed by a fixed-order reduction.
    ``has_out.shape[0]`` is the cell count the sums reduce over.
    """

    src: torch.Tensor        # (E,) int64 edge sources
    dst: torch.Tensor        # (E,) int64 edge destinations
    hop: torch.Tensor        # (E,) float32 per-edge hop latency (seconds)
    share: torch.Tensor      # (E,) float32 1/out_degree[src] offer split
    has_out: torch.Tensor    # (R,) float32 1 where the cell has an out-edge
    in_edges: torch.Tensor   # (R, max in-degree) int64, padded with E
    out_edges: torch.Tensor  # (R, max out-degree) int64, padded with E


def segment_sum(values: torch.Tensor, lists: torch.Tensor) -> torch.Tensor:
    """Per-cell sums of per-edge ``values`` (E,) over the padded edge
    ``lists`` (R, D): a gather, then the D terms added left to right."""
    padded = torch.cat([values, values.new_zeros(1)])
    g = padded[lists]                                       # (R, D)
    out = g[:, 0]
    for d in range(1, g.shape[1]):
        out = out + g[:, d]
    return out


def _padded_lists(cells: np.ndarray, r: int, n_edges: int) -> np.ndarray:
    """(r, max degree) edge indices grouped by ``cells[e]``, in edge order,
    padded with ``n_edges``."""
    deg = np.bincount(cells, minlength=r)
    out = np.full((r, max(int(deg.max()), 1)), n_edges, np.int64)
    fill = np.zeros(r, np.int64)
    for e, c in enumerate(cells):
        out[c, fill[c]] = e
        fill[c] += 1
    return out


@dataclasses.dataclass(frozen=True)
class FleetGraph:
    """Static cell-to-cell offload topology (frozen, hashable).

    Args:
      n_cells: the *true* fleet size R this graph spans; must match the
        experiment's ``n_cells``.
      edges: directed ``(src, dst)`` pairs; spillover offered along an edge
        flows ``src -> dst``.  Preset constructors emit both directions.
      hop_s: per-edge one-way hop latency in seconds (``len == len(edges)``);
        spilled mass pays it before queueing at the destination.
      name: display name (presets fill it in).
    """

    n_cells: int
    edges: tuple[tuple[int, int], ...] = ()
    hop_s: tuple[float, ...] = ()
    name: str = "custom"

    def __post_init__(self):
        if self.n_cells < 1:
            raise ValueError(f"n_cells must be >= 1, got {self.n_cells}")
        if len(self.hop_s) != len(self.edges):
            raise ValueError(
                f"hop_s has {len(self.hop_s)} entries for "
                f"{len(self.edges)} edges — every edge needs its hop "
                f"latency")
        for (s, d), h in zip(self.edges, self.hop_s):
            if not (0 <= s < self.n_cells and 0 <= d < self.n_cells):
                raise ValueError(
                    f"edge ({s}, {d}) references a cell outside "
                    f"[0, {self.n_cells}) — graphs are built at the true "
                    f"fleet size, never at a padded one")
            if s == d:
                raise ValueError(f"self-edge ({s}, {d}): a cell cannot "
                                 f"offload to itself")
            if h < 0.0:
                raise ValueError(f"negative hop latency {h} on edge "
                                 f"({s}, {d})")

    @property
    def n_edges(self) -> int:
        return len(self.edges)

    def validate_true_rows(self, n_true: int) -> None:
        """Enforce the graph-padding contract against the true fleet size:
        rows at or past ``n_true`` are phantom pad cells of a padded world
        and must stay edge-less."""
        if self.n_cells > n_true:
            raise ValueError(
                f"FleetGraph spans {self.n_cells} cells but the true fleet "
                f"size is {n_true}: rows >= {n_true} are phantom pad cells "
                f"and must stay edge-less — build the graph at the true R "
                f"and pad the world, not the graph")
        bad = [e for e in self.edges if e[0] >= n_true or e[1] >= n_true]
        if bad:
            raise ValueError(
                f"graph edges {bad[:4]} reference cells >= the true fleet "
                f"size {n_true}: those rows are phantom pad cells and must "
                f"stay edge-less")

    def device_data(self, r_pad: int | None = None,
                    device: str | torch.device = "cuda"
                    ) -> GraphData | None:
        """The edge tensors at the (padded) fleet size on ``device``.

        ``r_pad`` >= ``n_cells`` sizes the cell axis so phantom pad rows
        exist but stay edge-less.  Returns None for an empty edge list —
        the caller then runs the exact graph-free program.
        """
        r = self.n_cells if r_pad is None else int(r_pad)
        if r < self.n_cells:
            raise ValueError(
                f"r_pad={r} < n_cells={self.n_cells}: the padded size can "
                f"only grow the cell axis")
        if not self.edges:
            return None
        dev = resolve_device(device)
        e = len(self.edges)
        src = np.asarray([x[0] for x in self.edges], np.int64)
        dst = np.asarray([x[1] for x in self.edges], np.int64)
        out_deg = np.bincount(src, minlength=r).astype(np.float32)

        def t(x, dtype):
            return torch.tensor(x, dtype=dtype, device=dev)

        return GraphData(
            src=t(src, torch.int64),
            dst=t(dst, torch.int64),
            hop=t(np.asarray(self.hop_s, np.float32), torch.float32),
            share=t(1.0 / out_deg[src], torch.float32),
            has_out=t((out_deg > 0).astype(np.float32), torch.float32),
            in_edges=t(_padded_lists(dst, r, e), torch.int64),
            out_edges=t(_padded_lists(src, r, e), torch.int64),
        )


# ------------------------------------------------------------------- presets
def ring(n_cells: int, hop_s: float = 0.05, name: str = "ring") -> FleetGraph:
    """Bidirectional ring: cell i <-> its two cyclic neighbors."""
    if n_cells < 2:
        return FleetGraph(n_cells=n_cells, name=name)
    edges, hops = [], []
    for i in range(n_cells):
        nxt = (i + 1) % n_cells
        if (i, nxt) not in edges:      # n_cells == 2 would duplicate
            edges += [(i, nxt), (nxt, i)]
            hops += [hop_s, hop_s]
    return FleetGraph(n_cells=n_cells, edges=tuple(edges),
                      hop_s=tuple(hops), name=name)


def grid(n_cells: int, hop_s: float = 0.05) -> FleetGraph:
    """Near-square 4-neighbor grid, row-major cell ids, both directions."""
    rows = max(int(math.floor(math.sqrt(n_cells))), 1)
    cols = (n_cells + rows - 1) // rows
    edges, hops = [], []

    def add(a, b):
        edges.append((a, b))
        hops.append(hop_s)

    for i in range(n_cells):
        r, c = divmod(i, cols)
        right = i + 1
        if c + 1 < cols and right < n_cells:
            add(i, right)
            add(right, i)
        down = i + cols
        if down < n_cells:
            add(i, down)
            add(down, i)
    return FleetGraph(n_cells=n_cells, edges=tuple(edges),
                      hop_s=tuple(hops), name="grid")


def hier(n_cells: int, cluster: int = 4, hop_s: float = 0.05,
         uplink_s: float = 0.15) -> FleetGraph:
    """Two-level hierarchy: leaf cells star onto a per-cluster head, heads
    ring together over slower uplinks — the cloud-edge continuum's
    aggregation topology (leaves shed to their head, heads shed across
    clusters)."""
    if cluster < 2:
        raise ValueError(f"cluster size must be >= 2, got {cluster}")
    edges, hops = [], []
    heads = list(range(0, n_cells, cluster))
    for h in heads:
        for leaf in range(h + 1, min(h + cluster, n_cells)):
            edges += [(leaf, h), (h, leaf)]
            hops += [hop_s, hop_s]
    if len(heads) >= 2:
        head_ring = ring(len(heads), hop_s=uplink_s)
        for (a, b), h in zip(head_ring.edges, head_ring.hop_s):
            edges.append((heads[a], heads[b]))
            hops.append(h)
    return FleetGraph(n_cells=n_cells, edges=tuple(edges),
                      hop_s=tuple(hops), name="hier")


def none(n_cells: int) -> FleetGraph:
    """The edge-less graph: runs the exact ungraphed program — ``graph=None``
    spelled as a preset so sweeps can include the ungraphed control row."""
    return FleetGraph(n_cells=n_cells, name="none")


#: Preset constructors by name (the ``Experiment(graph="ring")`` strings).
GRAPH_PRESETS = {"ring": ring, "grid": grid, "hier": hier, "none": none}

#: Scenario -> default graph preset: the graph scenario presets
#: (:mod:`repro_torch.envsim.scenarios`) attach their natural topology when
#: the experiment leaves ``graph=None``; ``graph="none"`` forces the
#: ungraphed control run on the same schedules.
GRAPH_SCENARIOS = {
    "ring-spillover": "ring",
    "grid-hotspot": "grid",
    "hier-continuum": "hier",
}


def resolve_graph(graph, n_cells: int,
                  scenario: str | None = None) -> FleetGraph | None:
    """Normalize an ``Experiment.graph``-style argument.

    None attaches the scenario's default preset (:data:`GRAPH_SCENARIOS`)
    when there is one, otherwise stays ungraphed; a string names a preset
    built at ``n_cells``; a :class:`FleetGraph` passes through after a size
    check.  Empty-edge graphs resolve to None — the exact ungraphed program.
    """
    if graph is None:
        preset = GRAPH_SCENARIOS.get(scenario) if scenario else None
        if preset is None:
            return None
        graph = GRAPH_PRESETS[preset](n_cells)
    if isinstance(graph, str):
        try:
            make = GRAPH_PRESETS[graph]
        except KeyError:
            raise KeyError(f"unknown graph preset {graph!r}; "
                           f"available: {sorted(GRAPH_PRESETS)}") from None
        graph = make(n_cells)
    if not isinstance(graph, FleetGraph):
        raise TypeError(
            f"graph must be None, a preset name or a FleetGraph, got "
            f"{type(graph).__name__}")
    if graph.n_cells != n_cells:
        raise ValueError(
            f"FleetGraph spans {graph.n_cells} cells but the experiment "
            f"runs {n_cells} — build the graph at the experiment's true "
            f"fleet size (presets: repro_torch.core.graph.GRAPH_PRESETS)")
    return graph if graph.n_edges else None


def with_neighbor_modality(topo):
    """A topology extended with the graph's neighbor-pressure modality: a
    ``"neighbor"`` observation modality (:data:`NEIGHBOR_BINS` bins over
    :data:`NEIGHBOR_EDGES`) appended to the topology's modalities.  Unknown
    modality names get flat preferences, so the neighbor channel is
    context, not a goal."""
    if "neighbor" in topo.modalities:
        return topo
    return dataclasses.replace(
        topo,
        modalities=topo.modalities + ("neighbor",),
        n_bins=topo.n_bins + (NEIGHBOR_BINS,))
