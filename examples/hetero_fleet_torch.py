"""Heterogeneous fleet on the PyTorch/CUDA port: different cells run
different topologies (the port's counterpart of ``hetero_fleet.py``).

Array shapes differ across topologies (|S|, action count, tier count), so a
mixed fleet runs one :class:`repro_torch.api.Experiment` per topology on
the same diurnal load shape:

* 4 cells of the paper's 3-tier testbed (|S| = 243, 20 policies),
* 3 cells of the 5-tier cloud/regional/metro/far-edge/device continuum
  (|S| = 128 via binary levels, 37 generated policies).

Both take the port's fused per-tick path, so on the card kernel B1 runs at
each topology's widths.  (For pre-grouped shards sharing one call, see
``repro_torch.core.fleet.hetero_fleet_rollout``.)

    PYTHONPATH=src python examples/hetero_fleet_torch.py [--quick]
                                                         [--device cpu]

``--device`` defaults to ``cuda`` and raises without a card.
"""
import argparse
import time

import numpy as np

from repro_torch import api
from repro_torch.device import resolve_device


def main(argv=None) -> list[str]:
    """Run the example; returns the lines it printed."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="short horizon for CI smoke runs")
    ap.add_argument("--device", default="cuda",
                    help="where the fleet's tensors live (default cuda)")
    args = ap.parse_args(argv)
    device = str(resolve_device(args.device))
    lines = []

    def say(line=""):
        print(line, flush=True)
        lines.append(line)

    t = 60 if args.quick else 300

    shards = [
        api.Experiment(router="aif", topology="paper-3tier", n_cells=4,
                       n_windows=t, scenario="diurnal", device=device),
        api.Experiment(router="aif", topology="continuum-5tier", n_cells=3,
                       n_windows=t, scenario="diurnal", fused=True,
                       device=device),
    ]
    say(f"heterogeneous fleet, {t} control windows per shard:")
    for e in shards:
        topo = e.resolve_topology()
        say(f"  {e.topology}: {topo.describe()}, {e.n_cells} cells"
            + (" [fused EFE kernel]" if e.fused else ""))

    t0 = time.time()
    results = [api.run(e) for e in shards]
    wall = time.time() - t0

    total_cells = sum(e.n_cells for e in shards)
    say(f"\nran {total_cells} cells x {t} windows in {wall:.1f}s "
        f"({total_cells * t / wall:.0f} cell-windows/s)")
    for e, res in zip(shards, results):
        k = e.resolve_topology().n_tiers
        mean_w = res.trace.routing_weights.mean((0, 1)).cpu().numpy()
        say(f"\n  {e.topology} (K={k}):")
        say(f"    success {res.success_pct:.1f}%  "
            f"P95 {res.p95_ms:.0f} ms  restarts {int(res.restarts)}")
        say(f"    fleet-mean routing weights (lightest->heaviest): "
            f"{np.round(mean_w, 2)}")
    say("\nEach shard learns its own topology's generative model online; "
        "the shards share no shapes, only the control cadence — exactly "
        "how a mixed edge estate (3-tier metro sites + 5-tier continuum "
        "regions) would run one router codebase.")
    return lines


if __name__ == "__main__":
    main()
