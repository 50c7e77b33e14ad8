"""Mega-fleet on the PyTorch/CUDA port: a million routed cells as one
declarative line (the port's counterpart of ``mega_fleet.py``).

``Experiment(n_cells=1_000_000, shard="auto")`` runs the closed loop
sharded over the cell axis (:func:`repro_torch.api.engine.sharded_rollout`):
one host loop steps each shard's row block on a device of its own, the
metrics reduce as the run goes (success %, fleet-global P50/P95 latency
histograms, tier shares, obs fraction) and the (T, R) trace that would
dominate memory at this scale is never materialized.  Results do not depend
on the device count; on one card the mesh is that card.

    PYTHONPATH=src python examples/mega_fleet_torch.py [--quick]
                                   [--windows T] [--device cpu]

``--quick`` drops to R=10k cells so the demo finishes in seconds; the
full R=1M run is the acceptance workload of the sharded engine (a baseline
router keeps the carry small).  ``--device`` defaults to ``cuda`` and
raises without a card.
"""
import argparse
import time

import torch

from repro_torch import api
from repro_torch.device import resolve_device


def main(argv=None) -> list[str]:
    """Run the example; returns the lines it printed."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="R=10k smoke run instead of the full million")
    ap.add_argument("--windows", type=int, default=25,
                    help="control windows T (default 25)")
    ap.add_argument("--device", default="cuda",
                    help="where the fleet's tensors live (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    lines = []

    def say(line=""):
        print(line, flush=True)
        lines.append(line)

    r = 10_000 if args.quick else 1_000_000

    n_dev = (torch.cuda.device_count() if device.type == "cuda"
             else len(api.ShardSpec().build_mesh(device)))
    say(f"devices: {n_dev}  (mesh the cell axis shards over)")
    exp = api.Experiment(router="least_loaded", scenario="paper-burst",
                         n_cells=r, n_windows=args.windows, shard="auto",
                         device=str(device))
    t0 = time.perf_counter()
    res = api.run(exp)
    wall = time.perf_counter() - t0

    say(f"R={r:,} cells x T={args.windows} windows "
        f"({res.cells_per_device:,} cells/device) in {wall:.1f}s "
        f"({r * args.windows / res.wall_s:,.0f} cell-windows/s)")
    say(f"success     {res.success_pct:.2f} % ± {res.success_std:.2f}")
    say(f"latency     P50 {res.p50_ms:.0f} ms / P95 {res.p95_ms:.0f} ms "
        f"(fleet-global, completion-weighted)")
    share = "/".join(f"{100 * float(x):.0f}" for x in res.tier_share)
    say(f"tier share  {share} (light->heavy)")
    say(f"restarts    {res.restarts:.0f} across the fleet")
    if res.trace is not None:
        raise SystemExit("sharded runs must not materialize the trace")
    return lines


if __name__ == "__main__":
    main()
