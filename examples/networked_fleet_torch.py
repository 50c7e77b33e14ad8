"""Networked continuum on the PyTorch/CUDA port: a ring fleet absorbs a
localized flash crowd (the port's counterpart of ``networked_fleet.py``).

The ``ring-spillover`` scenario drives a x6 flash crowd into the first
quarter of the cell axis while the rest of the ring idles.  With the ring
graph attached (the scenario's default), each saturated cell re-offers its
rejected mass to its two ring neighbors, who admit it into live capacity
headroom at a hop-latency penalty.  The same experiment runs four ways on
identical schedules:

* ``graph="none"`` + least_loaded — the ungraphed control,
* ring graph + least_loaded,
* ring graph + nearest-neighbor offloader (``nn_offload``),
* ring graph + AIF — which also observes the neighbor-pressure modality
  the graph emits; on the card its selecting ticks are kernel B1 at M = 5
  modalities,

and reports fleet-global success plus the offloaded fraction.

    PYTHONPATH=src python examples/networked_fleet_torch.py [--quick]
                                                            [--device cpu]

``--device`` defaults to ``cuda`` and raises without a card.
"""
import argparse
import time

from repro_torch import api
from repro_torch.device import resolve_device


def fleet_success(res) -> float:
    return (100.0 * float(res.fluid.n_success.sum())
            / max(float(res.fluid.n_requests.sum()), 1.0))


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

    r = 8
    t = 60 if args.quick else 300

    base = dict(scenario="ring-spillover", n_cells=r, n_windows=t,
                device=device)
    runs = [
        ("no graph (control)", api.Experiment(router="least_loaded",
                                              graph="none", **base)),
        ("ring + least_loaded", api.Experiment(router="least_loaded",
                                               **base)),
        ("ring + nn_offload", api.Experiment(router="nn_offload", **base)),
        ("ring + aif", api.Experiment(router="aif", **base)),
    ]
    say(f"ring fleet, R={r} cells x T={t} windows, localized flash crowd "
        f"on cells 0-{r // 4 - 1}:")

    t0 = time.time()
    results = [(name, api.run(e)) for name, e in runs]
    wall = time.time() - t0

    say(f"\nran {len(runs)} experiments in {wall:.1f}s\n")
    say(f"{'configuration':22s} {'success %':>10s} {'offloaded %':>12s} "
        f"{'P95 ms':>8s}")
    for name, res in results:
        say(f"{name:22s} {fleet_success(res):10.1f} "
            f"{100 * res.offload_frac:12.1f} {res.p95_ms:8.0f}")

    control, graphed = results[0][1], results[1][1]
    gain = fleet_success(graphed) - fleet_success(control)
    hot = slice(0, r // 4)
    spill = graphed.trace.env.spill_out                    # (T, R)
    say(f"\nspillover absorbed the burst: +{gain:.1f} success points over "
        f"the ungraphed control; the hot arc exported "
        f"{float(spill[:, hot].sum()):.0f} request-units to its ring "
        f"neighbors ({100 * graphed.offload_frac:.1f}% of all offered load "
        f"was served away from its origin cell).")
    say("Every cross-cell exchange is a fixed-order sum over the padded "
        "edge lists, so the graphed rollout gives the same bits on every "
        "run — and composes with shard='auto' for sharded fleets.")
    return lines


if __name__ == "__main__":
    main()
