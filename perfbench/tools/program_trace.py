"""The program's counters and spans over a served cell's window, on the card.

    python3 perfbench/tools/program_trace.py --workload <cell> --seed <n> \\
        [--seconds 50] [--out trace.jsonl]

The run goes as :mod:`perfbench.drivers.serve` runs the cell (the
weights from the seed, the engine, the warm-up, its ``bench.*``
spans, the window's open loop or backlog) under the profiler, with the
port's counters snapshotted when the window opens and when it closes
(:mod:`perfbench.programtrace`).  One window a process: the profiler of a
50 s window of a full-size cell takes 10-13 GB of host memory, which the
process does not hand back.  It prints one JSON line:

* ``program``: the program's per-layer quantities (``programtrace``);
* ``benchmark``: the cell's declared per-layer metrics, read by their own
  readers from the same window;
* ``idle_by_span``: the device's idle seconds by the innermost program or
  ``bench.*`` span open at each gap; ``busy_s``, ``window_s``, ``device_ops``;
* ``counts``: the window's counts; ``maxrss_gb``: the process's peak.

No reference runs; nothing is checked.  The benchmark never runs this.
:func:`window` repeats ``drivers/serve.py``'s run of a cell only because
that driver takes no counter snapshots and ``devtrace`` no program spans
yet: once they do, this tool goes.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import resource
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


@dataclasses.dataclass
class Window:
    engine: object
    served: dict
    steps: list
    counts: dict
    spans: list             # the program's host spans
    window_s: float
    timeline: object = None     # with the program's spans (on the card)


def window(cell, seed: int, seconds: float, dev) -> Window:
    """One window of ``cell`` under the profiler (``dev`` a card: device
    and host; the CPU: the host alone, no timeline)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from perfbench import devtrace, programtrace
    from perfbench import traffic as traffic_mod
    from perfbench import weights as weights_mod
    from perfbench.drivers import serve
    from repro_torch.serving.engine import ServingEngine
    m, mix = cell.config["model"], cell.traffic
    on_card = dev.type == "cuda"
    w = weights_mod.make(m, seed, dev)
    engine = ServingEngine(serve.model_config(cell.config), params=w,
                           max_batch=mix["engine"]["max_batch"],
                           max_len=mix["engine"]["max_len"], device=dev)
    reqs = traffic_mod.requests(mix, seed, m["vocab_size"])
    serve.warm_up(engine, reqs, seed)
    serve._install_spans(engine)
    if on_card:
        torch.cuda.synchronize(dev)
        prof = devtrace.start()
    else:
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.start()
    before = programtrace.counters(engine)
    t0 = time.perf_counter()
    served, steps = serve.serve_window(engine, reqs, t0, seconds)
    if on_card:
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    counts = programtrace.difference(before, programtrace.counters(engine))
    tl = None
    if on_card:
        tl = programtrace.stop(prof)
    else:
        prof.stop()
    return Window(engine=engine, served=served, steps=steps, counts=counts,
                  spans=programtrace.host_spans(prof), window_s=window_s,
                  timeline=tl)


def reading(cell, win: Window) -> dict:
    """The line of one window (see the module docstring)."""
    from perfbench import harness, programtrace
    from perfbench.drivers import serve
    waits = [s.engine_req.admitted_at - s.engine_req.submitted_at
             for s in win.served.values() if s.engine_req.admitted_at]
    line = {"program": programtrace.quantities(
        win.counts, win.spans, waits, win.engine.cfg.top_k,
        len(programtrace.moes(win.engine))), "counts": win.counts,
        "window_s": win.window_s}
    if win.timeline is not None:
        rec = harness.Record(cell=cell.name, window_s=win.window_s,
                             timeline=win.timeline)
        serve.record(rec, cell.config["model"], win.steps)
        line["benchmark"] = {m["name"]: harness.reader_for(
            ROOT, m["name"]).read(rec) for m in cell.per_layer}
        b = win.timeline.breakdown()
        line.update(busy_s=win.timeline.busy_s,
                    idle_by_span=dict(sorted(
                        win.timeline.idle_by_host().items(),
                        key=lambda kv: -kv[1])),
                    device_ops=b["device_ops"])
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=50.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from perfbench import harness
    cell = harness.resolve(harness.load_spec(ROOT), ROOT, args.workload)
    dev = torch.device("cuda")
    win = window(cell, args.seed, args.seconds, dev)
    line = {"workload": cell.name, "seed": args.seed,
            "device": torch.cuda.get_device_name(0), **reading(cell, win),
            "maxrss_gb": resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss / 2**20}
    print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "a") as sink:
            sink.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
