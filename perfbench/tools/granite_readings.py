"""The readings that set the hybrid cell's limit for ``correct``: the
program's numbers and the control's, at the cell's own size, on the card,
several seeds in one process.

    python3 perfbench/tools/granite_readings.py --workload granite-rag \\
        --seeds 1,2,3 [--seconds 20] [--out readings.jsonl]

Each seed runs the program at the cell's load for ``--seconds`` as
:mod:`perfbench.drivers.hybrid` does, takes the run's sample of finished
requests and reads (a) the gaps of the program's served tokens under the
float32 reference (:mod:`perfbench.reference.granite`) and (b) the
control's: at each position of the same prompts and tokens, the gap of the
token the reference computed in fp8 puts first.  One JSON line a seed, as
:mod:`perfbench.tools.readings` prints for the decoder cells.  The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def granite_readings(cell, seed: int, seconds: float, dev) -> dict:
    from perfbench import hybrid_weights
    from perfbench import traffic as traffic_mod
    from perfbench.drivers import hybrid, serve
    from perfbench.harness import free_device
    from perfbench.reference import granite
    from perfbench.tools.readings import _quantiles
    from repro_torch.serving.engine import ServingEngine
    m, mix = cell.config["model"], cell.traffic
    w = hybrid_weights.make(m, seed, dev)
    engine = ServingEngine(hybrid.model_config(cell.config), params=w,
                           max_batch=mix["engine"]["max_batch"],
                           max_len=mix["engine"]["max_len"], device=dev)
    reqs = traffic_mod.requests(mix, seed, m["vocab_size"])
    serve.warm_up(engine, reqs, seed)
    served, _ = serve.serve_window(engine, reqs, time.perf_counter(), seconds)
    chosen = serve.sample([s for s in served.values()
                           if s.engine_req.finished_at], seed)
    del engine
    free_device(dev)
    seqs, toks = serve.served_sequences(chosen)
    ref = granite.logits(m, w, seqs, dev)
    prog = serve.gaps_of(ref, toks)
    ctl_logits = granite.logits(m, w, seqs, dev, quant="fp8")
    ctl = serve.gaps_of(ref, [lg.argmax(-1).cpu() for lg in ctl_logits])
    flips = sum(int((a.argmax(-1).cpu() != t).sum())
                for a, t in zip(ref, toks))
    del w, ref, ctl_logits
    free_device(dev)
    return {"requests": len(chosen), "program": _quantiles(prog),
            "control_fp8": _quantiles(ctl),
            "program_tokens_not_reference_best": flips}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="granite-rag")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from perfbench import harness
    cell = harness.resolve(harness.load_spec(ROOT), ROOT, args.workload)
    dev = torch.device("cuda")
    sink = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        line = granite_readings(cell, seed, args.seconds, dev)
        line = {"workload": cell.name, "seed": seed,
                "seconds": time.perf_counter() - t, **line}
        print(json.dumps(line), flush=True)
        if sink:
            sink.write(json.dumps(line) + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
