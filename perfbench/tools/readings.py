"""The readings that set a cell's limits for ``correct``: the program's
numbers and the control's, at the cell's own size, on the card, several
seeds in one process.

    python3 perfbench/tools/readings.py --workload <cell> --seeds 1,2,3 \\
        [--seconds 20] [--out readings.jsonl]

A served model: each seed runs the program at the cell's load for
``--seconds``, takes the run's sample of finished requests and reads
(a) the widest gap of the program's served tokens under the float32
reference and (b) the control's: at each position of the same prompts and
tokens, the gap of the token the reference computed in fp8 puts first.

One JSON line a seed.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _quantiles(x) -> dict:
    import torch
    x = x.float()
    q = torch.quantile(x, torch.tensor([0.5, 0.8, 0.9, 0.99],
                                       device=x.device))
    return {"max": float(x.max()), "p99": float(q[3]), "p90": float(q[2]),
            "p80": float(q[1]), "median": float(q[0]),
            "mean": float(x.mean()), "not_best": float((x > 0).float().mean()),
            "over_0.25": float((x > 0.25).float().mean()),
            "n": int(x.numel())}


def _bf16_router_look(m, w, seqs, toks, dev) -> dict:
    """The look at the widest gap's cause: the program's tokens under the
    reference with only its router logits taken as the program takes them
    (the normed input and the router weights in bfloat16)."""
    from perfbench.drivers import serve
    from perfbench.reference import mixtral
    real = mixtral._Mm.__call__

    def bf16_router(self, x, wt):
        if wt.shape[-1] == m["n_experts"] and x.shape[-1] == m["d_model"]:
            return (x.bfloat16() @ wt.bfloat16()).float()
        return real(self, x, wt)
    mixtral._Mm.__call__ = bf16_router
    try:
        gaps = serve.gaps_of(mixtral.logits(m, w, seqs, dev), toks)
    finally:
        mixtral._Mm.__call__ = real
    return _quantiles(gaps)


def serve_readings(cell, seed: int, seconds: float, dev) -> dict:
    import torch
    from perfbench import traffic as traffic_mod
    from perfbench import weights as weights_mod
    from perfbench.drivers import serve
    from perfbench.harness import free_device
    from perfbench.reference import mixtral
    from repro_torch.serving.engine import ServingEngine
    m, mix = cell.config["model"], cell.traffic
    w = weights_mod.make(m, seed, dev)
    engine = ServingEngine(serve.model_config(cell.config), params=w,
                           max_batch=mix["engine"]["max_batch"],
                           max_len=mix["engine"]["max_len"], device=dev)
    reqs = traffic_mod.requests(mix, seed, m["vocab_size"])
    serve.warm_up(engine, reqs, seed)
    t0 = time.perf_counter()
    served, _ = serve.serve_window(engine, reqs, t0, seconds)
    done = [s for s in served.values() if s.engine_req.finished_at]
    chosen = serve.sample(done, seed)
    del engine
    free_device(dev)
    seqs, toks = serve.served_sequences(chosen)
    margins = []
    ref = mixtral.logits(m, w, seqs, dev, margins=margins)
    prog = serve.gaps_of(ref, toks)
    margin = torch.cat(margins).float()
    near = margin < 0.05
    look = _bf16_router_look(m, w, seqs, toks, dev)
    ctl_logits = mixtral.logits(m, w, seqs, dev, quant="fp8")
    ctl = serve.gaps_of(ref, [lg.argmax(-1).cpu() for lg in ctl_logits])
    flips = sum(int((a.argmax(-1).cpu() != t).sum())
                for a, t in zip(ref, toks))
    del w, ref, ctl_logits
    free_device(dev)
    big = prog > 0.1
    return {"requests": len(chosen), "program": _quantiles(prog),
            "control_fp8": _quantiles(ctl),
            "program_tokens_not_reference_best": flips,
            "look": {"share_router_margin_under_0.05": float(
                         near.float().mean()),
                     "of_gaps_over_0.1_router_margin_under_0.05": float(
                         near[big].float().mean()) if bool(big.any())
                     else None,
                     "gaps_over_0.1": int(big.sum()),
                     "program_under_bf16_router_reference": look}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
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
        line = serve_readings(cell, seed, args.seconds, dev)
        line = {"workload": cell.name, "seed": seed,
                "seconds": time.perf_counter() - t, **line}
        print(json.dumps(line), flush=True)
        if sink:
            sink.write(json.dumps(line) + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
