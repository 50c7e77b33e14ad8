"""Driver of the hybrid served-model configurations (Granite-4.0-H: Mamba-2
and attention mixers, a MoE in every layer): the model behind
``repro_torch.serving.engine.ServingEngine``, run as
:mod:`perfbench.drivers.serve` runs a decoder, whose warm-up, window and
sample of finished requests it takes by import.

What differs: the weights (:mod:`perfbench.hybrid_weights`), the
arithmetic (:mod:`perfbench.hybrid_cost`), the reference
(:mod:`perfbench.reference.granite`), and a configuration built from
every key of its ``model``, so that a program without one of its fields
refuses it at once instead of serving another model.  The program's
counters (the engine's, each ``Moe``'s ``rows``, each ``Mamba``'s
``scan_tokens`` and ``state_steps``) are snapshotted as the window opens
and after it closes, and their difference goes to the record.

End-to-end values and ``correct`` as in :mod:`perfbench.drivers.serve`:
``tokens_per_s`` (with ``ttft_p95_ms`` and ``itl_p95_ms``), and the mean
gap of each sampled served token's logit below the plain float32
reference's best.
"""
from __future__ import annotations

import statistics

import torch

from perfbench import hybrid_cost, hybrid_weights, programtrace
from perfbench import traffic as traffic_mod
from perfbench.drivers import serve
from perfbench.harness import Check, Outcome, free_device
from perfbench.reference import granite as reference

#: Limit of the mean logit gap (see PERF.md, "correct").
LOGIT_GAP_MEAN_LIMIT = 0.10


def model_config(conf: dict):
    """The program's configuration from every key of ``model``."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**conf["model"])


def counters(engine) -> dict:
    """The engine's counters, the MoE layers' rows and the Mamba layers'
    scan tokens and state steps."""
    from repro_torch.models.ssm import Mamba
    mambas = [m for m in engine.model.modules() if isinstance(m, Mamba)]
    return dict(programtrace.counters(engine),
                scan_tokens=sum(m.scan_tokens for m in mambas),
                state_steps=sum(m.state_steps for m in mambas))


def run(ctx) -> Outcome:
    from repro_torch.serving.engine import ServingEngine
    conf, mix = ctx.cell.config, ctx.cell.traffic
    m = conf["model"]
    dev = ctx.device
    cfg = model_config(conf)
    ctx.note("imports")
    w = hybrid_weights.make(m, ctx.seed, dev)
    ctx.sync()
    ctx.note("weights")
    engine = ServingEngine(cfg, params=w,
                           max_batch=mix["engine"]["max_batch"],
                           max_len=mix["engine"]["max_len"], device=dev)
    reqs = traffic_mod.requests(mix, ctx.seed, m["vocab_size"])
    ctx.note("engine and requests")
    serve.warm_up(engine, reqs, ctx.seed)
    ctx.note("warm-up")
    if ctx.trace:
        serve._install_spans(engine)
    before = counters(engine)
    with ctx.window() as t0:
        served, steps = serve.serve_window(engine, reqs, t0, ctx.seconds)
        window_s = ctx.close()
    after = counters(engine)
    t_close = t0 + window_s
    firsts = [s.token_times[0] - s.due for s in served.values()
              if s.token_times]
    gaps = [b - a for s in served.values()
            for a, b in zip(s.token_times, s.token_times[1:])]
    values = {"tokens_per_s": sum(s.tokens for s in steps) / window_s,
              "ttft_p95_ms": serve.p95_ms(firsts),
              "itl_p95_ms": serve.p95_ms(gaps)}
    record(ctx.record, m, steps, before, after)
    done = [s for s in served.values()
            if s.engine_req.finished_at and s.token_times[-1] <= t_close]
    del engine
    free_device(dev)
    logit_gaps = served_gaps(m, w, serve.sample(done, ctx.seed), dev)
    ctx.note("reference")
    return Outcome(values=values, attempted=len(firsts), failed=0,
                   checks=[Check("logit_gap_mean", float(logit_gaps.mean()),
                                 LOGIT_GAP_MEAN_LIMIT)],
                   notes={"logit_gap_widest": float(logit_gaps.max()),
                          "served_tokens_compared": int(logit_gaps.numel()),
                          "share_not_reference_best": float(
                              (logit_gaps > 0).float().mean())})


def record(rec, m: dict, steps: list, before: dict, after: dict) -> None:
    """What the per-layer readers read: step walls, the least time of the
    window's real work for kernel B6 and for the whole model, and the
    program's counts over the window."""
    _, mamba_layers = hybrid_cost.layer_counts(m)
    waves = [s.end - s.start for s in steps if not s.admitted]
    rec.counters.update(
        decode_step_s=statistics.median(waves) if waves else None,
        step_wall_s=sum(s.end - s.start for s in steps),
        flops=sum(sum(hybrid_cost.prefill_flops(m, n) for n in s.admitted)
                  + (hybrid_cost.decode_flops(m, s.positions)
                     if s.positions else 0)
                  for s in steps),
        b6_bound_s=mamba_layers * sum(hybrid_cost.scan_bound_s(m, n)
                                      for s in steps for n in s.admitted),
        program=programtrace.difference(before, after),
        top_k=m["top_k"], moe_layers=m["n_layers"])


def served_gaps(m: dict, w: dict, chosen: list, dev) -> torch.Tensor:
    """Each sampled served token's gap under the reference (an infinite
    one when the window finished no request)."""
    if not chosen:
        return torch.full((1,), float("inf"))
    seqs, toks = serve.served_sequences(chosen)
    return serve.gaps_of(reference.logits(m, w, seqs, dev), toks)
