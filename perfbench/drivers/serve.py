"""Driver of the served-model configurations: a decoder-only model behind
``repro_torch.serving.engine.ServingEngine`` (continuous batching: each
``step()`` admits queued requests into free slots with a b=1 prefill, then
runs one decode wave over every slot).

Set-up makes the weights on the card from the seed (:mod:`perfbench.weights`),
builds the engine on them and warms up every prefill bucket the mix's
prompts fall in and the decode wave.  The window then offers the mix's
requests as they fall due (:mod:`perfbench.traffic`; an open loop, or a
backlog) and steps the engine while it has work, until ``--seconds`` have
passed; it ends at the end of the last step that began inside them.  Each
step ends in a host copy of its tokens, so its end on the host clock is
the time every token it returned reached the caller.

End-to-end values (the harness prints those ``BENCHMARK.json`` declares
for the cell):

* ``tokens_per_s``: every real token the engine processed in the window
  (the prompt tokens at their admission, each token it generated) over the
  window's seconds; bucket pads and idle decode lanes count for nothing;
* ``ttft_p95_ms``: the 95th percentile, over the requests whose first
  token came in the window, of the time from when each was due to the end
  of the step that returned its first token;
* ``itl_p95_ms``: the 95th percentile of the gaps between consecutive
  tokens of every request in the window (a token's time is the end of its
  step; the prefill's token and the first wave's share a step, gap 0).

``correct``: after the window the engine is freed, and a sample of the
requests it finished, drawn from the seed with the longest among them, is
run once through the plain float32 reference
(:mod:`perfbench.reference.mixtral`) over its prompt and served tokens.
The number compared is the mean, over the sampled served tokens, of the
gap by which each one's logit lies below the reference's best at its
position (the widest gap is printed beside it, not compared).
"""
from __future__ import annotations

import collections
import dataclasses
import statistics
import time

import numpy as np
import torch
from torch.profiler import record_function

from perfbench import cost, traffic as traffic_mod, weights as weights_mod
from perfbench.harness import Check, Outcome, free_device
from perfbench.reference import mixtral as reference
from perfbench.traffic import seed_words

#: Limit of the mean logit gap (see PERF.md, "correct").
LOGIT_GAP_MEAN_LIMIT = 0.14
#: Served tokens the correctness sample reaches (the longest request, then
#: requests drawn from the seed), and the most requests it takes.
SAMPLE_TOKENS, SAMPLE_MAX = 256, 16


@dataclasses.dataclass
class Served:
    """One request through the window."""
    req: traffic_mod.Request
    due: float                     # host clock
    token_times: list = dataclasses.field(default_factory=list)
    engine_req: object = None


@dataclasses.dataclass
class Step:
    start: float
    end: float
    admitted: list                 # prompt lengths
    positions: list                # decode positions of the wave's live slots
    tokens: int                    # real tokens processed


def model_config(conf: dict):
    from repro_torch.models.config import ModelConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in conf["model"].items()
                          if k in fields})


def warm_up(engine, reqs, seed: int) -> None:
    """One request per prefill bucket the stream uses (its longest prompt
    there) with two new tokens, stepped to the end: every prefill and the
    decode wave run once before the window."""
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed_words(seed, 8))
    longest = {}
    for r in reqs:
        b = engine._bucket(len(r.prompt))
        longest[b] = max(longest.get(b, 0), len(r.prompt))
    for i, n in enumerate(sorted(longest.values())):
        engine.submit(Request(id=-1 - i, tokens=rng.integers(
            0, engine.cfg.vocab_size, n).tolist(), max_new_tokens=2))
    while engine.queue or engine.active_count:
        engine.step()
    engine.completed.clear()


def serve_window(engine, reqs: list, t0: float, seconds: float) -> tuple:
    """Offer ``reqs`` as they fall due from ``t0`` and step the engine while
    it has work until ``seconds`` have passed.  Returns (served by request
    index, steps)."""
    from repro_torch.serving.engine import Request
    pending = collections.deque(reqs)
    served, steps = {}, []
    end = t0 + seconds
    while True:
        now = time.perf_counter()
        if now >= end:
            break
        while pending and t0 + pending[0].due_s <= now:
            r = pending.popleft()
            er = Request(id=r.index, tokens=r.prompt.tolist(),
                         max_new_tokens=r.max_new_tokens)
            served[r.index] = Served(req=r, due=t0 + r.due_s, engine_req=er)
            engine.submit(er)
        if not (engine.queue or engine.active_count):
            if not pending:
                break
            with record_function("bench.wait"):
                time.sleep(max(0.0, min(t0 + pending[0].due_s, end)
                               - time.perf_counter()))
            continue
        before = {id(r) for r in engine.active if r is not None}
        with record_function("bench.step"):
            finished = engine.step()
        t_end = time.perf_counter()
        wave = [r for r in engine.active if r is not None] + finished
        admitted = [r for r in wave if id(r) not in before]
        positions = [len(r.tokens) + len(r.output) - 2 for r in wave]
        for r in wave:
            s = served[r.id]
            new = len(r.output) - len(s.token_times)
            s.token_times += [t_end] * new
        steps.append(Step(start=now, end=t_end,
                          admitted=[len(r.tokens) for r in admitted],
                          positions=positions,
                          tokens=sum(len(r.tokens) for r in admitted)
                          + len(wave) + len(admitted)))
    return served, steps


def _install_spans(engine) -> None:
    for owner, name, span in ((engine, "_admit", "bench.admit"),
                              (engine.model, "decode_step", "bench.wave")):
        fn = getattr(owner, name)

        def wrapped(*a, _fn=fn, _span=span, **kw):
            with record_function(_span):
                return _fn(*a, **kw)
        setattr(owner, name, wrapped)


def p95_ms(xs: list) -> float | None:
    return float(np.percentile(xs, 95)) * 1e3 if xs else None


def run(ctx) -> Outcome:
    from repro_torch.serving.engine import ServingEngine
    conf, mix = ctx.cell.config, ctx.cell.traffic
    m = conf["model"]
    dev = ctx.device
    ctx.note("imports")
    w = weights_mod.make(m, ctx.seed, dev)
    ctx.sync()
    ctx.note("weights")
    engine = ServingEngine(model_config(conf), params=w,
                           max_batch=mix["engine"]["max_batch"],
                           max_len=mix["engine"]["max_len"], device=dev)
    reqs = traffic_mod.requests(mix, ctx.seed, m["vocab_size"])
    ctx.note("engine and requests")
    warm_up(engine, reqs, ctx.seed)
    ctx.note("warm-up")
    if ctx.trace:
        _install_spans(engine)
    with ctx.window() as t0:
        served, steps = serve_window(engine, reqs, t0, ctx.seconds)
        window_s = ctx.close()
    t_close = t0 + window_s
    firsts = [s.token_times[0] - s.due for s in served.values()
              if s.token_times]
    gaps = [b - a for s in served.values()
            for a, b in zip(s.token_times, s.token_times[1:])]
    values = {"tokens_per_s": sum(s.tokens for s in steps) / window_s,
              "ttft_p95_ms": p95_ms(firsts), "itl_p95_ms": p95_ms(gaps)}
    record(ctx.record, m, steps)
    done = [s for s in served.values()
            if s.engine_req.finished_at and s.token_times[-1] <= t_close]
    del engine
    free_device(dev)
    logit_gaps = served_gaps(m, w, sample(done, ctx.seed), dev)
    ctx.note("reference")
    return Outcome(values=values, attempted=len(firsts), failed=0,
                   checks=[Check("logit_gap_mean", float(logit_gaps.mean()),
                                 LOGIT_GAP_MEAN_LIMIT)],
                   notes={"logit_gap_widest": float(logit_gaps.max()),
                          "served_tokens_compared": int(logit_gaps.numel()),
                          "share_not_reference_best": float(
                              (logit_gaps > 0).float().mean())})


def record(rec, m: dict, steps: list) -> None:
    """What the per-layer readers read: step walls, and the least time of
    the window's real work by kernel and for the whole model."""
    layers = m["n_layers"]
    waves = [s.end - s.start for s in steps if not s.admitted]
    rec.counters.update(
        decode_step_s=statistics.median(waves) if waves else None,
        step_wall_s=sum(s.end - s.start for s in steps),
        flops=sum(sum(cost.prefill_flops(m, n) for n in s.admitted)
                  + (cost.decode_flops(m, s.positions) if s.positions else 0)
                  for s in steps),
        b4_bound_s=layers * sum(cost.prefill_attention_bound_s(m, n)
                                for s in steps for n in s.admitted),
        b5_bound_s=layers * sum(cost.decode_attention_bound_s(m, s.positions)
                                for s in steps if s.positions))


def sample(done: list, seed: int) -> list:
    """The longest finished request, then others drawn from the seed, until
    :data:`SAMPLE_TOKENS` served tokens or :data:`SAMPLE_MAX` requests."""
    if not done:
        return []
    order = sorted(done, key=lambda s: (len(s.req.prompt)
                                        + len(s.engine_req.output)),
                   reverse=True)
    rest = order[1:]
    rng = np.random.default_rng(seed_words(seed, 7))
    picked = [order[0]] + [rest[i] for i in rng.permutation(len(rest))]
    out, n = [], 0
    for s in picked:
        if n >= SAMPLE_TOKENS or len(out) >= SAMPLE_MAX:
            break
        out.append(s)
        n += len(s.engine_req.output)
    return out


def served_sequences(chosen: list) -> tuple:
    """Each request's prompt and served tokens as the reference's input
    (its last served token is predicted, never fed), and the tokens."""
    seqs, toks = [], []
    for s in chosen:
        out = list(s.engine_req.output)
        n = len(s.req.prompt)
        seqs.append((np.concatenate([s.req.prompt,
                                     np.asarray(out[:-1], np.int64)]),
                     n - 1, n - 1 + len(out)))
        toks.append(torch.as_tensor(out))
    return seqs, toks


def gaps_of(ref_logits: list, toks: list) -> torch.Tensor:
    """Per served token: how far its logit lies below the reference's best."""
    return torch.cat([lg.max(-1).values - lg.gather(
        -1, t.to(lg.device)[:, None])[:, 0]
        for lg, t in zip(ref_logits, toks)])


def served_gaps(m: dict, w: dict, chosen: list, dev) -> torch.Tensor:
    """Each sampled served token's gap under the reference (an infinite
    one when the window finished no request)."""
    if not chosen:
        return torch.full((1,), float("inf"))
    seqs, toks = served_sequences(chosen)
    return gaps_of(reference.logits(m, w, seqs, dev), toks)
