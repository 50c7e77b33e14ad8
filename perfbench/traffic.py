"""The one generator of the benchmark's traffic, driven by a mix's data file
(``perfbench/traffic/<mix>.json``) and the run's seed.

A request mix (``"kind": "requests"``) is a stream of requests, each with
its prompt length, output length, due time and token ids:

* ``arrival``: ``{"process": "backlog"}`` (every request due at the
  window's start: offline batch work whose queue never empties) or
  ``{"process": "poisson", "rate_per_s": λ}`` (an open loop);
* ``prompt`` / ``output``: ``{"dist": "uniform" | "loguniform", "lo", "hi"}``
  (inclusive integer bounds);
* ``block``: the stream is made of blocks of this many requests.  Every
  block holds the same lengths and gaps, the distributions' evenly spaced
  quantiles with outputs paired to prompts by a fixed stride, shuffled
  within each block;
* ``order_seed``: the shuffles are drawn from this number, so every run
  offers the same lengths and arrivals in the same order (a fixed trace:
  the tails measure the system, not the order of one draw), and the run's
  seed draws the token ids;
* ``n_requests``: the length of the stream (more than a window serves).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class Request:
    index: int
    due_s: float          # offset from the window's start
    prompt: np.ndarray    # int64 token ids
    max_new_tokens: int


def seed_words(seed: int, *salt: int) -> np.random.SeedSequence:
    """A seed sequence from the run's seed (any whole number, negative or
    past 64 bits too) and integer salts."""
    return np.random.SeedSequence([x % 2**64 for x in (seed, *salt)])


def _quantiles(spec: dict, n: int) -> np.ndarray:
    u = (np.arange(n) + 0.5) / n
    lo, hi = float(spec["lo"]), float(spec["hi"])
    if spec["dist"] == "uniform":
        x = lo + u * (hi - lo)
    elif spec["dist"] == "loguniform":
        x = np.exp(np.log(lo) + u * (np.log(hi) - np.log(lo)))
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def _stride(n: int) -> int:
    """The fixed pairing of output to prompt quantiles: a stride coprime
    with the block size, near its golden section."""
    s = max(1, int(round(n * 0.618)))
    while math.gcd(s, n) != 1:
        s += 1
    return s


def block_lengths(traffic: dict) -> list:
    """The (prompt, output) lengths of one block, in block order."""
    b = int(traffic["block"])
    prompts = _quantiles(traffic["prompt"], b)
    outputs = _quantiles(traffic["output"], b)
    st = _stride(b)
    return [(int(prompts[i]), int(outputs[(i * st) % b])) for i in range(b)]


def block_gaps(traffic: dict) -> np.ndarray:
    """The inter-arrival gaps of one block: exponential quantiles at the
    mix's rate (zeros for a backlog)."""
    b = int(traffic["block"])
    arr = traffic["arrival"]
    if arr["process"] == "backlog":
        return np.zeros(b)
    if arr["process"] != "poisson":
        raise ValueError(f"unknown arrival process {arr['process']!r}")
    u = (np.arange(b) + 0.5) / b
    return -np.log1p(-u) / float(arr["rate_per_s"])


def requests(traffic: dict, seed: int, vocab_size: int) -> list:
    """The whole request stream of a mix for one seed."""
    if traffic["kind"] != "requests":
        raise ValueError(f"not a request mix: {traffic['kind']!r}")
    rng = np.random.default_rng(seed_words(seed, 1))
    order_rng = np.random.default_rng(
        seed_words(int(traffic["order_seed"]), 2))
    lengths = block_lengths(traffic)
    gaps = block_gaps(traffic)
    b, n = len(lengths), int(traffic["n_requests"])
    out, due = [], 0.0
    for i0 in range(0, n, b):
        order = order_rng.permutation(b)
        gap_order = order_rng.permutation(b)
        for k in range(min(b, n - i0)):
            p, o = lengths[order[k]]
            due += float(gaps[gap_order[k]])
            out.append(Request(index=i0 + k, due_s=due,
                               prompt=rng.integers(0, vocab_size, p,
                                                   dtype=np.int64),
                               max_new_tokens=o))
    if traffic["arrival"]["process"] == "poisson":
        # the first request is due at the window's start
        first = out[0].due_s
        for r in out:
            r.due_s -= first
    return out
