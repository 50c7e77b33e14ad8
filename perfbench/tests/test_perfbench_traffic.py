"""The traffic generator: reproducible from the seed, every seed offering
the same work in another order."""
import collections
import json

import numpy as np
import pytest
from perfbench_cells import ROOT

from perfbench import traffic

MIXES = {p.stem: json.loads(p.read_text())
         for p in (ROOT / "perfbench" / "traffic").glob("*.json")}
REQUEST_MIXES = [k for k, v in MIXES.items() if v["kind"] == "requests"]


@pytest.mark.parametrize("mix", REQUEST_MIXES)
def test_same_seed_same_requests(mix):
    a = traffic.requests(MIXES[mix], 2**31 + 12345, 32000)
    b = traffic.requests(MIXES[mix], 2**31 + 12345, 32000)
    assert len(a) == MIXES[mix]["n_requests"]
    for x, y in zip(a, b):
        assert x.due_s == y.due_s and x.max_new_tokens == y.max_new_tokens
        assert np.array_equal(x.prompt, y.prompt)


@pytest.mark.parametrize("mix", REQUEST_MIXES)
def test_every_seed_offers_each_block_the_same_work(mix):
    m = MIXES[mix]
    b = m["block"]
    runs = [traffic.requests(m, s, 32000) for s in (1, 2**33 + 5, -3)]

    def blocks(reqs):
        return [collections.Counter((len(r.prompt), r.max_new_tokens)
                                    for r in reqs[i:i + b])
                for i in range(0, len(reqs) - b + 1, b)]
    assert blocks(runs[0]) == blocks(runs[1]) == blocks(runs[2])
    for r in runs[1:]:
        assert [(len(x.prompt), x.max_new_tokens, x.due_s) for x in r] == [
            (len(x.prompt), x.max_new_tokens, x.due_s) for x in runs[0]]
        assert not np.array_equal(runs[0][0].prompt, r[0].prompt)
    lo, hi = m["prompt"]["lo"], m["prompt"]["hi"]
    assert all(lo <= len(r.prompt) <= hi for r in runs[0])
    assert all(0 <= int(r.prompt.max()) < 32000 for r in runs[0])


def test_order_seed_fixes_the_order_and_the_run_seed_the_tokens():
    mix = dict(kind="requests", arrival={"process": "poisson",
                                         "rate_per_s": 3.0},
               block=8, n_requests=24, order_seed=7,
               prompt={"dist": "uniform", "lo": 10, "hi": 80},
               output={"dist": "uniform", "lo": 2, "hi": 9})

    def trace(m, seed):
        return [(len(r.prompt), r.max_new_tokens, r.due_s)
                for r in traffic.requests(m, seed, 100)]
    other = trace(dict(mix, order_seed=8), 1)
    assert trace(mix, 1) == trace(mix, 2) != other
    # the same block of lengths, in another order
    assert (sorted(x[:2] for x in trace(mix, 1)[:8])
            == sorted(x[:2] for x in other[:8]))
    assert not np.array_equal(traffic.requests(mix, 1, 100)[0].prompt,
                              traffic.requests(mix, 2, 100)[0].prompt)


def test_backlog_and_poisson_arrivals():
    back = dict(kind="requests", arrival={"process": "backlog"}, block=4,
                n_requests=8, order_seed=1,
                prompt={"dist": "uniform", "lo": 10, "hi": 20},
                output={"dist": "loguniform", "lo": 2, "hi": 8})
    assert all(r.due_s == 0.0 for r in traffic.requests(back, 0, 100))
    poi = dict(back, arrival={"process": "poisson", "rate_per_s": 2.0},
               block=64, n_requests=640)
    due = [r.due_s for r in traffic.requests(poi, 5, 100)]
    assert due[0] == 0.0 and all(b >= a for a, b in zip(due, due[1:]))
    # every block's gaps are the same 64 exponential quantiles at 2 / s
    assert due[-1] == pytest.approx(640 / 2.0, rel=0.05)


def test_block_quantiles_by_hand():
    m = dict(block=4, prompt={"dist": "uniform", "lo": 0, "hi": 8},
             output={"dist": "uniform", "lo": 0, "hi": 4})
    # quantiles at 1/8, 3/8, 5/8, 7/8 (outputs 0.5, 1.5, 2.5, 3.5 rounded
    # half to even), outputs paired by stride 3 (the coprime next to 2)
    assert traffic.block_lengths(m) == [(1, 0), (3, 4), (5, 2), (7, 2)]

