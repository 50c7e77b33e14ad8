"""The controls, on the card: the comparison that decides ``correct``
passes the program and fails the reference computed a step below the
configuration's precision (fp8 for the bf16 served model), at the cells'
own widths and depth, on a short window.  ``python -m pytest -m card perfbench/tests`` on
the card; skipped without one."""
import copy
import time

import pytest
from perfbench_cells import ROOT

from perfbench import harness

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.mark.card
@pytest.mark.parametrize("workload", ["mixtral-longdoc", "mixtral-code"])
@pytest.mark.parametrize("seed", SEEDS)
def test_served_control_fails_the_comparison(card, seed, workload):
    import torch

    from perfbench import traffic as traffic_mod
    from perfbench import weights as weights_mod
    from perfbench.drivers import serve
    from perfbench.reference import mixtral
    from repro_torch.serving.engine import ServingEngine
    cell = harness.resolve(harness.load_spec(ROOT), ROOT, workload)
    conf = copy.deepcopy(cell.config)
    m, mix = conf["model"], cell.traffic
    w = weights_mod.make(m, seed, card)
    engine = ServingEngine(serve.model_config(conf), params=w,
                           max_batch=mix["engine"]["max_batch"],
                           max_len=mix["engine"]["max_len"], device=card)
    reqs = traffic_mod.requests(mix, seed, m["vocab_size"])
    serve.warm_up(engine, reqs, seed)
    served, _ = serve.serve_window(engine, reqs, time.perf_counter(), 20.0)
    done = [s for s in served.values() if s.engine_req.finished_at]
    del engine
    harness.free_device(card)
    seqs, toks = serve.served_sequences(serve.sample(done, seed))
    ref = mixtral.logits(m, w, seqs, card)
    ctl = mixtral.logits(m, w, seqs, card, quant="fp8")
    prog_mean = float(serve.gaps_of(ref, toks).mean())
    ctl_mean = float(serve.gaps_of(
        ref, [x.argmax(-1).cpu() for x in ctl]).mean())
    assert prog_mean <= serve.LOGIT_GAP_MEAN_LIMIT < ctl_mean, (prog_mean,
                                                               ctl_mean)
    del w, ref, ctl
    torch.cuda.empty_cache()
