"""The hybrid cell (``granite-rag``) on the CPU at a small size: a sound whole
run is ``correct`` and each fault of the served hybrid makes it incorrect;
kernel B6's bound worked out by hand at one shape; the readers of the
cell's program counter; the reference imports nothing of the program.
The control on the card (the reference in fp8 fails the comparison the
program passes) is ``test_served_control_fails_the_comparison`` here,
marked ``card``."""
import copy
import time

import pytest
from perfbench_cells import ROOT, run_small, small_cell

from perfbench import harness, hybrid_cost
from perfbench.harness import Record

# the cell's mechanisms at a size the CPU runs in seconds: a period of four
# with its attention layer at offset 1 (the configuration's 10 and 5),
# top-3 of 8 experts with a shared expert twice as wide, SSD chunks of 16
GRANITE_SMALL = dict(n_layers=4, attn_every=4, attn_offset=1, n_experts=8,
                     top_k=3, d_ff=32, shared_d_ff=64, ssm_state=16,
                     ssm_head_dim=16, ssm_chunk=16, attn_scale=1 / 16,
                     capacity_factor=8 / 3)


def ok(out) -> bool:
    return bool(out.checks) and all(c.ok for c in out.checks)


def _cell():
    return small_cell("granite-rag", **GRANITE_SMALL)


def _fault(kind, monkeypatch):
    from repro_torch.models import ssm
    from repro_torch.models.model import DecoderOnlyLM
    if kind == "state_unchanged":
        # the decode wave never writes its new Mamba state
        real = ssm.Mamba.decode

        def frozen(self, x, state):
            return real(self, x, state)[0], state
        monkeypatch.setattr(ssm.Mamba, "decode", frozen)
        return
    if kind == "pads_in_state":
        # R5 undone: the prefill's state sees the bucket's pads
        real_prefill = ssm.Mamba.prefill
        monkeypatch.setattr(ssm.Mamba, "prefill",
                            lambda self, x, length=None: real_prefill(self, x))
        return
    real = DecoderOnlyLM.decode_step

    def broken(self, tokens, caches, position):
        logits, caches = real(self, tokens, caches, position)
        logits = logits.clone()
        if kind == "token_altered":
            top = logits.argmax(-1, keepdim=True)
            logits.scatter_(-1, top, float("-inf"))
        elif kind == "half_batch":
            logits[logits.shape[0] // 2:] = 0.0
        return logits, caches
    monkeypatch.setattr(DecoderOnlyLM, "decode_step", broken)


def test_hybrid_sound_run_is_correct():
    out = run_small(_cell(), seconds=3.0)
    assert ok(out), out.checks
    assert out.values["tokens_per_s"] > 0 and out.attempted >= 2
    assert out.notes["served_tokens_compared"] >= 32


@pytest.mark.parametrize("fault", ["state_unchanged", "pads_in_state",
                                   "token_altered", "half_batch"])
def test_hybrid_fault_is_not_correct(fault, monkeypatch):
    _fault(fault, monkeypatch)
    out = run_small(_cell(), seconds=3.0)
    assert not ok(out), (fault, out.checks)


def test_hybrid_config_is_refused_by_a_program_without_its_fields():
    """The driver builds the program's configuration from every key of
    ``model``: one the program lacks raises at once."""
    cell = _cell()
    drv = harness.driver_for(ROOT, cell)
    conf = copy.deepcopy(cell.config)
    assert drv.model_config(conf).attn_offset == 1
    conf["model"]["a_field_no_program_has"] = 1
    with pytest.raises(TypeError):
        drv.model_config(conf)


def test_b6_bound_by_hand():
    """One Mamba layer of the configuration over n = 300 real tokens in
    chunks of 256: H 128, P 64, G 1, N 128."""
    m = harness.resolve(harness.load_spec(ROOT), ROOT,
                        "granite-rag").config["model"]
    n = 300
    pairs = 256 * 257 // 2 + 44 * 45 // 2               # 33,896 + 990
    ops = (2 * pairs * (128 + 128 * 64) + 4 * n * 128 * 64 * 128
           + 2 * 2 * 128 * 64 * 128)
    nbytes = 2 * n * (2 * 8192 + 2 * 128) + 4 * n * 128 + 2 * 8192 * 128
    assert hybrid_cost.chunk_pairs(n, 256) == pairs
    assert hybrid_cost.scan_flops(m, n) == ops
    assert hybrid_cost.scan_bytes(m, n) == nbytes
    assert hybrid_cost.scan_bound_s(m, n) == pytest.approx(
        max(ops / 989e12, nbytes / 3.35e12))
    assert hybrid_cost.layer_counts(m) == (2, 18)


def test_readers_of_the_cell():
    program = {"steps": 3, "waves": 2, "prompt_tokens": 90,
               "bucket_tokens": 128, "lanes": 16, "live_lanes": 10,
               "b5_keys": 300, "live_keys": 200, "moe_rows": 4000,
               "scan_tokens": 256, "state_steps": 32}
    counters = {"program": program, "top_k": 10, "moe_layers": 2,
                "b6_bound_s": 0.5}
    rec = Record(cell="granite-rag", counters=counters)
    assert harness.reader_for(ROOT, "moe_row_use.rag").read(rec) == 50.0
    assert harness.reader_for(ROOT, "b6_roofline.rag").read(rec) is None
    empty = Record(cell="granite-rag")
    for name in ("moe_row_use.rag", "b6_roofline.rag", "mfu.rag",
                 "decode_step_ms.rag", "idle_share.rag"):
        assert harness.reader_for(ROOT, name).read(empty) is None


def test_a_window_records_what_the_readers_read():
    cell = _cell()
    drv = harness.driver_for(ROOT, cell)
    ctx = harness.Context(cell, 2**31 + 9, 3.0, False, time.perf_counter(),
                          device="cpu")
    drv.run(ctx)
    c = ctx.record.counters
    prog = c["program"]
    # three Mamba layers: each scans every bucket token and steps every lane
    assert prog["scan_tokens"] == 3 * prog["bucket_tokens"] > 0
    assert prog["state_steps"] == 3 * prog["lanes"] > 0
    assert 0 < harness.reader_for(ROOT, "moe_row_use.rag").read(
        ctx.record) <= 100
    assert c["b6_bound_s"] > 0 and c["flops"] > 0


@pytest.mark.card
@pytest.mark.parametrize("seed", (2**31 + 101, 2**31 + 102, 2**31 + 103))
def test_served_control_fails_the_comparison(card, seed):
    import torch

    from perfbench import hybrid_weights
    from perfbench import traffic as traffic_mod
    from perfbench.drivers import hybrid, serve
    from perfbench.reference import granite
    from repro_torch.serving.engine import ServingEngine
    cell = harness.resolve(harness.load_spec(ROOT), ROOT, "granite-rag")
    m, mix = cell.config["model"], cell.traffic
    w = hybrid_weights.make(m, seed, card)
    engine = ServingEngine(hybrid.model_config(cell.config), params=w,
                           max_batch=mix["engine"]["max_batch"],
                           max_len=mix["engine"]["max_len"], device=card)
    reqs = traffic_mod.requests(mix, seed, m["vocab_size"])
    serve.warm_up(engine, reqs, seed)
    served, _ = serve.serve_window(engine, reqs, time.perf_counter(), 20.0)
    done = [s for s in served.values() if s.engine_req.finished_at]
    del engine
    harness.free_device(card)
    seqs, toks = serve.served_sequences(serve.sample(done, seed))
    ref = granite.logits(m, w, seqs, card)
    ctl = granite.logits(m, w, seqs, card, quant="fp8")
    prog_mean = float(serve.gaps_of(ref, toks).mean())
    ctl_mean = float(serve.gaps_of(
        ref, [x.argmax(-1).cpu() for x in ctl]).mean())
    assert prog_mean <= hybrid.LOGIT_GAP_MEAN_LIMIT < ctl_mean, (prog_mean,
                                                                ctl_mean)
    del w, ref, ctl
    torch.cuda.empty_cache()


def test_the_hybrid_reference_loads_nothing_of_the_program():
    from test_perfbench_imports import FORBIDDEN, _loaded_after
    loaded = _loaded_after("import perfbench.reference.granite\n")
    assert not loaded & (FORBIDDEN | {"repro_torch"})
