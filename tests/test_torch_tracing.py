"""The serving path's spans and counters, on the CPU with a tiny MoE model:

* with no profiler recording, a span never enters a profiler range;
* the private range binding the spans rest on still imports, builds from
  a name alone and records a host range;
* under a CPU profile, one engine step with an admission records the
  ``engine.*``, ``attn.*`` and ``moe.*`` spans with the nesting the
  docstrings of the engine and of ``repro_torch.tracing`` list;
* the engine's counters equal the values worked out by hand from a scripted
  run's prompts, buckets and positions (retired and never-used lanes' keys
  included; full causal layers, windowed ones, and ones whose window is
  as long as the engine's linear cache; no wave replayed from a CUDA graph
  on the CPU), a ring cache's keys stopping at its filled slots, the
  host's count of B5's keys equal to what the plain B5 reads, and the
  MoE's rows equal the N x top_k packed rows its grouped products run a
  call (E x N on the dense switch);
* two identical scripted runs count the same.
"""
import dataclasses
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.configs import get_arch
from repro_torch.kernels.attention.ref import decode_ref
from repro_torch.models import ModelConfig, build_model
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import KVLayout
from repro_torch.serving import Request, ServingEngine

TINY_MOE = dict(name="tiny-moe", family="moe", n_layers=2, d_model=32,
                n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=128,
                n_experts=4, top_k=2, capacity_factor=2.0,
                param_dtype="float32", compute_dtype="float32")
PREFIXES = ("engine.", "attn.", "moe.")


def _engine(max_batch=3, max_len=64, **cfg):
    return ServingEngine(ModelConfig(**dict(TINY_MOE, **cfg)),
                         max_batch=max_batch, max_len=max_len, device="cpu")


def _moes(engine):
    return [m for m in engine.model.modules() if isinstance(m, moe_mod.Moe)]


def _scripted(engine):
    """A(5 tokens, 3 new) and B(20, 2) at the start, D(3, 4) before the
    second step; steps until the engine is idle.  Returns the requests."""
    a = Request(id=0, tokens=list(range(1, 6)), max_new_tokens=3)
    b = Request(id=1, tokens=list(range(1, 21)), max_new_tokens=2)
    d = Request(id=2, tokens=[7, 8, 9], max_new_tokens=4)
    engine.submit(a)
    engine.submit(b)
    engine.step()
    engine.submit(d)
    while engine.queue or engine.active_count:
        engine.step()
    engine.step()                                   # idle: no wave
    return a, b, d


def test_span_off_never_enters_a_profiler_range(monkeypatch):
    entered = []

    def counting(name, *args):
        entered.append(name)
        return torch._C._profiler._RecordFunctionFast(name, *args)
    monkeypatch.setattr(tracing, "_RecordFunctionFast", counting)
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("engine.wave") is tracing.span("moe.route")
    _scripted(_engine())
    assert entered == []
    # the same patch sees the spans once a profiler records
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("engine.wave"):
            pass
    assert entered == ["engine.wave"]


def test_the_private_range_binding_still_records():
    why = (f"torch {torch.__version__}: repro_torch.tracing.span rests on "
           "torch._C._profiler._RecordFunctionFast(name)")
    try:
        from torch._C._profiler import _RecordFunctionFast
        with profile(activities=[ProfilerActivity.CPU]) as p:
            with _RecordFunctionFast("engine.probe"):
                pass
    except (ImportError, TypeError) as exc:
        pytest.fail(f"{why}, which no longer works: {exc!r}")
    got = [(e.name(), e.device_type())
           for e in p.profiler.kineto_results.events()
           if e.name() == "engine.probe"]
    assert got == [("engine.probe", torch.autograd.DeviceType.CPU)], why


def _program_spans(prof):
    """(name, innermost enclosing program span or None) of every program
    span the profile recorded."""
    out = []
    for fe in prof.events():
        if not fe.name.startswith(PREFIXES):
            continue
        up = fe.cpu_parent
        while up is not None and not up.name.startswith(PREFIXES):
            up = up.cpu_parent
        out.append((fe.name, None if up is None else up.name))
    return out


def test_one_step_records_the_spans_and_their_nesting():
    engine = _engine()
    layers = engine.cfg.n_layers
    engine.submit(Request(id=41, tokens=[3, 1, 4, 1, 5], max_new_tokens=4))
    with profile(activities=[ProfilerActivity.CPU]) as p:
        engine.step()
    got = _program_spans(p)
    counts = {}
    for pair in got:
        counts[pair] = counts.get(pair, 0) + 1
    moe = ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")
    want = {("engine.admit", None): 1,
            ("engine.prefill", "engine.admit"): 1,
            ("attn.prefill", "engine.prefill"): layers,
            ("engine.splice", "engine.admit"): 1,
            ("engine.first_token", "engine.admit"): 1,
            ("engine.wave", None): 1,
            ("engine.decode", "engine.wave"): 1,
            ("attn.decode", "engine.decode"): layers,
            ("engine.sample", "engine.wave"): 1,
            ("engine.retire", "engine.wave"): 1}
    want.update({(m, "engine.prefill"): layers for m in moe})
    want.update({(m, "engine.decode"): layers for m in moe})
    assert counts == want


# Keys a layer's B5 reads a wave, (all lanes, live lanes), in the scripted
# run (the lanes' positions are worked out in the test):
#   full causal: min(position + 1, max_len) a lane
#     waves 6 + 21 + 1, 7 + 4 + 1, 8 + 5 + 1, 8 + 6 + 1; live 27, 11, 5, 6
#   window 4: min(position + 1, 4) a lane; live 8, 8, 4, 4
#   window 64 = max_len: the engine's cache is linear, not a ring, and a
#   window as long as it never cuts: the full case's keys
KEYS = {"full": ({}, 28 + 12 + 14 + 15, 27 + 11 + 5 + 6),
        "window": (dict(attn_type="swa", sliding_window=4),
                   4 * (4 + 4 + 1), 8 + 8 + 4 + 4),
        "ring": (dict(attn_type="swa", sliding_window=64),
                 28 + 12 + 14 + 15, 27 + 11 + 5 + 6)}


@pytest.mark.parametrize("attn", sorted(KEYS))
def test_engine_counters_follow_prompts_buckets_and_positions(attn):
    kind, keys, live_keys = KEYS[attn]
    engine = _engine(max_batch=3, max_len=64, **kind)
    layers = engine.cfg.n_layers
    before = engine.counters()
    t0 = time.perf_counter()
    a, b, d = _scripted(engine)
    t1 = time.perf_counter()
    got = {k: v - before[k] for k, v in engine.counters().items()}
    # step 1: A -> lane 0 at 5, B -> lane 1 at 20, lane 2 never used (0);
    #   B retires at 21
    # step 2: D -> lane 1 at 3; A retires at 7
    # steps 3, 4: lane 0 stale at 7, D at 4 and 5; D retires; step 5 idle
    assert got == {"steps": 5, "waves": 4,
                   "prompt_tokens": 5 + 20 + 3,
                   "bucket_tokens": 16 + 32 + 16, "lanes": 4 * 3,
                   "live_lanes": 2 + 2 + 1 + 1,
                   "b5_keys": layers * keys,
                   "live_keys": layers * live_keys,
                   "graph_waves": 0}     # the CPU's waves are eager
    assert [len(r.output) for r in (a, b, d)] == [3, 2, 4]
    for r in (a, b, d):
        assert t0 <= r.submitted_at <= r.admitted_at <= r.finished_at <= t1
    # each prefill routes its bucket, each wave all 3 lanes, in each layer:
    # top_k packed rows a token
    cfg = engine.cfg
    rows = sum(cfg.top_k * n for n in (16, 32, 16, 3, 3, 3, 3))
    moes = _moes(engine)
    assert len(moes) == cfg.n_layers
    assert sum(m.rows for m in moes) == cfg.n_layers * rows


def test_decode_keys_skip_mamba_layers_and_sum_the_others():
    """A hybrid stack: its Mamba layers read no keys, its attention layers
    the causal keys of each lane."""
    cfg = dataclasses.replace(get_arch("jamba-1.5-large-398b").smoke,
                              param_dtype="float32", compute_dtype="float32")
    engine = ServingEngine(cfg, max_batch=2, max_len=32, device="cpu")
    kinds = [blk.kind for blk in engine.model.layers]
    attn = sum(not k.startswith("mamba") for k in kinds)
    assert 0 < attn < len(kinds), kinds
    pos = np.array([0, 9], dtype=np.int32)
    assert engine.model.decode_keys(engine.caches, pos).tolist() == [
        attn * 1, attn * 10]


def test_decode_keys_of_ring_caches_stop_at_the_filled_slots():
    """Ring caches of W = 4 slots (outside the engine, which keeps its
    caches linear): a lane at position p reads slots 0..p until the ring
    has filled, then all 4."""
    cfg = ModelConfig(**dict(TINY_MOE, attn_type="swa", sliding_window=4))
    model = build_model(cfg, "cpu")
    caches = model.init_caches(3, 16)
    assert {c["k"].shape[1] for c in caches} == {4}
    pos = np.array([0, 2, 9], dtype=np.int32)
    assert model.decode_keys(caches, pos).tolist() == [
        cfg.n_layers * n for n in (1, 3, 4)]


# layout, cache length: a full and a windowed linear cache, and a ring
LAYOUTS = {"full": (KVLayout(0, False), 16),
           "window": (KVLayout(4, False), 16),
           "ring": (KVLayout(4, True), 4)}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_host_key_count_is_what_decode_ref_reads(name):
    """The host's count of B5's keys against the keys the plain B5 leaves
    unmasked for the same (position, window), at every position a cache
    of 16 slots holds (a ring's past its 4 slots too): with equal scores,
    values e_j give each unmasked key j 1/n of the output."""
    layout, length = LAYOUTS[name]
    pos = np.arange(16)
    q = torch.zeros(len(pos), 1, 1, length)
    k = torch.zeros(len(pos), length, 1, length)
    v = torch.eye(length).expand(len(pos), length, length)[:, :, None]
    p, w = layout.reads(length, torch.from_numpy(pos))
    out = decode_ref(q, k, v, position=p, window=w)
    assert layout.keys(length, pos).tolist() == (
        out[:, 0, 0] > 0).sum(-1).tolist()


@pytest.mark.parametrize("n", [1, 7, 40])
def test_moe_rows_are_experts_times_capacity_a_call(n, monkeypatch):
    """The rows the experts' products run: a dispatch's N x top_k packed
    rows (no longer E x capacity(N): the grouped products skip the empty
    capacity rows), E x N on the dense switch."""
    cfg = ModelConfig(**TINY_MOE)
    m = moe_mod.Moe(cfg)
    m.init_weights(torch.Generator().manual_seed(0))
    x = torch.randn(1, n, cfg.d_model)
    m(x)
    m(x)
    assert m.rows == 2 * n * cfg.top_k
    # the dense path runs every expert over every token
    monkeypatch.setattr(moe_mod, "DENSE_MODE_MAX_TOKENS", n)
    m.rows = 0
    m(x)
    assert m.rows == cfg.n_experts * n


def test_two_identical_runs_count_the_same():
    runs = []
    for _ in range(2):
        engine = _engine()
        reqs = _scripted(engine)
        runs.append((engine.counters(),
                     [m.rows for m in _moes(engine)],
                     [r.output for r in reqs]))
    assert runs[0] == runs[1]

