"""The engine's decode wave recorded once as a CUDA graph and replayed.

On the card (tests marked ``card``; they skip without one):

* a graphed engine serves the tokens an eager engine serves, to the bit,
  with every cache leaf (K/V, the Mamba layers' ``ssm`` and ``conv_*``)
  equal at the end, on two bf16 models: one shaped like Mixtral (full
  causal attention, dropless top-2 of 4 experts) and one like Granite-4.0-H
  (Mamba-2 and NoPE attention, top-4 of 12 experts and a shared one);
  ragged prompts, admissions interleaved with retirements and re-admissions,
  at least 24 waves.  A wave decoded twice (an eager call on the live caches
  beside the recording) moves the caches and the tokens, so this fails;
* the two engines count alike: the engine's counters, the MoE layers'
  ``rows`` and the Mamba layers' ``state_steps``, with ``graph_waves`` the
  waves after the first; kernel B5's launches, read from a device trace by
  kernel name, are one a wave and attention layer in both, while its
  wrapper counts the graphed engine's eager wave and recording only;
* the model decides (``decode_capturable``): a model whose MoE computes in
  float32 keeps the eager wave (its grouped products read their offsets on
  the host), unless its dense switch takes the wave; a float32 model
  without experts is graphed; each serves the eager tokens.

On the CPU (tier 1): every wave is eager, ``graph_waves`` stays 0 and the
Mamba layers count their lanes a wave as before; the models' capture flag
and the counts a recording takes back and a replay adds again.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import get_arch
from repro_torch.kernels.attention import flash
from repro_torch.models import build_model, moe
from repro_torch.models.moe import Moe
from repro_torch.models.ssm import Mamba
from repro_torch.serving import Request, ServingEngine

MAX_BATCH, MAX_LEN = 3, 64
# (prompt length, new tokens, the step before which the request arrives)
SCRIPT = ((5, 9, 0), (23, 4, 0), (12, 14, 0), (40, 6, 2), (9, 11, 3),
          (17, 5, 3), (3, 12, 9), (31, 7, 10), (14, 10, 14))


def _bf16(cfg, **kw):
    return dataclasses.replace(cfg, param_dtype="bfloat16",
                               compute_dtype="bfloat16", **kw)


def _mixtral_like():
    cfg = get_arch("mixtral-8x7b").smoke
    return _bf16(cfg, attn_type="full",
                 capacity_factor=cfg.n_experts / cfg.top_k)


def _granite_like():
    return _bf16(get_arch("granite-4.0-h-small").smoke)


MODELS = {"mixtral": _mixtral_like, "granite": _granite_like}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _counts(engine) -> dict:
    """The engine's counters and its layers' host counters."""
    mods = list(engine.model.modules())
    return dict(engine.counters(),
                moe_rows=sum(m.rows for m in mods if isinstance(m, Moe)),
                state_steps=sum(m.state_steps for m in mods
                                if isinstance(m, Mamba)))


def _serve(engine) -> tuple[list, dict]:
    """:data:`SCRIPT` through the engine until it is idle: (the requests'
    tokens, the counts it made, kernel B5's wrapper calls among them and,
    on the card, its launches in a device trace of the run)."""
    rng = np.random.default_rng(5)
    vocab = engine.cfg.vocab_size
    pending = [(at, Request(id=i, tokens=rng.integers(1, vocab, n).tolist(),
                            max_new_tokens=new))
               for i, (n, new, at) in enumerate(SCRIPT)]
    reqs = [r for _, r in pending]
    calls = flash.flash_decode.launches
    on_card = engine.device.type == "cuda"
    prof = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) if on_card
        else contextlib.nullcontext())
    with prof:
        step = 0
        while pending or engine.queue or engine.active_count:
            while pending and pending[0][0] <= step:
                engine.submit(pending.pop(0)[1])
            engine.step()
            step += 1
        if on_card:
            torch.cuda.synchronize()
    assert all(r.finished_at for r in reqs)
    counts = dict(_counts(engine),
                  b5_calls=flash.flash_decode.launches - calls)
    if on_card:
        counts["b5_kernels"] = sum(e.count for e in prof.key_averages()
                                   if "decode_split_kernel" in e.key)
    return [r.output for r in reqs], counts


def _attention_layers(engine) -> int:
    cfg = engine.cfg
    return sum(not cfg.layer_kind(i).startswith("mamba")
               for i in range(cfg.n_layers))


@pytest.mark.card
@pytest.mark.parametrize("model", sorted(MODELS))
def test_graphed_waves_serve_the_eager_tokens_and_caches(card, model):
    cfg = MODELS[model]()
    graphed = ServingEngine(cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                            seed=0, device=card)
    eager = ServingEngine(cfg, max_batch=MAX_BATCH, max_len=MAX_LEN, seed=0,
                          device=card)
    eager._graphed = False
    got, got_counts = _serve(graphed)
    want, want_counts = _serve(eager)
    assert graphed._graphed
    assert got == want
    for i, (big_g, big_e) in enumerate(zip(graphed.caches, eager.caches)):
        assert sorted(big_g) == sorted(big_e)
        for name in big_g:
            assert torch.equal(big_g[name], big_e[name]), (i, name)
    kinds = {name for c in graphed.caches for name in c}
    assert kinds == ({"k", "v"} if model == "mixtral" else
                     {"k", "v", "ssm", "conv_x", "conv_b", "conv_c"})
    waves = want_counts["waves"]
    assert waves >= 24
    assert want_counts.pop("graph_waves") == 0
    assert got_counts.pop("graph_waves") == waves - 1
    layers = _attention_layers(graphed)
    assert want_counts.pop("b5_calls") == layers * waves
    assert got_counts.pop("b5_calls") == layers * 2   # eager + recording
    assert want_counts["b5_kernels"] == layers * waves
    assert got_counts == want_counts


def _float32_mixtral(family: str):
    cfg = dataclasses.replace(_mixtral_like(), param_dtype="float32",
                              compute_dtype="float32")
    if family == "dense":
        cfg = dataclasses.replace(cfg, family="dense", n_experts=0, top_k=0)
    return cfg


@pytest.mark.card
@pytest.mark.parametrize("family, graphed", [("moe", False),
                                             ("moe_dense_switch", True),
                                             ("dense", True)])
def test_float32_moe_keeps_the_eager_wave(card, family, graphed,
                                          monkeypatch):
    """As the model reports: float32 grouped products read their offsets
    on the host, so a float32 MoE model is not graphed, unless the dense
    switch (batched matmuls) takes its waves; a float32 model without
    experts is.  Each serves the eager engine's tokens."""
    if family == "moe_dense_switch":
        monkeypatch.setattr(moe, "DENSE_MODE_MAX_TOKENS", MAX_BATCH)
    cfg = _float32_mixtral(family)
    engine = ServingEngine(cfg, max_batch=MAX_BATCH, max_len=MAX_LEN, seed=0,
                           device=card)
    got, counts = _serve(engine)
    assert engine._graphed == graphed
    assert counts["graph_waves"] == (counts["waves"] - 1 if graphed else 0)
    assert counts["b5_kernels"] == _attention_layers(engine) * counts["waves"]
    eager = ServingEngine(cfg, max_batch=MAX_BATCH, max_len=MAX_LEN, seed=0,
                          device=card)
    eager._graphed = False
    assert _serve(eager)[0] == got


@pytest.mark.parametrize("family, dtype, dense_max, capturable", [
    ("moe", "bfloat16", 0, True), ("moe", "float32", 0, False),
    ("moe", "float32", MAX_BATCH, True),
    ("moe", "float32", MAX_BATCH - 1, False),
    ("dense", "float32", 0, True)])
def test_decode_capturable_is_the_moe_layers_answer(family, dtype,
                                                     dense_max, capturable,
                                                     monkeypatch):
    monkeypatch.setattr(moe, "DENSE_MODE_MAX_TOKENS", dense_max)
    cfg = dataclasses.replace(_float32_mixtral(family), param_dtype=dtype,
                              compute_dtype=dtype)
    model = build_model(cfg, "cpu", seed=0)
    assert model.decode_capturable(MAX_BATCH) == capturable


def test_a_recordings_counts_are_taken_back_and_added_again():
    """What a decode step counts through ``tracing.count`` (MoE rows,
    Mamba lanes) is collected by ``counts_made``; taking it back restores
    the counters, and adding it again gives what an eager step counts."""
    cfg = dataclasses.replace(_granite_like(), param_dtype="float32",
                              compute_dtype="float32")
    model = build_model(cfg, "cpu", seed=0)
    caches = model.init_caches(MAX_BATCH, MAX_LEN)
    tokens = torch.ones((MAX_BATCH, 1), dtype=torch.int64)
    pos = torch.tensor([3, 0, 7], dtype=torch.int32)

    def totals():
        mods = list(model.modules())
        return (sum(m.rows for m in mods if isinstance(m, Moe)),
                sum(m.state_steps for m in mods if isinstance(m, Mamba)))

    model.decode_step(tokens, caches, pos)
    eager = totals()
    with tracing.counts_made() as counts:
        model.decode_step(tokens, caches, pos)
    assert totals() == (2 * eager[0], 2 * eager[1])
    assert {name for _, name, _ in counts} == {"rows", "state_steps"}
    tracing.add_counts(counts, -1)
    assert totals() == eager
    tracing.add_counts(counts)
    tracing.add_counts(counts)
    assert totals() == (3 * eager[0], 3 * eager[1])
    assert eager[0] > 0 and eager[1] > 0


def test_cpu_waves_are_eager_and_count_as_before():
    cfg = dataclasses.replace(_granite_like(), param_dtype="float32",
                              compute_dtype="float32")
    engine = ServingEngine(cfg, max_batch=MAX_BATCH, max_len=MAX_LEN, seed=0,
                           device="cpu")
    _, counts = _serve(engine)
    assert engine._graphed is False
    mambas = sum(isinstance(m, Mamba) for m in engine.model.modules())
    assert counts["graph_waves"] == 0
    assert counts["lanes"] == MAX_BATCH * counts["waves"]
    assert counts["state_steps"] == mambas * counts["lanes"]
    assert counts["b5_calls"] == 0             # the CPU runs plain B5
    assert engine._graph is None
