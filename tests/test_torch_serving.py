"""The port's serving stack against the reference's, on the CPU:

* ``ServingEngine`` emits the reference engine's tokens (one request, and
  concurrent requests in ragged lanes) with the same parameters, and equals
  its own direct greedy decode (``tests/test_serving_checkpoint.py``); the
  same for the Mixtral smoke model (MoE, prompts past its 16-token window,
  pad tokens and idle lanes routed as in the reference); for the Mamba-2
  smoke model and jamba's (the hybrid: Mamba states and attention caches
  of one slot spliced side by side, MoE layers after both mixers), with
  prompts right-padded to their buckets, each request's tokens are the
  reference model's after a prefill of its unpadded prompt: the port's
  Mamba state is the real prompt's (ROADMAP R5), the reference engine's
  carries the pads;
* ``MultiTierServer`` with the port's ``AifRouter`` over the three tiny
  tiers of ``examples/serve_multitier.py``, with the reference router's key
  chain replayed as its noise (``RouterKeyChainNoise``), gives the
  reference run's results: the routing weights of every tick, tier routing,
  completions, P50/P95 and every request's tokens.

Tokens, routing and counts must be equal; the models run in float32.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.core import DiscretizationConfig as RefDisc
from repro.envsim.routers import AifRouter as RefAifRouter
from repro.models import ModelConfig as RefModelConfig
from repro.models import build_model as ref_build_model
from repro.serving import MultiTierServer as RefMultiTierServer
from repro.serving import ServingEngine as RefServingEngine
from repro.serving import TierRuntime as RefTierRuntime
from repro_torch.configs import get_arch
from repro_torch.core import DiscretizationConfig
from repro_torch.envsim.routers import AifRouter
from repro_torch.models import ModelConfig
from repro_torch.serving import (MultiTierServer, Request, ServingEngine,
                                 TierRuntime)
from torch_port_ref import RouterKeyChainNoise, lm_to_port

TINY = dict(name="tiny-serve", family="dense", n_layers=2, d_model=32,
            n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=128,
            param_dtype="float32", compute_dtype="float32")


def _ref_params(kw):
    """The reference model's parameters (``init`` under one jit: the
    engine's own eager init compiles op by op and dominates the test)."""
    return jax.jit(ref_build_model(RefModelConfig(**kw)).init)(
        jax.random.key(0))


def _engines(max_batch, max_len=64):
    ref = RefServingEngine(RefModelConfig(**TINY), _ref_params(TINY),
                           max_batch=max_batch, max_len=max_len)
    cfg = ModelConfig(**TINY)
    sd, _ = lm_to_port(cfg, ref.params)
    port = ServingEngine(cfg, sd, max_batch=max_batch, max_len=max_len,
                         device="cpu")
    return ref, port


def _serve(engine, request_cls, prompts, n_new, max_steps=40):
    reqs = [request_cls(id=i, tokens=p, max_new_tokens=n_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    for _ in range(max_steps):
        engine.step()
        if all(r.finished_at for r in reqs):
            break
    assert all(r.finished_at for r in reqs)
    return [r.output for r in reqs]


def _greedy(engine, prompt, n_new):
    """Direct model greedy decode (ground truth for the engine)."""
    m = engine.model
    logits, caches = m.prefill(torch.tensor([prompt]),
                               max_len=len(prompt) + n_new + 4)
    out = [int(torch.argmax(logits[0, -1]))]
    pos = len(prompt)
    for _ in range(n_new - 1):
        logits, caches = m.decode_step(torch.tensor([[out[-1]]]), caches, pos)
        out.append(int(torch.argmax(logits[0, 0])))
        pos += 1
    return out


def test_engine_matches_reference_engine_one_request():
    from repro.serving import Request as RefRequest
    ref, port = _engines(max_batch=2)
    prompt = list(range(5, 21))          # length 16 == bucket, no padding
    want = _serve(ref, RefRequest, [prompt], 6)
    got = _serve(port, Request, [prompt], 6)
    assert got == want
    assert got[0] == _greedy(port, prompt, 6)


def test_engine_matches_reference_engine_concurrent_ragged():
    """Concurrent requests of different lengths (right-padded buckets,
    ragged decode positions) must not corrupt each other."""
    from repro.serving import Request as RefRequest
    ref, port = _engines(max_batch=4)
    prompts = [list(range(3, 19)), list(range(40, 51)), list(range(7, 30)),
               list(range(60, 65))]
    want = _serve(ref, RefRequest, prompts, 5)
    got = _serve(port, Request, prompts, 5)
    assert got == want
    for p, out in zip(prompts, got):
        assert out == _greedy(port, p, 5)
    assert (port.steps, port.busy_steps) == (ref.steps, ref.busy_steps)


def _ref_greedy(ref_cfg, params, prompt, n_new, max_len=64):
    """The reference model's greedy decode after its prefill of the
    unpadded ``prompt`` (ground truth for a padded admission: the
    reference's own engine pads the prompt into its Mamba state)."""
    import jax.numpy as jnp
    model = ref_build_model(ref_cfg)
    logits, caches = model.prefill(params, {"tokens": jnp.asarray([prompt])},
                                   max_len=max_len)
    out = [int(jnp.argmax(logits[0, -1]))]
    for pos in range(len(prompt), len(prompt) + n_new - 1):
        logits, caches = model.decode_step(params, jnp.asarray([[out[-1]]]),
                                           caches, pos)
        out.append(int(jnp.argmax(logits[0, 0])))
    return out


def _f32(c):
    return dataclasses.replace(c, param_dtype="float32",
                               compute_dtype="float32")


def test_mamba_engine_matches_reference_engine_on_padded_prompts():
    """mamba2's smoke model in float32: two slots, four requests (so slots
    are reused) of lengths 11, 16, 20 and 5, all but one right-padded to
    their buckets; the port's engine hands decode the state of the real
    prompt (ROADMAP R5), so each request's tokens are the reference
    model's greedy decode after a prefill of its unpadded prompt, and the
    port's own."""
    ref_cfg = _f32(ref_get_arch("mamba2-2.7b").smoke)
    params = jax.jit(ref_build_model(ref_cfg).init)(jax.random.key(0))
    cfg = _f32(get_arch("mamba2-2.7b").smoke)
    sd, _ = lm_to_port(cfg, params)
    port = ServingEngine(cfg, sd, max_batch=2, max_len=64, device="cpu")
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in (11, 16, 20, 5)]
    got = _serve(port, Request, prompts, 5)
    assert got == [_ref_greedy(ref_cfg, params, p, 5) for p in prompts]
    assert got == [_greedy(port, p, 5) for p in prompts]
    assert (port.steps, port.busy_steps) == (8, 8)


def test_hybrid_engine_matches_reference_engine_on_padded_prompts():
    """jamba's smoke model in float32 (``mamba_mlp``, ``mamba_moe`` and
    ``attn_moe`` layers): two slots, four requests of lengths 13, 16, 11
    and 9, three right-padded to the one bucket, so slots are reused with
    both cache kinds spliced into them and a decode wave runs with an idle
    lane; each request's tokens are the reference model's greedy decode
    after a prefill of its unpadded prompt."""
    ref_cfg = _f32(ref_get_arch("jamba-1.5-large-398b").smoke)
    params = jax.jit(ref_build_model(ref_cfg).init)(jax.random.key(0))
    cfg = _f32(get_arch("jamba-1.5-large-398b").smoke)
    sd, _ = lm_to_port(cfg, params)
    port = ServingEngine(cfg, sd, max_batch=2, max_len=64, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in (13, 16, 11, 9)]
    got = _serve(port, Request, prompts, 6)
    assert got == [_ref_greedy(ref_cfg, params, p, 6) for p in prompts]
    assert got[1] == _greedy(port, prompts[1], 6)
    assert (port.steps, port.busy_steps) == (10, 10)
    assert [sorted(c) for c in port.caches[2:4]] == [
        ["conv_b", "conv_c", "conv_x", "ssm"], ["k", "v"]]


def test_moe_engine_matches_reference_engine():
    """mixtral's smoke model in float32 (top-2 of 4 experts, window 16):
    two slots, four requests of lengths 20, 11, 30 and 16 (three
    right-padded to their buckets, two past the window), so slots are
    reused and a decode wave runs with an idle lane."""
    from repro.serving import Request as RefRequest

    def f32(c):
        return dataclasses.replace(c, param_dtype="float32",
                                   compute_dtype="float32")
    ref_cfg = f32(ref_get_arch("mixtral-8x7b").smoke)
    params = jax.jit(ref_build_model(ref_cfg).init)(jax.random.key(0))
    ref = RefServingEngine(ref_cfg, params, max_batch=2, max_len=64)
    cfg = f32(get_arch("mixtral-8x7b").smoke)
    sd, _ = lm_to_port(cfg, params)
    port = ServingEngine(cfg, sd, max_batch=2, max_len=64, device="cpu")
    rng = np.random.default_rng(6)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in (20, 11, 30, 16)]
    want = _serve(ref, RefRequest, prompts, 6)
    got = _serve(port, Request, prompts, 6)
    assert got == want
    assert got[3] == _greedy(port, prompts[3], 6)
    assert (port.steps, port.busy_steps) == (ref.steps, ref.busy_steps)


@pytest.mark.parametrize("arch_id", ["mixtral-8x7b", "gemma3-1b"])
def test_engine_whose_window_spans_its_cache_serves_full_attention(arch_id):
    """At ``max_len`` <= W the engine's linear caches are read causally at
    each lane's own position (ROADMAP C10), and a window that never cuts is
    full attention: ragged requests, one reusing a retired lane, get the
    tokens of the same weights with ``attn_type="full"``, every wave's
    logits within 1e-5."""
    max_len = 32
    cfg = dataclasses.replace(get_arch(arch_id).smoke, sliding_window=max_len,
                              param_dtype="float32", compute_dtype="float32")
    windowed = ServingEngine(cfg, max_batch=3, max_len=max_len, seed=0,
                             device="cpu")
    full = ServingEngine(dataclasses.replace(cfg, attn_type="full"),
                         windowed.model.state_dict(), max_batch=3,
                         max_len=max_len, device="cpu")
    rng = np.random.default_rng(4)
    prompts = [(rng.integers(1, cfg.vocab_size, n).tolist(), m)
               for n, m in [(5, 12), (20, 16), (9, 3), (14, 18)]]
    runs = []
    for engine in (windowed, full):
        logits = []
        step = engine.model.decode_step

        def recording(*args, step=step, logits=logits):
            out = step(*args)
            logits.append(out[0].clone())
            return out
        engine.model.decode_step = recording
        reqs = [Request(id=i, tokens=t, max_new_tokens=m)
                for i, (t, m) in enumerate(prompts)]
        for r in reqs:
            engine.submit(r)
        while engine.queue or engine.active_count:
            engine.step()
        runs.append(([r.output for r in reqs], torch.stack(logits)))
    assert runs[0][0] == runs[1][0]
    np.testing.assert_allclose(runs[0][1].numpy(), runs[1][1].numpy(),
                               rtol=0, atol=1e-5)


def test_engine_random_weights_come_from_its_seed():
    cfg = ModelConfig(**TINY)
    a = ServingEngine(cfg, max_batch=1, seed=3, device="cpu")
    b = ServingEngine(cfg, max_batch=1, seed=3, device="cpu")
    c = ServingEngine(cfg, max_batch=1, seed=4, device="cpu")
    assert torch.equal(a.model.layers[0].mlp.wi, b.model.layers[0].mlp.wi)
    assert not torch.equal(a.model.layers[0].mlp.wi,
                           c.model.layers[0].mlp.wi)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServingEngine(cfg)


N_TICKS = 30
DISC = dict(latency_edges_s=(3.0, 6.0), rps_edges=(3.0, 6.0),
            queue_edges=(3.0, 10.0))
TIERS = [("light", 32, 2, 1), ("medium", 48, 3, 1), ("heavy", 64, 8, 3)]


def _tier_cfg(name, d_model):
    return dict(name=name, family="dense", n_layers=2, d_model=d_model,
                n_heads=4, n_kv_heads=2, d_ff=2 * d_model, vocab_size=256,
                param_dtype="float32", compute_dtype="float32")


def test_multitier_with_aif_router_matches_reference():
    ref_tiers, tiers = [], []
    for name, d, max_batch, steps in TIERS:
        kw = _tier_cfg(name, d)
        eng = RefServingEngine(RefModelConfig(**kw), _ref_params(kw),
                               max_batch=max_batch, max_len=64, name=name)
        ref_tiers.append(RefTierRuntime(eng, steps_per_tick=steps))
        sd, _ = lm_to_port(ModelConfig(**kw), eng.params)
        tiers.append(TierRuntime(
            ServingEngine(ModelConfig(**kw), sd, max_batch=max_batch,
                          max_len=64, name=name, device="cpu"),
            steps_per_tick=steps))
    run = dict(n_ticks=N_TICKS, arrival_rate=4.0, prompt_len=16,
               max_new_tokens=4, vocab=256)
    ref_router = RefAifRouter(disc=RefDisc(**DISC), seed=0)
    ref_srv = RefMultiTierServer(ref_tiers, ref_router, slo_ticks=8, seed=0)
    want = ref_srv.run(**run)
    router = AifRouter(disc=DiscretizationConfig(**DISC), seed=0,
                       noise=RouterKeyChainNoise(0, N_TICKS), device="cpu")
    srv = MultiTierServer(tiers, router, slo_ticks=8, seed=0)
    got = srv.run(**run)

    assert router.actions == ref_router.actions
    np.testing.assert_array_equal(np.asarray(srv.weights_trace),
                                  np.asarray(ref_srv.weights_trace))
    for key in ("completed", "p50_ticks", "p95_ticks", "slo_violation_rate"):
        assert got[key] == want[key], key
    for key in ("tier_routed", "tier_completed", "mean_weights",
                "late_weights"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert got["completed"] > 0
    for t, rt in zip(tiers, ref_tiers):
        outs = {r.id: r.output for r in t.engine.completed}
        assert outs == {r.id: r.output for r in rt.engine.completed}


def test_reference_keyword_names_speed_factor_and_cross_attention():
    """The reference's keyword arguments (ROADMAP C7):
    ``ServingEngine(..., speed_factor=)``, stored as the reference stores
    it, and ``block_specs(..., cross_attention=)``, whose names equal the
    reference's."""
    import inspect

    from repro.models.blocks import block_specs as ref_block_specs
    from repro_torch.models.blocks import block_specs
    cfg = ModelConfig(**TINY)
    assert ServingEngine(cfg, speed_factor=2.0,
                         device="cpu").speed_factor == 2.0
    assert ServingEngine(cfg, device="cpu").speed_factor == \
        inspect.signature(RefServingEngine).parameters[
            "speed_factor"].default == 1.0
    seamless = get_arch("seamless-m4t-medium").smoke
    ref_seamless = ref_get_arch("seamless-m4t-medium").smoke
    kind = seamless.layer_kind(0)
    for cross in (False, True):
        assert block_specs(seamless, kind, cross_attention=cross) == \
            ref_block_specs(ref_seamless, kind, cross_attention=cross)
    assert "cross" in block_specs(seamless, kind, cross_attention=True)
