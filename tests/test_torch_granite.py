"""Granite-4.0-H on the port (the one architecture the JAX reference lacks),
on the CPU, against the benchmark's plain float32 reference
(``perfbench/reference/granite.py``):

* the layer kinds, the period and the parameter count of the published
  configuration (32.2 B);
* ``ServingEngine`` on the float32 smoke model, over prompts right-padded
  to their buckets in two slots that are reused, gives every served
  token's logits as the reference's full forward pass over the prompt and
  the tokens served before it gives them;
* the reference's chunked SSD (the Mamba-2 paper's listing) equals the
  plain one-token recurrence;
* a Mamba layer's prefill over a padded bucket, given the real length,
  hands decode the state of the real prompt (ROADMAP R5);
* the MoE's combine (a float32 sum cast once) is the sum in the pairs'
  own type to the bit at k = 2;
* the Mamba layers' counters and spans.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_arch
from repro_torch.models import ssm
from repro_torch.serving import Request, ServingEngine

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import hybrid_weights  # noqa: E402
from perfbench.reference import granite as reference  # noqa: E402

ARCH = "granite-4.0-h-small"
# The port and the reference both compute in float32, by different
# algorithms (B6's plain chunked scan against the paper's listing, the
# grouped products against a loop over experts, softmax-top-k-renormalise
# against a softmax over the chosen logits, the bucket's pads against none),
# so their logits differ by float32 rounding, ~1e-6 of logits of unit
# scale; 2e-4 leaves room for the sums' orders and is far below a fault
# (a pad in the Mamba state moves them by ~1e-1).
LOGIT_ATOL = 2e-4


def _smoke():
    """The smoke model computing in float32."""
    return dataclasses.replace(get_arch(ARCH).smoke, param_dtype="float32",
                               compute_dtype="float32")


def test_full_config_kinds_period_and_parameters():
    cfg = get_arch(ARCH).full
    kinds = [cfg.layer_kind(i) for i in range(cfg.n_layers)]
    assert [i for i, k in enumerate(kinds) if k == "attn_moe"] == [5, 15,
                                                                   25, 35]
    assert set(kinds) == {"mamba_moe", "attn_moe"}
    assert cfg.period() == 10
    assert round(cfg.param_count() / 1e9, 1) == 32.2
    assert (cfg.d_inner, cfg.ssm_heads) == (8192, 128)
    smoke = _smoke()
    assert [smoke.layer_kind(i) for i in range(smoke.n_layers)] == (
        ["mamba_moe", "attn_moe", "mamba_moe", "mamba_moe"] * 2)


def _weights(cfg, seed=0):
    m = dataclasses.asdict(cfg)
    return m, hybrid_weights.make(m, seed, "cpu", dtype=torch.float32)


def _serve_recording(engine, prompts, n_new):
    """Serve ``prompts`` through ``engine`` and return, per request, its
    served tokens and the logits each came from."""
    logits = {i: [] for i in range(len(prompts))}
    model = engine.model
    real_prefill, real_decode = model.prefill, model.decode_step
    admitting = []

    def prefill(tokens, max_len=None, last_index=None):
        lg, caches = real_prefill(tokens, max_len=max_len,
                                  last_index=last_index)
        logits[admitting[-1]].append(lg[0, -1].clone())
        return lg, caches

    def decode(tokens, caches, position):
        lanes = [r.id if r is not None else None for r in engine.active]
        lg, caches = real_decode(tokens, caches, position)
        for lane, rid in enumerate(lanes):
            if rid is not None:
                logits[rid].append(lg[lane, 0].clone())
        return lg, caches

    real_admit = engine._admit

    def admit(slot, req):
        admitting.append(req.id)
        return real_admit(slot, req)
    model.prefill, model.decode_step, engine._admit = prefill, decode, admit
    reqs = [Request(id=i, tokens=p, max_new_tokens=n_new)
            for i, p in enumerate(prompts)]
    for r in reqs:
        engine.submit(r)
    for _ in range(60):
        engine.step()
        if all(r.finished_at for r in reqs):
            break
    assert all(r.finished_at for r in reqs)
    return [(r.output, torch.stack(logits[r.id])) for r in reqs]


def test_engine_matches_the_plain_reference_on_padded_prompts():
    """Two slots, four requests of lengths 11, 16, 20 and 5 (three
    right-padded to their buckets, slots reused with both cache kinds
    spliced into them, a wave with an idle lane): every served token's
    logits equal the reference's at its position."""
    cfg = _smoke()
    m, w = _weights(cfg)
    engine = ServingEngine(cfg, w, max_batch=2, max_len=64, device="cpu")
    rng = np.random.default_rng(11)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in (11, 16, 20, 5)]
    got = _serve_recording(engine, prompts, 6)
    seqs = [(np.asarray(p + out[:-1]), len(p) - 1, len(p) - 1 + len(out))
            for p, (out, _) in zip(prompts, got)]
    want = reference.logits(m, w, seqs, "cpu")
    for (out, lg), ref in zip(got, want):
        assert lg.shape == ref.shape == (6, cfg.vocab_size)
        assert ref.std() > 0.1
        torch.testing.assert_close(lg, ref, rtol=0, atol=LOGIT_ATOL)
        assert out == lg.argmax(-1).tolist()


def _recurrence(x, a, b, c):
    """y_t = C_t . h_t, h_t = exp(a_t) h_{t-1} + x_t (x) B_t, one token at a
    time from a zero state."""
    h = torch.zeros(x.shape[1], x.shape[2], b.shape[2], dtype=torch.float64)
    ys = []
    for t in range(x.shape[0]):
        h = h * torch.exp(a[t])[:, None, None] + x[t][..., None] * b[t][:,
                                                                       None]
        ys.append(torch.einsum("hpn,hn->hp", h, c[t]))
    return torch.stack(ys), h


@pytest.mark.parametrize("length", [16, 37])
def test_reference_ssd_is_the_recurrence(length):
    g = torch.Generator().manual_seed(length)
    heads, p, n = 3, 4, 5
    x = torch.randn(length, heads, p, generator=g, dtype=torch.float64)
    a = -torch.rand(length, heads, generator=g, dtype=torch.float64)
    b = torch.randn(length, heads, n, generator=g, dtype=torch.float64)
    c = torch.randn(length, heads, n, generator=g, dtype=torch.float64)
    y, st = reference.ssd(x, a, b, c, 8)
    y_rec, st_rec = _recurrence(x, a, b, c)
    torch.testing.assert_close(y, y_rec, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(st, st_rec, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("length, bucket", [(11, 16), (17, 32), (3, 16)])
def test_mamba_prefill_hands_decode_the_real_prompts_state(length, bucket):
    cfg = _smoke()
    mb = ssm.Mamba(cfg, "cpu")
    mb.init_weights(torch.Generator().manual_seed(2))
    x = torch.randn(1, bucket, cfg.d_model, generator=torch.Generator()
                    .manual_seed(3))
    with torch.no_grad():
        out_pad, padded = mb.prefill(x, length)
        out_real, real = mb.prefill(x[:, :length])
        _, seen = mb.prefill(x)
    # the projections' products over S and over the bucket round alike
    # only up to their blocking: 1e-6 is float32 rounding, the pads' part
    # of a state that has seen them is ~1e-2
    torch.testing.assert_close(out_pad[:, :length], out_real, rtol=1e-5,
                               atol=1e-6)
    for k in real:
        torch.testing.assert_close(padded[k], real[k], rtol=1e-5, atol=1e-6)
        assert (seen[k] - real[k]).abs().max() > 1e-3, k
    assert mb.scan_tokens == 2 * bucket + length


def test_combine_sum_is_the_pairs_own_sum_at_k2():
    g = torch.Generator().manual_seed(0)
    pairs = (torch.randn(4096, 2, 64, generator=g)
             * torch.exp(4 * torch.randn(4096, 2, 1, generator=g))
             ).bfloat16()
    old = torch.zeros(4096, 64, dtype=torch.bfloat16)
    for j in range(2):
        old = old + pairs[:, j]
    new = pairs.sum(dim=1, dtype=torch.float32).bfloat16()
    assert torch.equal(old, new)


def test_mamba_counters_and_spans():
    """One step admitting a 5-token prompt (bucket 16) into 3 lanes: each
    Mamba layer scans 16 bucket tokens and advances 3 lanes a wave; the
    prefill's mixer and scan and the decode's mixer are spans under the
    engine's."""
    cfg = _smoke()
    _, w = _weights(cfg)
    engine = ServingEngine(cfg, w, max_batch=3, max_len=32, device="cpu")
    mambas = [m for m in engine.model.modules() if isinstance(m, ssm.Mamba)]
    engine.submit(Request(id=0, tokens=[3, 1, 4, 1, 5], max_new_tokens=3))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.step()
    engine.step()
    assert [(m.scan_tokens, m.state_steps) for m in mambas] == (
        [(16, 6)] * len(mambas))
    spans = {}
    for fe in prof.events():
        if fe.name.startswith("ssm."):
            parent = fe.cpu_parent
            while parent is not None and not parent.name.startswith(
                    ("engine.", "ssm.")):
                parent = parent.cpu_parent
            key = (fe.name, parent.name if parent is not None else None)
            spans[key] = spans.get(key, 0) + 1
    assert spans == {("ssm.prefill", "engine.prefill"): len(mambas),
                     ("ssm.scan", "ssm.prefill"): len(mambas),
                     ("ssm.decode", "engine.decode"): len(mambas)}
