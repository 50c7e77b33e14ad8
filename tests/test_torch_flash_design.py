"""The algebra of the two flash kernels' designs, held on the CPU against
the plain versions (``mha_ref``/``decode_ref``) and the reference's
``repro/kernels/attention/ref.py``.

* B5 splits the cache into chunks, one block each, and merges their
  partials (m, l, acc) in chunk order: ``ref.decode_split_model`` within
  1e-6 of both in float32 (only the order of the sums differs), over
  chunks the positions leave wholly hidden, position 0 and S-1, windows
  that start inside a chunk, G = 1, 2, 4 and the wrapper's own chunk plan.
* B4 in bf16 takes the probabilities into P V as two bf16 halves:
  ``ref.prefill_two_half_model`` within 2e-5 (the reference's float32
  kernel bar) of both, in float32 arithmetic on bf16-representable inputs
  (where the tensor cores' products are exact), at the serving model's
  head shape and at ragged, windowed and chunked shapes; with one bf16 p
  (``p_lo=False``) the model misses that bar.

The kernels themselves run only on the card, where ``chip_smoke.py``
holds them against the plain versions and against these models.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.ref import decode_ref as ref_decode_ref
from repro.kernels.attention.ref import mha_ref as ref_mha_ref
from repro_torch.kernels.attention import flash, ref
from torch_port_ref import t2n

SPLIT_TOL = 1e-6
TWO_HALF_TOL = 2e-5


def _inputs(seed, q_shape, kv_shape, bf16_values=False):
    """Seeded numpy inputs as (jax, torch) float32 arrays, rounded to
    bf16-representable values when asked."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in (q_shape, kv_shape, kv_shape)]
    pt = [torch.from_numpy(a) for a in arrs]
    if bf16_values:
        pt = [t.bfloat16().float() for t in pt]
    return [jnp.asarray(t2n(t)) for t in pt], pt


def _close(got, want, tol):
    np.testing.assert_allclose(t2n(got), np.asarray(want, np.float32),
                               atol=tol, rtol=0)


def _dead_chunks(pos, s, chunk, window):
    """(sequence, chunk) pairs with no key visible at ``pos``."""
    dead = 0
    for p in pos:
        lo = max(0, p - window + 1) if window > 0 else 0
        dead += sum(1 for c0 in range(0, s, chunk)
                    if c0 > p or min(s, c0 + chunk) <= lo)
    return dead


@pytest.mark.parametrize("b,s,hq,hkv,d,pos,window,chunk", [
    (2, 96, 4, 4, 32, [0, 95], 0, 16),                 # G=1, pos 0 and S-1
    (3, 200, 4, 2, 64, [0, 199, 70], 0, 32),           # G=2
    (2, 128, 8, 2, 16, [127, 40], 0, 48),              # G=4, ragged last chunk
    (3, 160, 4, 2, 32, [159, 100, 20], 50, 32),        # window from mid-chunk
    (2, 200, 16, 4, 32, [199, 7], 64, 16),             # G=4, window, pos 7
    (2, 2048, 16, 8, 128, [1031, 2047], 0, None),      # the wrapper's plan
])
def test_decode_split_model_matches_decode_ref(b, s, hq, hkv, d, pos, window,
                                               chunk):
    chunk = chunk or flash.decode_chunk(b, s, hkv)
    (q, k, v), (tq, tk, tv) = _inputs(sum(pos) + d, (b, 1, hq, d),
                                      (b, s, hkv, d))
    tpos = torch.tensor(pos)
    got = ref.decode_split_model(tq, tk, tv, position=tpos, window=window,
                                 chunk=chunk)
    assert got.shape == tq.shape and got.dtype == torch.float32
    assert _dead_chunks(pos, s, chunk, window) > 0
    _close(got, t2n(ref.decode_ref(tq, tk, tv, position=tpos,
                                   window=window)), SPLIT_TOL)
    for i, p in enumerate(pos):      # the reference takes one position
        want = ref_decode_ref(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                              position=p, window=window)
        _close(got[i:i + 1], want, SPLIT_TOL)


@pytest.mark.parametrize("b,s,hkv,positions", [
    (8, 2048, 8, range(1031, 1055)),     # the serve phase's decode waves
    (2, 512, 8, range(128, 144)),        # the multitier tiers' waves
    (3, 512, 8, range(128, 144)),
    (8, 512, 8, range(128, 144)),
])
def test_decode_chunk_plan_fills_the_card(b, s, hkv, positions):
    """B5's chunk is a multiple of 16 that depends on the shapes only, and
    at the serving shapes every wave's live blocks cover the H100's SMs."""
    chunk = flash.decode_chunk(b, s, hkv)
    assert chunk % 16 == 0 and 16 <= chunk <= max(16, s)
    n_split = -(-s // chunk)
    assert n_split * chunk >= s > (n_split - 1) * chunk
    live = min(b * hkv * -(-(p + 1) // chunk) for p in positions)
    assert live >= flash.H100_SMS


PREFILL_CASES = [
    (1, 64, 64, 16, 8, 128, True, 0, 0, 64),       # internlm2's heads
    (1, 40, 100, 16, 8, 128, True, 0, 60, 64),     # chunked, ragged Skv
    (1, 96, 96, 4, 1, 256, True, 24, 0, 32),       # gemma3's heads, window
    (2, 48, 80, 4, 2, 32, False, 0, 0, 64),        # not causal
    (1, 70, 70, 4, 2, 16, True, 20, 0, 64),        # D=16, window
]


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,window,q_offset,block_k",
                         PREFILL_CASES)
def test_prefill_two_half_model_matches_mha_ref(b, sq, skv, hq, hkv, d,
                                                causal, window, q_offset,
                                                block_k):
    (q, k, v), (tq, tk, tv) = _inputs(d + sq, (b, sq, hq, d),
                                      (b, skv, hkv, d), bf16_values=True)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = ref.prefill_two_half_model(tq, tk, tv, block_k=block_k, **kw)
    assert got.shape == tq.shape and got.dtype == torch.float32
    _close(got, t2n(ref.mha_ref(tq, tk, tv, **kw)), TWO_HALF_TOL)
    _close(got, ref_mha_ref(q, k, v, **kw), TWO_HALF_TOL)


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,window,q_offset,block_k",
                         PREFILL_CASES)
def test_prefill_one_bf16_p_misses_the_bar(b, sq, skv, hq, hkv, d, causal,
                                           window, q_offset, block_k):
    """What p_lo buys: with P V on one bf16 p (``p_lo=False``) the model
    leaves the 2e-5 bar that the two halves meet, on the same inputs."""
    _, (tq, tk, tv) = _inputs(d + sq, (b, sq, hq, d), (b, skv, hkv, d),
                              bf16_values=True)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = ref.mha_ref(tq, tk, tv, **kw)
    errs = [(ref.prefill_two_half_model(tq, tk, tv, block_k=block_k,
                                        p_lo=p_lo, **kw) - want).abs().max()
            for p_lo in (True, False)]
    assert errs[0] <= TWO_HALF_TOL < errs[1]
