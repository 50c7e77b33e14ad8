"""The port's attention (kernels B4/B5's plain versions and the dispatch)
against the reference: ``repro/kernels/attention/ref.py``, the XLA
``blockwise_attention`` with scalar and per-batch ``q_offset``, and the
Pallas ``flash_prefill``/``flash_decode`` in interpret mode, on the shapes
of ``tests/test_kernels.py``'s sweep (GQA, MQA, window, bf16).

Tolerance: the reference's own kernel bar, 2e-5 abs in float32 and 2e-2 in
bfloat16 (the two sides sum in different orders; bf16 outputs round once).
The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
them against these plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention.flash import flash_decode as ref_flash_decode
from repro.kernels.attention.flash import flash_prefill as ref_flash_prefill
from repro.kernels.attention.ref import decode_ref as ref_decode_ref
from repro.kernels.attention.ref import mha_ref as ref_mha_ref
from repro.models.attention import blockwise_attention
from repro_torch.kernels.attention import flash, ops, ref
from torch_port_ref import t2n

PREFILL = [  # b, sq, skv, hq, hkv, d, causal, window, dtype
    (2, 128, 128, 4, 2, 32, True, 0, "float32"),
    (2, 128, 128, 4, 1, 32, True, 48, "float32"),
    (1, 256, 256, 8, 8, 64, True, 0, "bfloat16"),
    (2, 128, 128, 4, 4, 32, False, 0, "float32"),
    (1, 64, 128, 2, 2, 16, False, 0, "float32"),
]
DECODE = [  # b, s, hq, hkv, d, pos, window, dtype
    (2, 256, 8, 2, 32, 255, 0, "float32"),
    (2, 256, 8, 2, 32, 100, 0, "float32"),
    (2, 256, 4, 1, 64, 200, 64, "bfloat16"),
    (1, 128, 16, 16, 32, 64, 0, "float32"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(seed, q_shape, kv_shape, dtype):
    """The same seeded numpy inputs for both packages (rounded once to
    bf16 when asked, so both sides see identical values)."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in (q_shape, kv_shape, kv_shape)]
    jx = [jnp.asarray(a, dtype) for a in arrs]
    pt = [torch.from_numpy(np.array(a, np.float32)).to(
        getattr(torch, dtype)) for a in jx]
    return jx, pt


def _close(port, ref_out, tol):
    np.testing.assert_allclose(t2n(port), np.asarray(ref_out, np.float32),
                               atol=tol, rtol=0)


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,causal,window,dtype", PREFILL)
def test_mha_ref_matches_reference_and_interpret_kernel(b, sq, skv, hq, hkv,
                                                        d, causal, window,
                                                        dtype):
    (q, k, v), (tq, tk, tv) = _inputs(0, (b, sq, hq, d), (b, skv, hkv, d),
                                      dtype)
    out = ref.mha_ref(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == tq.dtype and out.shape == tq.shape
    _close(out, ref_mha_ref(q, k, v, causal=causal, window=window),
           TOL[dtype])
    pallas = ref_flash_prefill(q, k, v, causal=causal, window=window,
                               block_q=64, block_k=64, interpret=True)
    _close(out, pallas, TOL[dtype])
    # the dispatch takes the plain version for CPU tensors
    _close(ops.attention(tq, tk, tv, causal=causal, window=window),
           np.asarray(t2n(out)), 0.0)


@pytest.mark.parametrize("b,s,hq,hkv,d,pos,window,dtype", DECODE)
def test_decode_ref_matches_reference_and_interpret_kernel(b, s, hq, hkv, d,
                                                           pos, window,
                                                           dtype):
    (q, k, v), (tq, tk, tv) = _inputs(1, (b, 1, hq, d), (b, s, hkv, d),
                                      dtype)
    out = ref.decode_ref(tq, tk, tv, position=pos, window=window)
    _close(out, ref_decode_ref(q, k, v, position=pos, window=window),
           TOL[dtype])
    pallas = ref_flash_decode(q, k, v, position=pos, window=window,
                              block_k=64, interpret=True)
    _close(out, pallas, TOL[dtype])
    # a (B,) position vector equal to pos everywhere is the scalar case
    per_batch = ref.decode_ref(tq, tk, tv, position=torch.full((b,), pos),
                               window=window)
    _close(per_batch, np.asarray(t2n(out)), 0.0)
    _close(ops.decode_attention(tq, tk, tv, position=pos, window=window),
           np.asarray(t2n(out)), 0.0)


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, 0, 0), (True, 24, 0), (True, 0, 40), (False, 0, 0)])
def test_mha_ref_matches_blockwise_attention(causal, window, q_offset):
    """float32, where blockwise_attention (which rounds p to v's type) and
    mha_ref compute the same function; a q_offset > 0 is a chunked
    prefill against a longer KV."""
    b, sq, hq, hkv, d = 2, 32, 4, 2, 16
    skv = sq + q_offset
    (q, k, v), (tq, tk, tv) = _inputs(2, (b, sq, hq, d), (b, skv, hkv, d),
                                      "float32")
    mode = "full" if not causal else ("window" if window else "causal")
    want = blockwise_attention(q, k, v, mask_mode=mode, window=window,
                               q_offset=q_offset, q_chunk=16, kv_chunk=8)
    _close(ref.mha_ref(tq, tk, tv, causal=causal, window=window,
                       q_offset=q_offset), want, TOL["float32"])


@pytest.mark.parametrize("window", [0, 20])
def test_decode_ref_per_batch_positions_match_blockwise(window):
    """Continuous batching: each sequence at its own position, including 0
    and S - 1, against blockwise_attention's (B,) q_offset."""
    b, s, hq, hkv, d = 4, 64, 4, 2, 16
    (q, k, v), (tq, tk, tv) = _inputs(3, (b, 1, hq, d), (b, s, hkv, d),
                                      "float32")
    pos = np.array([0, 63, 17, 40], np.int32)
    want = blockwise_attention(q, k, v,
                               mask_mode="window" if window else "causal",
                               window=window, q_offset=jnp.asarray(pos),
                               q_chunk=1, kv_chunk=16)
    got = ref.decode_ref(tq, tk, tv, position=torch.from_numpy(pos),
                         window=window)
    _close(got, want, TOL["float32"])
    for i, p in enumerate(pos):      # each row is its own scalar decode
        row = ref.decode_ref(tq[i:i + 1], tk[i:i + 1], tv[i:i + 1],
                             position=int(p), window=window)
        _close(got[i:i + 1], np.asarray(t2n(row)), 0.0)


def test_wrappers_take_plain_path_on_cpu_and_count_no_launch():
    (_, _, _), (tq, tk, tv) = _inputs(4, (1, 16, 4, 16), (1, 16, 2, 16),
                                      "float32")
    before = (flash.flash_prefill.launches, flash.flash_decode.launches)
    _close(flash.flash_prefill(tq, tk, tv), np.asarray(t2n(
        ref.mha_ref(tq, tk, tv))), 0.0)
    _close(flash.flash_decode(tq[:, :1], tk, tv, position=5), np.asarray(t2n(
        ref.decode_ref(tq[:, :1], tk, tv, position=5))), 0.0)
    assert (flash.flash_prefill.launches,
            flash.flash_decode.launches) == before


def test_wrappers_refuse_other_devices_and_bad_operands():
    meta = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash.flash_prefill(meta, meta, meta)
    with pytest.raises(ValueError, match="no kernel"):
        flash.flash_decode(meta[:, :1], meta, meta, position=0)
    q = torch.zeros((1, 4, 4, 16))
    kv = torch.zeros((1, 4, 3, 16))
    with pytest.raises(ValueError, match="multiple"):
        flash._check_qkv(q, kv, kv)
    kv = torch.zeros((1, 4, 2, 16))
    with pytest.raises(TypeError):
        flash._check_qkv(q, kv.double(), kv.double())
    with pytest.raises(ValueError, match="head dim"):
        flash._check_qkv(q[..., :12], kv[..., :12], kv[..., :12])
    with pytest.raises(ValueError, match="contiguous"):
        flash._check_qkv(q.transpose(1, 2), kv, kv)
    shifted = torch.zeros(q.numel() + 1)[1:].view(q.shape)
    with pytest.raises(ValueError, match="aligned"):
        flash._check_qkv(shifted, kv, kv)
