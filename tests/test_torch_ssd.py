"""The port's Mamba-2 SSD scan and conv pieces against the reference's, on
the CPU, with the same inputs drawn from numpy:

* the plain ``ssd_chunked`` (what kernel B6 is held against on the card)
  against the reference's XLA oracle, over the reference kernel sweep's
  shapes (``tests/test_kernels.py``) plus a ragged S, a sequence shorter
  than one chunk and an ``init_state``: rtol 1e-4 / atol 1e-5 in float32
  (both sum in float32, in different orders), and in bfloat16 the
  reference's kernel bar (both round xbar to bfloat16; y and the state
  round once at the end, so one rounding step may differ);
* the same against the interpret-mode Pallas kernel ``ssd_pallas`` at the
  reference's kernel bar (max abs error / max(1, |y|) below 1e-4 in
  float32, 3e-2 in bfloat16; the state below 10x that);
* the same against the port's token-by-token ``ssd_decode_step``, within
  atol 2e-4 (the reference's kernel-vs-recurrence bar);
* ``ssd_decode_step``, ``causal_conv`` and ``conv_decode_step`` against
  the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ssd import ssd_pallas
from repro.models import ssm as ref_ssm
from repro_torch.kernels.ssd import ops, ref
from repro_torch.kernels.ssd.ssd import ssd_scan
from repro_torch.models import ssm
from repro_torch.models.convert import tensor_from_numpy
from torch_port_ref import t2n

RTOL, ATOL = 1e-4, 1e-5
BAR = {"float32": 1e-4, "bfloat16": 3e-2}
_ref_chunked = jax.jit(ref_ssm.ssd_chunked, static_argnames="chunk")


def _inputs(B, S, H, P, G, N, dtype, init=False, seed=0):
    """Seeded numpy inputs: (x, dt, a, b, c, init_state) with dt > 0 (a
    softplus) and a < 0; x, b, c and init_state rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(f32)
    a = -np.exp(0.3 * rng.standard_normal(H)).astype(f32)
    arrs = [rng.standard_normal(shape).astype(f32)
            for shape in ((B, S, H, P), (B, S, G, N), (B, S, G, N))]
    st = rng.standard_normal((B, H, P, N)).astype(f32) if init else None
    if dtype == "bfloat16":       # numpy's bfloat16 (ml_dtypes) rounds
        arrs = [x.astype(jnp.bfloat16) for x in arrs]
        st = None if st is None else st.astype(jnp.bfloat16)
    x, b, c = arrs
    return x, dt, a, b, c, st


def _port(arrs):
    return [None if v is None else tensor_from_numpy(v) for v in arrs]


def _jax(arrs):
    return [None if v is None else jnp.asarray(v) for v in arrs]


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want)))


# (B, S, H, P, G, N, Q, dtype, init): the reference sweep, then a ragged S,
# a sequence shorter than one chunk and initial states
SWEEP = [(2, 64, 4, 16, 1, 32, 16, "float32", False),
         (1, 128, 4, 32, 2, 16, 32, "float32", False),
         (2, 64, 2, 16, 1, 16, 64, "float32", False),
         (1, 128, 8, 32, 1, 64, 32, "bfloat16", False)]
EXTRA = [(2, 100, 4, 16, 2, 16, 32, "float32", True),
         (1, 40, 2, 32, 1, 32, 64, "float32", True),
         (1, 100, 4, 16, 1, 16, 32, "bfloat16", True)]


@pytest.mark.parametrize("B,S,H,P,G,N,Q,dtype,init", SWEEP + EXTRA)
def test_plain_ssd_matches_reference_oracle(B, S, H, P, G, N, Q, dtype, init):
    arrs = _inputs(B, S, H, P, G, N, dtype, init)
    x, dt, a, b, c, st = _jax(arrs)
    y_ref, s_ref = _ref_chunked(x, dt, a, b, c, chunk=Q, init_state=st)
    y, s = ops.ssd(*_port(arrs[:5]), Q, _port(arrs[5:])[0])
    assert y.dtype == s.dtype == (torch.float32 if dtype == "float32"
                                  else torch.bfloat16)
    if dtype == "float32":
        np.testing.assert_allclose(t2n(y), np.asarray(y_ref), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(t2n(s), np.asarray(s_ref), rtol=RTOL,
                                   atol=ATOL)
    else:
        assert _scaled_err(t2n(y), y_ref) < BAR[dtype]
        assert _scaled_err(t2n(s), s_ref) < 10 * BAR[dtype]


@pytest.mark.parametrize("B,S,H,P,G,N,Q,dtype,init", SWEEP)
def test_plain_ssd_matches_interpret_pallas_kernel(B, S, H, P, G, N, Q,
                                                   dtype, init):
    arrs = _inputs(B, S, H, P, G, N, dtype, seed=1)
    y_k, s_k = ssd_pallas(*_jax(arrs[:5]), chunk=Q, interpret=True)
    y, s = ref.ssd_chunked(*_port(arrs[:5]), Q)
    assert _scaled_err(t2n(y), y_k) < BAR[dtype]
    assert np.max(np.abs(t2n(s) - np.asarray(s_k, np.float32))) \
        < 10 * BAR[dtype]


@pytest.mark.parametrize("G,init", [(1, False), (2, True)])
def test_plain_ssd_matches_token_recurrence(G, init):
    """The chunked scan against its own one-token recurrence (guards
    against a fault shared with the reference's oracle)."""
    B, S, H, P, N, Q = 1, 40, 2, 8, 8, 16          # ragged: 40 = 2.5 chunks
    x, dt, a, b, c, st = _port(_inputs(B, S, H, P, G, N, "float32", init,
                                       seed=2))
    y, s_final = ref.ssd_chunked(x, dt, a, b, c, Q, st)
    state = torch.zeros((B, H, P, N)) if st is None else st
    ys = []
    for t in range(S):
        yt, state = ref.ssd_decode_step(state, x[:, t], dt[:, t], a,
                                        b[:, t], c[:, t])
        ys.append(yt)
    np.testing.assert_allclose(t2n(y), t2n(torch.stack(ys, 1)), atol=2e-4)
    np.testing.assert_allclose(t2n(s_final), t2n(state), atol=2e-4)


def test_decode_step_matches_reference():
    rng = np.random.default_rng(3)
    B, H, P, G, N = 2, 4, 8, 2, 16
    f32 = np.float32
    arrs = [rng.standard_normal((B, H, P, N)).astype(f32),
            rng.standard_normal((B, H, P)).astype(f32),
            np.log1p(np.exp(rng.standard_normal((B, H)))).astype(f32),
            -np.exp(0.3 * rng.standard_normal(H)).astype(f32),
            rng.standard_normal((B, G, N)).astype(f32),
            rng.standard_normal((B, G, N)).astype(f32)]
    y_ref, s_ref = jax.jit(ref_ssm.ssd_decode_step)(*_jax(arrs))
    y, s = ref.ssd_decode_step(*_port(arrs))
    np.testing.assert_allclose(t2n(y), np.asarray(y_ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(t2n(s), np.asarray(s_ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("dtype,init", [("float32", False),
                                        ("float32", True),
                                        ("bfloat16", True)])
def test_causal_conv_and_decode_step_match_reference(dtype, init):
    """The conv over a sequence, then one decode step from its state.  In
    bfloat16 the port rounds every product and sum of the loop as written,
    while XLA may keep float32 across the fused loop, so the bar there is
    1e-2 (two or three bfloat16 steps); the conv states are slices of the
    inputs and must be equal."""
    rng = np.random.default_rng(4)
    B, S, C, W = 2, 9, 12, 4
    f32 = np.float32
    arrs = [rng.standard_normal((B, S, C)).astype(f32),
            (0.1 * rng.standard_normal((W, C))).astype(f32),
            (0.1 * rng.standard_normal(C)).astype(f32),
            rng.standard_normal((B, W - 1, C)).astype(f32) if init else None,
            rng.standard_normal((B, 1, C)).astype(f32)]
    if dtype == "bfloat16":
        arrs = [None if v is None else v.astype(jnp.bfloat16) for v in arrs]
    x, w, bias, st, xt = _jax(arrs)
    y_ref, s_ref = jax.jit(ref_ssm.causal_conv)(x, w, bias, st)
    yt_ref, s2_ref = jax.jit(ref_ssm.conv_decode_step)(xt, w, bias, s_ref)
    px, pw, pb, pst, pxt = _port(arrs)
    y, s = ssm.causal_conv(px, pw, pb, pst)
    yt, s2 = ssm.conv_decode_step(pxt, pw, pb, s)
    tol = (dict(rtol=RTOL, atol=ATOL) if dtype == "float32" else
           dict(rtol=1e-2, atol=1e-2))
    np.testing.assert_allclose(t2n(y), np.asarray(y_ref, f32), **tol)
    np.testing.assert_array_equal(t2n(s), np.asarray(s_ref, f32))
    np.testing.assert_allclose(t2n(yt), np.asarray(yt_ref, f32), **tol)
    np.testing.assert_array_equal(t2n(s2), np.asarray(s2_ref, f32))


def test_ssd_scan_raises_off_cpu_and_cuda():
    x, dt, a, b, c, _ = _port(_inputs(1, 8, 2, 16, 1, 16, "float32"))
    meta = [t.to("meta") for t in (x, dt, a, b, c)]
    with pytest.raises(ValueError, match="no kernel for device"):
        ssd_scan(*meta, 16)
    assert ssd_scan.launches == 0


def test_softplus_is_jax_softplus():
    """``jax.nn.softplus`` never switches to the identity, unlike
    ``torch.nn.functional.softplus`` above 20."""
    pts = np.array([-30.0, -2.0, 0.0, 1.5, 19.0, 21.0, 40.0], np.float32)
    np.testing.assert_allclose(
        t2n(ssm.softplus(torch.from_numpy(pts))),
        np.asarray(jax.nn.softplus(jnp.asarray(pts))), rtol=1e-6, atol=0)
