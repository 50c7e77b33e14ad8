"""The algebra of kernel B6's chunk-parallel design, held on the CPU against
the plain ``ssd_chunked`` and the reference's ``repro/models/ssm.py``
oracle (and the interpret-mode Pallas kernel where its shapes allow).

``ref.ssd_chunk_parallel_model`` computes the scan in the kernel's three
phases: each chunk's cumulative decay and local state, the state passed
over the chunks, then each chunk's outputs from C B^T (one plane per group)
and the chunk's starting state.

* float32, ``split_bf16=False``: within rtol 1e-4 / atol 1e-5 of both
  (the bar of ``tests/test_torch_ssd.py``; only the order of the float32
  sums differs), over ragged S, S shorter than one chunk, initial states
  and G = 1, 2.
* bfloat16, ``split_bf16=True`` (the bf16 kernel's arithmetic up to the
  order of its sums), rounded to bf16: within the reference's kernel bar
  (max abs error / max(1, |y|) below 3e-2, the state below 10x that) of
  the reference's oracle and of ``ssd_pallas``.
* What the lo halves buy: on bf16-valued float32 inputs the split model
  stays within the reference's float32 kernel bar (1e-4 scaled) of the
  float32 scan; with the hi halves alone (``keep_lo=False``) it does not.

The kernel itself runs only on the card, where ``chip_smoke.py`` holds it
against ``ssd_chunked`` and against this model.
"""
import jax
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ssd import ssd_pallas
from repro.models import ssm as ref_ssm
from repro_torch.kernels.ssd import ref
from repro_torch.models.convert import tensor_from_numpy
from torch_port_ref import t2n

RTOL, ATOL = 1e-4, 1e-5
BAR = {"float32": 1e-4, "bfloat16": 3e-2}
_ref_chunked = jax.jit(ref_ssm.ssd_chunked, static_argnames="chunk")

# (B, S, H, P, G, N, Q, init): a ragged S, S shorter than one chunk (and
# not a multiple of 16), initial states, G = 1 and 2, and chunks that fill
# several 64-row tiles of the kernel
CASES = [(2, 64, 4, 16, 1, 32, 16, False),
         (1, 100, 4, 16, 2, 16, 32, True),
         (1, 40, 2, 32, 1, 32, 64, True),
         (1, 200, 4, 32, 2, 32, 128, False),
         (1, 300, 2, 64, 1, 64, 256, True)]


def _inputs(B, S, H, P, G, N, init, seed):
    """Seeded numpy inputs (x, dt, a, b, c, init_state), dt > 0, a < 0."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(f32)
    a = -np.exp(0.3 * rng.standard_normal(H)).astype(f32)
    x, b, c = (rng.standard_normal(shape).astype(f32)
               for shape in ((B, S, H, P), (B, S, G, N), (B, S, G, N)))
    st = rng.standard_normal((B, H, P, N)).astype(f32) if init else None
    return [x, dt, a, b, c, st]


def _as(arrs, dtype):
    """x, b, c and the initial state rounded to ``dtype`` (numpy's
    bfloat16 rounds to nearest even, as torch does)."""
    out = list(arrs)
    for i in (0, 3, 4, 5):
        if out[i] is not None:
            out[i] = out[i].astype(dtype)
    return out


def _port(arrs):
    return [None if v is None else tensor_from_numpy(v) for v in arrs]


def _scaled_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want)))


def _case_id(case):
    B, S, H, P, G, N, Q, init = case
    return f"B{B}-S{S}-H{H}-P{P}-G{G}-N{N}-Q{Q}" + ("-init" if init else "")


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_f32_model_matches_plain_and_reference(case):
    B, S, H, P, G, N, Q, init = case
    arrs = _inputs(B, S, H, P, G, N, init, seed=S + Q)
    x, dt, a, b, c, st = _port(arrs)
    y, s = ref.ssd_chunk_parallel_model(x, dt, a, b, c, Q, st,
                                        split_bf16=False)
    assert y.dtype == s.dtype == torch.float32
    assert tuple(y.shape) == (B, S, H, P) and tuple(s.shape) == (B, H, P, N)
    y_p, s_p = ref.ssd_chunked(x, dt, a, b, c, Q, st)
    y_r, s_r = _ref_chunked(*arrs[:5], chunk=Q, init_state=arrs[5])
    for got, want in ((y, t2n(y_p)), (s, t2n(s_p)), (s, s_r)):
        np.testing.assert_allclose(t2n(got), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    if Q <= 64:
        np.testing.assert_allclose(t2n(y), np.asarray(y_r), rtol=RTOL,
                                   atol=ATOL)
    else:
        # From Q=128 the port's own plain ssd_chunked leaves the elementwise
        # bar against the oracle too (near-zero y among terms of ~50;
        # ROADMAP C), so the oracle is held at the reference's float32
        # kernel bar there
        assert _scaled_err(t2n(y), y_r) < BAR["float32"]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_bf16_split_model_within_reference_kernel_bar(case):
    B, S, H, P, G, N, Q, init = case
    arrs = _as(_inputs(B, S, H, P, G, N, init, seed=S + Q + 1),
               jax.numpy.bfloat16)
    x, dt, a, b, c, st = _port(arrs)
    y, s = ref.ssd_chunk_parallel_model(x, dt, a, b, c, Q, st,
                                        split_bf16=True)
    y, s = y.bfloat16(), s.bfloat16()
    y_r, s_r = _ref_chunked(*arrs[:5], chunk=Q, init_state=arrs[5])
    assert _scaled_err(t2n(y), y_r) < BAR["bfloat16"]
    assert _scaled_err(t2n(s), s_r) < 10 * BAR["bfloat16"]
    if S % min(Q, S) == 0 and not init:       # the Pallas kernel's shapes
        y_k, s_k = ssd_pallas(*(jax.numpy.asarray(v) for v in arrs[:5]),
                              chunk=Q, interpret=True)
        assert _scaled_err(t2n(y), y_k) < BAR["bfloat16"]
        assert _scaled_err(t2n(s), s_k) < 10 * BAR["bfloat16"]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_lo_halves_keep_the_f32_kernel_bar(case):
    """On float32 inputs that hold bf16 values (where the tensor cores'
    products are exact) the split model is within the reference's float32
    kernel bar of the float32 scan, y and state; dropping the lo halves
    leaves that bar, on the same inputs."""
    B, S, H, P, G, N, Q, init = case
    arrs = _as(_inputs(B, S, H, P, G, N, init, seed=S + Q + 2),
               jax.numpy.bfloat16)
    arrs = [None if v is None else v.astype(np.float32) for v in arrs]
    x, dt, a, b, c, st = _port(arrs)
    y_p, s_p = ref.ssd_chunked(x, dt, a, b, c, Q, st)
    y_r, _ = _ref_chunked(*arrs[:5], chunk=Q, init_state=arrs[5])
    errs = {}
    for keep_lo in (True, False):
        y, s = ref.ssd_chunk_parallel_model(x, dt, a, b, c, Q, st,
                                            split_bf16=True, keep_lo=keep_lo)
        errs[keep_lo] = (_scaled_err(t2n(y), t2n(y_p)),
                         _scaled_err(t2n(y), y_r),
                         _scaled_err(t2n(s), t2n(s_p)) / 10)
    assert max(errs[True]) < BAR["float32"], errs
    assert max(errs[False][:2]) > BAR["float32"], errs
