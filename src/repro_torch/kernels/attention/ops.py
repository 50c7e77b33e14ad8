"""Public attention entry points of the port (``repro/kernels/attention/ops.py``).

The device of the tensors decides: CPU tensors run the plain versions
(:mod:`.ref`), CUDA tensors launch kernel B4 (prefill) or B5 (decode) or
raise (:mod:`.flash`).  Serving reaches attention only through here;
training takes the differentiable
:func:`repro_torch.models.attention.blockwise_attention`, and both entry
points raise when an input needs gradients (:func:`..refuse_grad`).  On
the ``meta`` device (the dry run) the plain versions stand in for the
kernels (:func:`..stand_in`); no wrapper is called there.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import refuse_grad, stand_in
from repro_torch.kernels.attention import ref
from repro_torch.kernels.attention.flash import flash_decode, flash_prefill

_INSTEAD = "repro_torch.models.attention.blockwise_attention"


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              q_offset: int = 0) -> torch.Tensor:
    """Prefill attention: q (B, Sq, Hq, D) against k/v (B, Skv, Hkv, D)."""
    refuse_grad("ops.attention", _INSTEAD, q, k, v)
    if q.device.type == "meta":
        return stand_in("flash_prefill", lambda: ref.mha_ref(
            q, k, v, causal=causal, window=window, q_offset=q_offset),
            q, k, v)
    return flash_prefill(q, k, v, causal=causal, window=window,
                         q_offset=q_offset)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     position: int | torch.Tensor,
                     window: int = 0) -> torch.Tensor:
    """One-token decode attention at ``position`` (an int or (B,) tensor)."""
    refuse_grad("ops.decode_attention", _INSTEAD, q, k, v)
    if q.device.type == "meta":
        return stand_in("flash_decode", lambda: ref.decode_ref(
            q, k, v, position=position, window=window), q, k, v)
    return flash_decode(q, k, v, position=position, window=window)
