"""Plain PyTorch versions of the flash attention kernels (GQA +
causal/window), the port of ``repro/kernels/attention/ref.py``.

They are what a CPU tensor runs (:mod:`.ops`) and what the CUDA kernels
(:mod:`.flash`) are held against on the card.  Both upcast to float32, mask
with -1e30, divide by ``max(l, 1e-30)`` and cast back to ``q.dtype``.  One
change from the reference: ``q_offset`` / ``position`` may be a scalar or a
per-batch ``(B,)`` tensor (continuous batching decodes every slot at its own
position).
"""
from __future__ import annotations

import math

import torch

NEG = -1e30


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: int = 0,
            q_offset: int | torch.Tensor = 0) -> torch.Tensor:
    """Naive masked attention.

    q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D); Hq % Hkv == 0 (query head h
    reads KV head h // (Hq // Hkv)).  Positions: q[:, i] at q_offset + i
    (q_offset an int or a (B,) tensor), k[:, j] at j.
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    qg = q.reshape(b, sq, hkv, g, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(d)
    ar = torch.arange(sq, device=q.device)
    if isinstance(q_offset, torch.Tensor) and q_offset.ndim > 0:
        q_pos = q_offset.to(q.device, torch.int64)[:, None] + ar   # (B, Sq)
    else:
        q_pos = int(q_offset) + ar                                 # (Sq,)
    k_pos = torch.arange(skv, device=q.device)
    mask = torch.ones(q_pos.shape + (skv,), dtype=torch.bool,
                      device=q.device)
    if causal:
        mask &= k_pos <= q_pos[..., None]
    if window > 0:
        mask &= k_pos > q_pos[..., None] - window
    mask = mask[:, None, None] if mask.ndim == 3 else mask[None, None, None]
    s = torch.where(mask, s, NEG)
    p = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = p / torch.clamp(torch.sum(p, dim=-1, keepdim=True), min=1e-30)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(b, sq, hq, d).to(q.dtype)


def decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               position: int | torch.Tensor, window: int = 0) -> torch.Tensor:
    """Single-token decode: q (B, 1, Hq, D) against a cache (B, S, Hkv, D),
    causal to ``position`` (an int or a (B,) tensor), optional window."""
    return mha_ref(q, k, v, causal=True, window=window, q_offset=position)
