"""Plain PyTorch versions of the flash attention kernels (GQA +
causal/window), the port of ``repro/kernels/attention/ref.py``.

They are what a CPU tensor runs (:mod:`.ops`) and what the CUDA kernels
(:mod:`.flash`) are held against on the card.  Both upcast to float32, mask
with -1e30, divide by ``max(l, 1e-30)`` and cast back to ``q.dtype``.  One
change from the reference: ``q_offset`` / ``position`` may be a scalar or a
per-batch ``(B,)`` tensor (continuous batching decodes every slot at its own
position).

:func:`prefill_two_half_model` and :func:`decode_split_model` are plain
models of the two kernels' algebra (the bf16 tensor-core B4 and the
split-and-merge B5).  The tests hold them against :func:`mha_ref` on the
CPU, and ``chip_smoke.py`` holds each kernel against its model on the
card; no model or serving code calls them.
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


def _mask(q_pos: torch.Tensor, skv: int, causal: bool,
          window: int) -> torch.Tensor:
    k_pos = torch.arange(skv, device=q_pos.device)
    mask = torch.ones(q_pos.shape + (skv,), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= k_pos <= q_pos[..., None]
    if window > 0:
        mask &= k_pos > q_pos[..., None] - window
    return mask


def prefill_two_half_model(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           window: int = 0, q_offset: int = 0,
                           block_k: int = 64,
                           p_lo: bool = True) -> torch.Tensor:
    """B4's bf16 algebra in float32: an online softmax over key tiles of
    ``block_k`` in which P V takes p as two bf16 halves, p_hi = bf16(p) and
    p_lo = bf16(p - p_hi), each multiplied by V and summed in float32; the
    row sum l takes p itself.  On bf16-representable inputs every product
    of the tensor cores is exact, so this is the kernel's arithmetic up to
    the order of its sums.  ``p_lo=False`` drops the second half (P V on
    one bf16 p), the design the split replaces.  Shapes as
    :func:`mha_ref`; returns float32."""
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    dev = q.device
    qg = q.reshape(b, sq, hkv, g, d).float()
    mask = _mask(int(q_offset) + torch.arange(sq, device=dev), skv, causal,
                 window)
    m = torch.full((b, hkv, g, sq), NEG, device=dev)
    l = torch.zeros((b, hkv, g, sq), device=dev)
    acc = torch.zeros((b, hkv, g, sq, d), device=dev)
    for k0 in range(0, skv, block_k):
        sl = slice(k0, min(skv, k0 + block_k))
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k[:, sl].float()) \
            / math.sqrt(d)
        vis = mask[:, sl]
        s = torch.where(vis, s, NEG)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.where(vis, torch.exp(s - m_new[..., None]), 0.0)
        p_hi = p.bfloat16().float()
        vt = v[:, sl].float()
        acc = acc * corr[..., None] \
            + torch.einsum("bhgqk,bkhd->bhgqd", p_hi, vt)
        if p_lo:
            acc = acc + torch.einsum("bhgqk,bkhd->bhgqd",
                                     (p - p_hi).bfloat16().float(), vt)
        l = l * corr + p.sum(-1)
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d)


def decode_split_model(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       position: int | torch.Tensor, window: int = 0,
                       chunk: int) -> torch.Tensor:
    """B5's algebra in float32: the cache cut into chunks of ``chunk``
    keys, each giving a partial (m, l, acc) over its visible keys (a chunk
    with none gives m = -1e30, l = 0, acc = 0), then the partials rescaled
    to their common max and summed in chunk order, divided by max(l,
    1e-30).  Shapes as :func:`decode_ref`; returns float32."""
    b, _, hq, d = q.shape
    _, s, hkv, _ = k.shape
    g = hq // hkv
    if isinstance(position, torch.Tensor) and position.ndim > 0:
        pos = position.to(torch.int64)
    else:
        pos = torch.full((b,), int(position), dtype=torch.int64,
                         device=q.device)
    qg = q.reshape(b, hkv, g, d).float()
    sc = torch.einsum("bhgd,bkhd->bhgk", qg, k.float()) / math.sqrt(d)
    vis = _mask(pos, s, True, window)[:, None, None]          # (b, 1, 1, s)
    parts = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, min(s, c0 + chunk))
        vc = vis[..., sl]
        x = torch.where(vc, sc[..., sl], NEG)
        live = vc.any(-1)
        m = torch.where(live, x.amax(-1), NEG)
        p = torch.where(vc, torch.exp(x - m[..., None]), 0.0)
        parts.append((m, p.sum(-1),
                      torch.einsum("bhgk,bkhd->bhgd", p, v[:, sl].float())))
    m_all = torch.stack([m for m, _, _ in parts]).amax(0)
    l_all = torch.zeros_like(m_all)
    acc = torch.zeros((b, hkv, g, d), device=q.device)
    for m, l, a in parts:                      # in chunk order
        w = torch.where(l > 0, torch.exp(m - m_all), 0.0)
        l_all = l_all + w * l
        acc = acc + w[..., None] * a
    o = acc / torch.clamp(l_all, min=1e-30)[..., None]
    return o.reshape(b, 1, hq, d)
