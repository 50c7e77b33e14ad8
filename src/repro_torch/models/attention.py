"""Attention layer: GQA/MQA/MHA projections with RoPE, and the KV cache
(the port of ``repro/models/attention.py``).

Serving reaches the attention itself only through
:mod:`repro_torch.kernels.attention.ops`: kernel B4 (prefill) and B5
(decode) on the card, their plain versions ``mha_ref``/``decode_ref`` on
the CPU.  Training takes :func:`blockwise_attention`, the port of the
reference's XLA online-softmax attention, which is plain and
differentiable on every device (the reference trains through it, not
through its Pallas kernels; the kernels' entry points refuse inputs that
need gradients).

KV caches, one ``{"k", "v"}`` dict of (B, L, n_kv, head_dim) tensors per
layer:
  * full-attention layers keep L = the serving capacity;
  * sliding-window / local layers keep a **ring buffer** of L =
    ``min(S, window)`` slots — softmax is permutation-invariant over KV
    entries and RoPE is applied at absolute positions before caching, so a
    rotated ring needs no unrotation.  A warm ring holds exactly the window,
    so its decode attends every slot: B5 at position L - 1 with no window.
Decode writes each new token's K/V into its slot **in place**.

Cross-attention (the encoder-decoder's decoder blocks) projects its queries
and the encoder memory's K/V with the same weights' names, without RoPE or
bias; its cache is that K/V, ``{"k", "v"}`` of (B, S_enc, n_kv, head_dim),
made once at prefill.  Its prefill is B4 unmasked (Sq != Skv), its decode
B5 at position S_enc - 1, which sees every slot.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from repro_torch.kernels.attention import ops
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


def attention_specs(cfg: ModelConfig) -> dict:
    p = {
        "wq": ("embed", "heads", "head_dim"),
        "wk": ("embed", "kv_heads", "head_dim"),
        "wv": ("embed", "kv_heads", "head_dim"),
        "wo": ("heads", "head_dim", "embed"),
    }
    if cfg.qkv_bias:
        p["bq"] = ("heads", "head_dim")
        p["bk"] = ("kv_heads", "head_dim")
        p["bv"] = ("kv_heads", "head_dim")
    return p


def cache_specs() -> dict:
    return {"k": ("act_batch", "act_kv", "kv_heads", "head_dim"),
            "v": ("act_batch", "act_kv", "kv_heads", "head_dim")}


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = layers.dtype_of(cfg)
        d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        self.wq = layers.parameter((d, hq, hd), dtype, device)
        self.wk = layers.parameter((d, hkv, hd), dtype, device)
        self.wv = layers.parameter((d, hkv, hd), dtype, device)
        self.wo = layers.parameter((hq, hd, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = layers.parameter((hq, hd), dtype, device)
            self.bk = layers.parameter((hkv, hd), dtype, device)
            self.bv = layers.parameter((hkv, hd), dtype, device)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        cfg = self.cfg
        s = 1.0 / math.sqrt(cfg.d_model)
        for w in (self.wq, self.wk, self.wv):
            layers.fill_normal(w, s, gen)
        layers.fill_normal(self.wo, 1.0 / math.sqrt(cfg.n_heads
                                                    * cfg.head_dim), gen)
        if cfg.qkv_bias:
            for b in (self.bq, self.bk, self.bv):
                b.zero_()

    def _project(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """(B, S, D) x (D, H, hd) -> (B, S, H, hd)."""
        d, h, hd = w.shape
        return (x @ w.to(x.dtype).reshape(d, h * hd)).reshape(
            x.shape[:-1] + (h, hd))

    def qkv(self, x: torch.Tensor, positions: torch.Tensor
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x (B, S, D) -> q (B, S, Hq, hd), k/v (B, S, Hkv, hd), RoPE
        applied at ``positions`` ((S,) or (B, S)) unless the model has no
        positional encoding.  A softmax scale ``cfg.attn_scale`` other than
        the kernels' 1 / sqrt(hd) is folded into q here."""
        cfg = self.cfg
        q = self._project(x, self.wq)
        k = self._project(x, self.wk)
        v = self._project(x, self.wv)
        if cfg.qkv_bias:
            q = q + self.bq.to(x.dtype)
            k = k + self.bk.to(x.dtype)
            v = v + self.bv.to(x.dtype)
        if cfg.position_embedding == "rope":
            q = layers.apply_rope(q, positions, cfg.rope_theta)
            k = layers.apply_rope(k, positions, cfg.rope_theta)
        if cfg.attn_scale:
            q = q * (cfg.attn_scale * math.sqrt(cfg.head_dim))
        return q, k, v

    def project_q(self, x: torch.Tensor) -> torch.Tensor:
        """Cross-attention queries: x (B, S, D) -> (B, S, Hq, hd)."""
        return self._project(x, self.wq)

    def project_kv(self, memory: torch.Tensor) -> dict:
        """The cross cache of the encoder output ``memory`` (B, S_enc, D):
        ``{"k", "v"}`` of (B, S_enc, Hkv, hd)."""
        return {"k": self._project(memory, self.wk),
                "v": self._project(memory, self.wv)}

    def output(self, o: torch.Tensor) -> torch.Tensor:
        """(B, S, Hq, hd) -> (B, S, D)."""
        hq, hd, d = self.wo.shape
        return o.reshape(o.shape[:-2] + (hq * hd,)) @ self.wo.to(
            o.dtype).reshape(hq * hd, d)


NEG = -1e30


def _chunk(x: torch.Tensor, axis: int, size: int) -> torch.Tensor:
    """(... N ...) -> (n_chunks, ... size ...), chunks moved to the front."""
    n = x.shape[axis] // size
    x = x.reshape(x.shape[:axis] + (n, size) + x.shape[axis + 1:])
    return x.movedim(axis, 0)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, mask_mode: str = "causal", window: int = 0,
                        q_offset: int | torch.Tensor = 0,
                        kv_valid_len: int | torch.Tensor | None = None,
                        q_chunk: int = 512, kv_chunk: int = 1024
                        ) -> torch.Tensor:
    """Online-softmax attention over KV chunks, plain and differentiable.

    q (B, Sq, Hq, D) against k/v (B, Skv, Hkv, D), Hq a multiple of Hkv
    (GQA groups).  ``mask_mode``: "causal", "window" (causal and within
    ``window``) or "full".  ``q_offset``: the absolute position of q[:, 0],
    an int or a per-batch (B,) tensor; KV positions are 0..Skv-1.
    ``kv_valid_len`` (an int or (B,)): KV indices at or past it are masked
    in every mode.  ``q_chunk``/``kv_chunk`` are clamped to the lengths and
    must then divide them.  Returns (B, Sq, Hq, D) in q's type.

    The reference multiplies its operands with a float32 result
    (``preferred_element_type``); a torch product of bf16 operands rounds
    its result to bf16, so both products here widen their operands to
    float32 first (a bf16 product is exact in float32).  The probabilities
    are rounded to v's type before the second product, as there.
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    assert hq == g * hkv, (hq, hkv)
    cq = min(q_chunk, sq)
    ck = min(kv_chunk, skv)
    assert sq % cq == 0 and skv % ck == 0, (sq, cq, skv, ck)
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    f32 = torch.float32

    # the operands widened once (exact), chunked
    q_chunks = _chunk(q.reshape(b, sq, hkv, g, d).to(f32), 1, cq)
    k_chunks = _chunk(k.to(f32), 1, ck)                    # (nk,B,ck,hkv,d)
    v_chunks = _chunk(v.to(f32), 1, ck)
    per_batch = isinstance(q_offset, torch.Tensor) and q_offset.ndim > 0
    q_off = torch.as_tensor(q_offset, dtype=torch.int64, device=dev)
    if kv_valid_len is not None:
        kv_valid = torch.as_tensor(kv_valid_len, dtype=torch.int64,
                                   device=dev)
        per_batch = per_batch or kv_valid.ndim > 0
        if per_batch:
            kv_valid = kv_valid.expand(b)
    if per_batch:
        q_off = q_off.expand(b)

    outs = []
    for qi in range(q_chunks.shape[0]):
        qc = q_chunks[qi]                                   # (B,cq,hkv,g,d)
        ar = torch.arange(cq, device=dev)
        q_pos = (q_off[:, None] + qi * cq + ar[None, :] if per_batch
                 else q_off + qi * cq + ar)                 # (B, cq) / (cq,)
        m = torch.full((b, hkv, g, cq), NEG, dtype=f32, device=dev)
        l = torch.zeros((b, hkv, g, cq), dtype=f32, device=dev)
        acc = torch.zeros((b, hkv, g, cq, d), dtype=f32, device=dev)
        for ki in range(k_chunks.shape[0]):
            kc, vc = k_chunks[ki], v_chunks[ki]
            k_pos = ki * ck + torch.arange(ck, device=dev)   # (ck,)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qc, kc) * scale
            if mask_mode != "full":
                mask = k_pos[None, :] <= q_pos[..., :, None]
                if mask_mode == "window" and window > 0:
                    mask &= k_pos[None, :] > q_pos[..., :, None] - window
                s = torch.where(mask[:, None, None] if per_batch
                                else mask[None, None, None], s, NEG)
            if kv_valid_len is not None:
                if per_batch:
                    vmask = k_pos[None, :] < kv_valid[:, None]
                    s = torch.where(vmask[:, None, None, None], s, NEG)
                else:
                    s = torch.where(k_pos < kv_valid, s, NEG)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))   # (b,h,g,q)
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + torch.sum(p, dim=-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).to(f32),
                              vc)
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-30)     # (b,h,g,q,d)
        outs.append(out.movedim(3, 1).reshape(b, cq, hq, d).to(q.dtype))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------
def cache_len(cfg: ModelConfig, layer_idx: int, seq_len: int) -> int:
    """Per-layer cache length: ring-bounded for windowed/local layers."""
    if not cfg.serve_ring_caches:
        return seq_len
    if cfg.attn_type == "swa":
        return min(seq_len, cfg.sliding_window)
    if cfg.attn_type == "local_global" and not cfg.is_global_attn_layer(
            layer_idx):
        return min(seq_len, cfg.sliding_window)
    return seq_len


def init_cache(cfg: ModelConfig, batch: int, length: int,
               dtype: torch.dtype, device=None) -> dict:
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def fill_cache(k: torch.Tensor, v: torch.Tensor, clen: int) -> dict:
    """The cache of capacity ``clen`` after a prefill of S = k.shape[1]
    positions.  With clen <= S it is a ring: slot p % clen holds position
    p, so the last clen positions land there rolled by S % clen.  Otherwise
    the positions fill slots [0, S) and the rest stay zero."""
    s = k.shape[1]
    if clen <= s:
        r = s % clen
        return {"k": torch.roll(k[:, -clen:], r, dims=1).contiguous(),
                "v": torch.roll(v[:, -clen:], r, dims=1).contiguous()}
    shape = (k.shape[0], clen) + tuple(k.shape[2:])
    cache = {"k": k.new_zeros(shape), "v": v.new_zeros(shape)}
    cache["k"][:, :s] = k
    cache["v"][:, :s] = v
    return cache


def cache_write_decode(cache: dict, k_new: torch.Tensor, v_new: torch.Tensor,
                       position: int | torch.Tensor) -> dict:
    """Write one token's K/V at ``position % cache_len`` (ring semantics),
    **in place**.  ``position`` is an int or a per-batch (B,) tensor
    (continuous batching decodes different sequences at different
    positions)."""
    length = cache["k"].shape[1]
    if isinstance(position, torch.Tensor) and position.ndim > 0:
        slot = position.to(cache["k"].device).long() % length        # (B,)
        bidx = torch.arange(cache["k"].shape[0], device=slot.device)
        cache["k"][bidx, slot] = k_new[:, 0]
        cache["v"][bidx, slot] = v_new[:, 0]
    else:
        slot = int(position) % length
        cache["k"][:, slot] = k_new[:, 0]
        cache["v"][:, slot] = v_new[:, 0]
    return cache


def decode_attend(cache: dict, q: torch.Tensor, *, full_ring: bool,
                  position: int | torch.Tensor, window: int) -> torch.Tensor:
    """Single-token attention against a (possibly ring) cache.

    A warm ring cache holds only positions inside the window, so every slot
    is attended (``full_ring=True``: B5 at position L - 1, no window).  A
    full-length cache masks slots beyond ``position`` causally (and outside
    the window, if any) by absolute position.
    """
    if full_ring:
        return ops.decode_attention(q, cache["k"], cache["v"],
                                    position=cache["k"].shape[1] - 1)
    return ops.decode_attention(q, cache["k"], cache["v"], position=position,
                                window=window)


def decode_keys(position: np.ndarray, cache_len: int, full_ring: bool,
                window: int) -> np.ndarray:
    """The keys :func:`decode_attend` has kernel B5 read for each lane at
    ``position`` (host integers) against a cache of ``cache_len`` slots:
    every slot of a warm ring, else keys ``position - window + 1`` (0
    without a window) to ``position``, of those the cache holds."""
    if full_ring:
        return np.full_like(position, cache_len)
    last = np.minimum(position + 1, cache_len)
    if window > 0:
        return last - np.clip(position - window + 1, 0, last)
    return last
