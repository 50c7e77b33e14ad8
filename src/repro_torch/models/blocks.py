"""Layer blocks of the decoder (the port of ``repro/models/blocks.py``).

A *block* is one residual layer: (norm → mixer → residual, norm → gated
MLP → residual).  Its kind comes from ``cfg.layer_kind(i)``: ``attn``
(full causal), ``swa`` (sliding window), ``lattn``/``gattn`` (gemma3's
local / global layers), each with ``mlp``; or ``mamba``, a pure-mixer
Mamba-2 layer with no MLP (mamba2's blocks), whose cache is its SSM state
and which ignores positions.

The reference scans stacked parameters over the repeating kind pattern
(``PeriodStack``); PyTorch runs eagerly, so the port keeps one block per
layer in an ``nn.ModuleList`` and walks it in a Python loop
(:class:`repro_torch.models.model.DecoderOnlyLM`).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.attention import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig

#: ROADMAP items of what later slices port: model families and block parts.
WAITING = {"moe": "A12c (MoE, models/moe.py)",
           "hybrid": "A12d (hybrid Jamba)", "encdec": "A12e (encoder-decoder)"}


def check_kind(kind: str) -> None:
    """Raise ``NotImplementedError`` for a block kind the port lacks."""
    for part in kind.split("_"):
        if part in WAITING:
            raise NotImplementedError(f"block kind {kind!r} is not ported "
                                      f"yet: ROADMAP {WAITING[part]}")
    mixer, _, rest = kind.partition("_")
    if kind != "mamba" and not (mixer in ("attn", "swa", "lattn", "gattn")
                                and rest == "mlp"):
        raise NotImplementedError(f"block kind {kind!r} is not ported yet")


def window_of(cfg: ModelConfig, kind: str) -> int:
    """The causal attention window of a block kind: ``cfg.sliding_window``
    for swa/local layers, 0 (unbounded) otherwise."""
    if kind.startswith("swa") or kind.startswith("lattn"):
        return cfg.sliding_window
    return 0


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, kind: str, device=None):
        super().__init__()
        check_kind(kind)
        self.cfg = cfg
        self.kind = kind
        dtype = layers.dtype_of(cfg)
        self.norm_mixer = layers.RMSNorm(cfg.d_model, dtype, device)
        if kind == "mamba":
            self.mamba = ssm_mod.Mamba(cfg, device)
            return
        self.attn = attn_mod.Attention(cfg, device)
        self.norm_mlp = layers.RMSNorm(cfg.d_model, dtype, device)
        self.mlp = layers.Mlp(cfg.d_model, cfg.d_ff, dtype, device)

    def init_weights(self, gen: torch.Generator) -> None:
        for m in self.children():
            m.init_weights(gen)

    def _mlp(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm_mlp(x, self.cfg.norm_eps)
        return x + self.mlp(h, self.cfg.mlp_act).to(x.dtype)

    def prefill(self, x: torch.Tensor, positions: torch.Tensor,
                layer_idx: int, seq_len: int) -> tuple[torch.Tensor, dict]:
        """One block over a full sequence x (B, S, D).  Returns (x, cache)
        with the cache at capacity ``seq_len`` (>= S; ring-bounded for
        windowed layers, see :func:`attention.fill_cache`); a Mamba layer's
        cache is its state after the S tokens."""
        cfg = self.cfg
        h = self.norm_mixer(x, cfg.norm_eps)
        if self.kind == "mamba":
            out, cache = self.mamba.prefill(h)
            return x + out.to(x.dtype), cache
        q, k, v = self.attn.qkv(h, positions)
        out = ops.attention(q, k, v, causal=True,
                            window=window_of(cfg, self.kind))
        x = x + self.attn.output(out).to(x.dtype)
        cache = attn_mod.fill_cache(
            k, v, attn_mod.cache_len(cfg, layer_idx, seq_len))
        return self._mlp(x), cache

    def decode(self, x: torch.Tensor, cache: dict,
               position: int | torch.Tensor) -> torch.Tensor:
        """One block for one new token x (B, 1, D) at ``position`` (an int
        or a (B,) tensor); writes the token's K/V (a Mamba layer: its new
        state) into ``cache`` in place."""
        cfg = self.cfg
        h = self.norm_mixer(x, cfg.norm_eps)
        if self.kind == "mamba":
            out, state = self.mamba.decode(h, cache)
            for name, t in state.items():
                cache[name].copy_(t)
            return x + out.to(x.dtype)
        if isinstance(position, torch.Tensor) and position.ndim > 0:
            pos_arr = position.to(x.device).reshape(-1, 1)
        else:
            pos_arr = torch.full((1, 1), int(position), device=x.device)
        q, k, v = self.attn.qkv(h, pos_arr)
        attn_mod.cache_write_decode(cache, k, v, position)
        window = window_of(cfg, self.kind)
        full_ring = 0 < cache["k"].shape[1] <= window
        out = attn_mod.decode_attend(cache, q, full_ring=full_ring,
                                     position=position, window=window)
        x = x + self.attn.output(out).to(x.dtype)
        return self._mlp(x)
