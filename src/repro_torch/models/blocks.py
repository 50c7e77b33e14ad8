"""Layer blocks of the models (the port of ``repro/models/blocks.py``).

A *block* is one residual layer: (norm → mixer → residual, [norm → cross-
attention → residual,] norm → FFN → residual).  Its kind comes from
``cfg.layer_kind(i)``: the mixer is ``attn`` (full causal), ``swa``
(sliding window), ``lattn``/``gattn`` (gemma3's local / global layers) or
``encattn`` (the encoder's unmasked self-attention) or ``mamba`` (a
Mamba-2 mixer, whose cache is its SSM state and which ignores positions),
and the FFN a gated MLP (``_mlp``) or a Mixture-of-Experts (``_moe``,
:mod:`.moe`).  A bare ``mamba`` is a pure-mixer layer with no FFN (mamba2's
blocks); the hybrid family (Jamba; Granite-4.0-H, whose every layer is
``mamba_moe`` or ``attn_moe``) mixes ``mamba_mlp``, ``mamba_moe`` and
``attn_moe`` layers in one stack.  Both residual branches scale their
output by ``cfg.residual_scale`` where that is not 1 (Granite's 0.22).  A
decoder block of the encoder-decoder family also cross-attends to the
encoder's output (``cross=True``): its queries against per-layer K/V of
the encoder memory, unmasked and without RoPE.

The reference scans stacked parameters over the repeating kind pattern
(``PeriodStack``); PyTorch runs eagerly, so the port keeps one block per
layer in an ``nn.ModuleList`` and walks it in a Python loop
(:mod:`repro_torch.models.model`).

:meth:`Block.prefill` and :meth:`Block.decode` serve, through the kernels
of :mod:`repro_torch.kernels`; :meth:`Block.forward` trains, through the
plain differentiable functions the reference trains through
(``blockwise_attention``, ``ssd_chunked``, ``Moe.apply``).  Both
constrain their input with :func:`repro_torch.sharding.constrain_act`
(the identity unless a sharding context is installed), at every block
where the reference constrains once a period.  :func:`block_specs` gives
a block's parameters' logical axis names.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.attention import ops
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import constrain_act
from repro_torch.tracing import span

MIXERS = ("attn", "swa", "lattn", "gattn", "encattn", "mamba")


def check_kind(kind: str) -> None:
    """Raise ``NotImplementedError`` for a block kind no config produces:
    a mixer of :data:`MIXERS` with an FFN (``_mlp`` or ``_moe``), or a bare
    ``mamba``."""
    mixer, _, ffn = kind.partition("_")
    if kind != "mamba" and not (mixer in MIXERS and ffn in ("mlp", "moe")):
        raise NotImplementedError(f"block kind {kind!r} is not ported")


def block_specs(cfg: ModelConfig, kind: str,
                cross_attention: bool = False) -> dict:
    """The logical axis names of one block's parameters (the reference's
    ``block_specs``; a stacked leaf adds a leading "layers")."""
    p: dict = {"norm_mixer": layers.rmsnorm_specs(),
               "norm_mlp": layers.rmsnorm_specs()}
    if "mamba" in kind:
        p["mamba"] = ssm_mod.mamba_specs(cfg)
    else:
        p["attn"] = attn_mod.attention_specs(cfg)
    if "moe" in kind:
        p["moe"] = moe_mod.moe_specs(cfg)
    elif "mlp" in kind:
        p["mlp"] = layers.mlp_specs()
    else:
        del p["norm_mlp"]
    if cross_attention:
        p["norm_cross"] = layers.rmsnorm_specs()
        p["cross"] = attn_mod.attention_specs(cfg)
    return p


def mask_args(cfg: ModelConfig, kind: str) -> tuple[str, int]:
    """The attention mask of a block kind (the reference's ``_mask_args``):
    ("window", cfg.sliding_window) for swa/local layers, ("full", 0) for
    the encoder's, ("causal", 0) otherwise."""
    if kind.startswith("swa") or kind.startswith("lattn"):
        return "window", cfg.sliding_window
    if kind.startswith("enc"):
        return "full", 0
    return "causal", 0


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, kind: str, device=None,
                 cross: bool = False):
        super().__init__()
        check_kind(kind)
        self.cfg = cfg
        self.kind = kind
        dtype = layers.dtype_of(cfg)
        self.is_mamba = kind.startswith("mamba")
        self.norm_mixer = layers.RMSNorm(cfg.d_model, dtype, device)
        if self.is_mamba:
            self.mamba = ssm_mod.Mamba(cfg, device)
        else:
            self.attn = attn_mod.Attention(cfg, device)
        if kind.endswith("_moe"):
            self.norm_mlp = layers.RMSNorm(cfg.d_model, dtype, device)
            self.moe = moe_mod.Moe(cfg, device)
        elif kind.endswith("_mlp"):
            self.norm_mlp = layers.RMSNorm(cfg.d_model, dtype, device)
            self.mlp = layers.Mlp(cfg.d_model, cfg.d_ff, dtype, device)
        if cross:
            self.norm_cross = layers.RMSNorm(cfg.d_model, dtype, device)
            self.cross = attn_mod.Attention(cfg, device)

    def init_weights(self, gen: torch.Generator) -> None:
        for m in self.children():
            m.init_weights(gen)

    def _residual(self, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """x plus a branch's output, scaled by ``cfg.residual_scale`` where
        that is not 1, in x's type."""
        if self.cfg.residual_scale != 1.0:
            out = out * self.cfg.residual_scale
        return x + out.to(x.dtype)

    def _ffn(self, x: torch.Tensor) -> torch.Tensor:
        """The FFN's residual step (the MoE or the MLP; none for a bare
        ``mamba``)."""
        if not hasattr(self, "norm_mlp"):
            return x
        h = self.norm_mlp(x, self.cfg.norm_eps)
        out = self.moe(h) if hasattr(self, "moe") else \
            self.mlp(h, self.cfg.mlp_act)
        return self._residual(x, out)

    def _cross(self, x: torch.Tensor, memory_kv: dict,
               decode: bool) -> torch.Tensor:
        """The cross-attention's residual step: B4 unmasked over the whole
        prefix, or B5 for one token at the last slot's position (every
        slot visible)."""
        h = self.norm_cross(x, self.cfg.norm_eps)
        q, k, v = self.cross.project_q(h), memory_kv["k"], memory_kv["v"]
        out = (ops.decode_attention(q, k, v, position=k.shape[1] - 1)
               if decode else ops.attention(q, k, v, causal=False))
        return x + self.cross.output(out).to(x.dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                memory: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """The training block over a full sequence x (B, S, D) (the
        reference's ``apply_block`` without a cache): (x, the float32 MoE
        load-balancing loss, 0 for other kinds).  A decoder block projects
        the encoder output ``memory`` to its cross K/V here.  With
        ``cfg.remat != "none"`` the attention's chunks are recomputed in the
        backward pass instead of kept."""
        cfg = self.cfg
        x = constrain_act(x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        h = self.norm_mixer(x, cfg.norm_eps)
        mixed = self.mamba(h) if self.is_mamba else self._attend(h, positions)
        x = self._residual(x, mixed)
        if memory is not None and hasattr(self, "cross"):
            h = self.norm_cross(x, cfg.norm_eps)
            kv = self.cross.project_kv(memory)
            out = attn_mod.blockwise_attention(self.cross.project_q(h),
                                               kv["k"], kv["v"],
                                               mask_mode="full")
            x = x + self.cross.output(out).to(x.dtype)
        if not hasattr(self, "norm_mlp"):
            return x, aux
        h = self.norm_mlp(x, cfg.norm_eps)
        if hasattr(self, "moe"):
            out, aux = self.moe.apply(h)
        else:
            out = self.mlp(h, cfg.mlp_act)
        return self._residual(x, out), aux

    def _attend(self, h: torch.Tensor, positions: torch.Tensor
                ) -> torch.Tensor:
        """The training attention's output over the normed h (B, S, D)."""
        cfg = self.cfg
        q, k, v = self.attn.qkv(h, positions)
        mode, window = mask_args(cfg, self.kind)

        def attend(q_, k_, v_):
            return attn_mod.blockwise_attention(q_, k_, v_, mask_mode=mode,
                                                window=window)
        out = (checkpoint(attend, q, k, v, use_reentrant=False)
               if cfg.remat != "none" else attend(q, k, v))
        return self.attn.output(out)

    def prefill(self, x: torch.Tensor, positions: torch.Tensor,
                layer_idx: int, seq_len: int | None,
                memory_kv: dict | None = None, length: int | None = None):
        """One block over a full sequence x (B, S, D).  Returns (x,
        cache): the cache at capacity ``seq_len`` (>= S; ring-bounded for
        windowed layers, see :func:`attention.fill_cache`; None when
        ``seq_len`` is None, as for the encoder), a Mamba layer's cache its
        state after the first ``length`` tokens (all S where it is None:
        the rest are right pads, which leave the state as it was; see
        :meth:`ssm.Mamba.prefill`).  ``memory_kv``: a decoder block's cross
        K/V (:meth:`attention.Attention.project_kv` of the encoder
        output)."""
        cfg = self.cfg
        x = constrain_act(x)
        h = self.norm_mixer(x, cfg.norm_eps)
        if self.is_mamba:
            with span("ssm.prefill"):
                out, cache = self.mamba.prefill(h, length)
                x = self._residual(x, out)
            return self._ffn(x), cache
        with span("attn.prefill"):
            q, k, v = self.attn.qkv(h, positions)
            mode, window = mask_args(cfg, self.kind)
            out = ops.attention(q, k, v, causal=mode != "full",
                                window=window)
            x = self._residual(x, self.attn.output(out))
            cache = None if seq_len is None else attn_mod.fill_cache(
                k, v, attn_mod.cache_len(cfg, layer_idx, seq_len))
        if memory_kv is not None:
            x = self._cross(x, memory_kv, decode=False)
        return self._ffn(x), cache

    def decode(self, x: torch.Tensor, cache: dict,
               position: int | torch.Tensor,
               memory_kv: dict | None = None) -> torch.Tensor:
        """One block for one new token x (B, 1, D) at ``position`` (an int
        or a (B,) tensor); writes the token's K/V (a Mamba layer: its new
        state) into ``cache`` in place.  ``memory_kv``: a decoder block's
        cross cache, every slot of which the token attends (B5 at the last
        slot's position)."""
        cfg = self.cfg
        h = self.norm_mixer(x, cfg.norm_eps)
        if self.is_mamba:
            with span("ssm.decode"):
                out, state = self.mamba.decode(h, cache)
                for name, t in state.items():
                    cache[name].copy_(t)
                x = self._residual(x, out)
            return self._ffn(x)
        if isinstance(position, torch.Tensor) and position.ndim > 0:
            pos_arr = position.to(x.device).reshape(-1, 1)
        else:
            pos_arr = torch.full((1, 1), int(position), device=x.device)
        with span("attn.decode"):
            q, k, v = self.attn.qkv(h, pos_arr)
            attn_mod.cache_write_decode(cache, k, v, position)
            _, full_ring, window = self.decode_reads(cache)
            out = attn_mod.decode_attend(cache, q, full_ring=full_ring,
                                         position=position, window=window)
            x = self._residual(x, self.attn.output(out))
        if memory_kv is not None:
            x = self._cross(x, memory_kv, decode=True)
        return self._ffn(x)

    def decode_reads(self, cache: dict) -> tuple[int, bool, int] | None:
        """What :meth:`decode` has kernel B5 read against ``cache``:
        (cache_len, full_ring, window), a cache no longer than the window
        being a warm ring; None for a Mamba block."""
        if self.is_mamba:
            return None
        _, window = mask_args(self.cfg, self.kind)
        n = cache["k"].shape[1]
        return n, 0 < n <= window, window
