"""Model assembly: the decoder-only LM of the dense and Mamba-2 families
(the port of ``repro/models/model.py``).

:func:`build_model` returns a :class:`DecoderOnlyLM` — an ``nn.Module``
exposing

  init_weights(gen)                               random weights from a seed
  prefill(tokens, max_len, last_index) -> (last_logits, caches)
  decode_step(tokens, caches, position) -> (logits, caches)
  init_caches(batch_size, seq_len) -> zero caches

``tokens`` are (B, S) integer tensors; caches are a list with one dict per
layer, updated in place by ``decode_step``: ``{"k", "v"}`` for attention
(see :mod:`repro_torch.models.attention`), ``{"conv_x", "conv_b",
"conv_c", "ssm"}`` for Mamba (see :mod:`repro_torch.models.ssm`).  Families
other than ``dense`` and ``ssm`` raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.blocks import WAITING, Block
from repro_torch.models.config import ModelConfig


class DecoderOnlyLM(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        family = "encdec" if cfg.is_encoder_decoder else cfg.family
        if family in WAITING:
            raise NotImplementedError(
                f"{cfg.name}: the {family} family is not ported yet: "
                f"ROADMAP {WAITING[family]}")
        self.cfg = cfg
        self.embed = layers.Embedding(cfg, device)
        self.layers = nn.ModuleList(
            Block(cfg, cfg.layer_kind(i), device) for i in range(cfg.n_layers))
        self.final_norm = layers.RMSNorm(cfg.d_model, layers.dtype_of(cfg),
                                         device)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    def init_weights(self, gen: torch.Generator) -> "DecoderOnlyLM":
        """Random weights with the reference's scales, drawn from ``gen``
        (on the model's device) in a fixed order."""
        self.embed.init_weights(gen)
        for blk in self.layers:
            blk.init_weights(gen)
        self.final_norm.init_weights(gen)
        return self

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x, self.cfg.norm_eps)
        return self.embed.logits(x)

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int | None = None,
                last_index: int | torch.Tensor | None = None
                ) -> tuple[torch.Tensor, list]:
        """Prefill; caches get capacity ``max_len`` (>= prompt length).

        ``last_index``: position whose logits to return (defaults to the
        final position; right-padded prompts pass their true last index).
        Returns (logits (B, 1, V), caches).
        """
        x = self.embed.embed(tokens.to(self.device))
        s = x.shape[1]
        max_len = max_len or s
        positions = torch.arange(s, device=x.device)
        caches = []
        for i, blk in enumerate(self.layers):
            x, cache = blk.prefill(x, positions, i, max_len)
            caches.append(cache)
        idx = s - 1 if last_index is None else int(last_index)
        return self._head(x[:, idx:idx + 1]), caches

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, caches: list,
                    position: int | torch.Tensor
                    ) -> tuple[torch.Tensor, list]:
        """One token per sequence, tokens (B, 1), at ``position`` (an int or
        a (B,) tensor).  The caches are written in place and returned."""
        x = self.embed.embed(tokens.to(self.device))
        for blk, cache in zip(self.layers, caches):
            x = blk.decode(x, cache, position)
        return self._head(x), caches

    def init_caches(self, batch_size: int, seq_len: int) -> list:
        """Zero caches shaped for decoding against a seq_len context."""
        cfg = self.cfg
        dtype = layers.dtype_of(cfg, "compute")
        return [ssm_mod.init_state(cfg, batch_size, dtype, self.device)
                if blk.kind == "mamba" else
                attn_mod.init_cache(cfg, batch_size,
                                    attn_mod.cache_len(cfg, i, seq_len),
                                    dtype, self.device)
                for i, blk in enumerate(self.layers)]


class EncoderDecoderLM:
    """seamless-m4t style encoder-decoder: not ported yet."""

    def __init__(self, cfg: ModelConfig, device=None):
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder model is not ported yet: "
            f"ROADMAP {WAITING['encdec']}")


def build_model(cfg: ModelConfig, device: str | torch.device = "cuda",
                seed: int = 0) -> DecoderOnlyLM:
    """The model of ``cfg`` on ``device`` with random weights drawn from a
    ``torch.Generator`` seeded with ``seed`` (to load given weights, see
    :func:`repro_torch.models.convert.model_from_state_dict`)."""
    dev = resolve_device(device)
    cls = EncoderDecoderLM if cfg.is_encoder_decoder else DecoderOnlyLM
    model = cls(cfg, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return model.init_weights(gen)
