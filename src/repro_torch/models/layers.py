"""Common layers: RMSNorm, rotary embeddings, the gated MLP, the embedding,
the LM head and the losses (the port of ``repro/models/layers.py``).

Each layer is an ``nn.Module`` whose parameters keep the reference's names
and shapes, so a reference parameter tree converts leaf for leaf
(:mod:`repro_torch.models.convert`).  Parameters are stored in
``cfg.param_dtype`` and cast to the activation's type where they are used,
as the reference does.  ``init_weights`` draws them from an explicit
``torch.Generator`` with the reference's scales.  Each layer has a
``*_specs`` function giving its parameters' *logical axis names* per
dimension, as the reference's do; :mod:`repro_torch.sharding` maps them to
mesh axes.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(cfg: ModelConfig, kind: str = "param") -> torch.dtype:
    return _DTYPES[cfg.param_dtype if kind == "param" else cfg.compute_dtype]


def parameter(shape: tuple[int, ...], dtype: torch.dtype,
              device: torch.device | str | None) -> nn.Parameter:
    """An uninitialized frozen parameter (serving never takes gradients;
    :func:`repro_torch.training.init_train_state` unfreezes them)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


@torch.no_grad()
def fill_normal(p: torch.Tensor, std: float, gen: torch.Generator) -> None:
    """``p <- N(0, 1) * std``, drawn in float32 from ``gen`` on ``p``'s
    device and rounded to ``p``'s type."""
    p.copy_(torch.randn(p.shape, generator=gen, device=p.device).mul_(std))


def rmsnorm_specs() -> dict:
    return {"scale": ("embed",)}


def mlp_specs() -> dict:
    return {"wi": ("embed", "mlp"), "wg": ("embed", "mlp"),
            "wo": ("mlp", "embed")}


def embedding_specs(cfg: ModelConfig) -> dict:
    out = {"table": ("vocab", "embed")}
    if not cfg.tie_embeddings:
        out["head"] = ("embed", "vocab")
    return out


class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.scale = parameter((d,), dtype, device)

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        self.scale.fill_(1.0)

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        return rms_norm(x, self.scale, eps)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """RMSNorm over the last axis in float32, scaled, cast back to x's
    type."""
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device | str | None = None
                     ) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).

    The head splits into halves (not interleaved pairs), in float32."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)             # (hd/2,)
    angles = positions[..., :, None].float() * freqs          # (.., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                  # (.., S, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class Mlp(nn.Module):
    """Gated MLP: SwiGLU (``silu``) or GeGLU (``gelu``, tanh approximation
    as ``jax.nn.gelu`` defaults to)."""

    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.wi = parameter((d_model, d_ff), dtype, device)
        self.wg = parameter((d_model, d_ff), dtype, device)
        self.wo = parameter((d_ff, d_model), dtype, device)

    def init_weights(self, gen: torch.Generator) -> None:
        d_model, d_ff = self.wi.shape
        fill_normal(self.wi, 1.0 / math.sqrt(d_model), gen)
        fill_normal(self.wg, 1.0 / math.sqrt(d_model), gen)
        fill_normal(self.wo, 1.0 / math.sqrt(d_ff), gen)

    def forward(self, x: torch.Tensor, act: str) -> torch.Tensor:
        h = x @ self.wi.to(x.dtype)
        g = gate_act(x @ self.wg.to(x.dtype), act)
        return (h * g) @ self.wo.to(x.dtype)


def gate_act(g: torch.Tensor, act: str) -> torch.Tensor:
    """The gate's activation: SiLU, or GELU's tanh approximation (as
    ``jax.nn.gelu`` defaults to)."""
    return F.silu(g) if act == "silu" else F.gelu(g, approximate="tanh")


class Embedding(nn.Module):
    """Token table (scaled by sqrt(d_model) on the way in) and LM head
    (the transposed table when tied)."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = dtype_of(cfg)
        self.table = parameter((cfg.vocab_size, cfg.d_model), dtype, device)
        if not cfg.tie_embeddings:
            self.head = parameter((cfg.d_model, cfg.vocab_size), dtype,
                                  device)

    def init_weights(self, gen: torch.Generator) -> None:
        fill_normal(self.table, 0.02, gen)
        if not self.cfg.tie_embeddings:
            fill_normal(self.head, 1.0 / math.sqrt(self.cfg.d_model), gen)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.table[tokens.long()]
        return (x * math.sqrt(self.cfg.d_model)).to(
            dtype_of(self.cfg, "compute"))

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return x @ self.table.to(x.dtype).T
        return x @ self.head.to(x.dtype)


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------
def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token cross-entropy; logits (..., V) of any type, reduced in
    float32."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def chunked_lm_loss(embed: Embedding, x: torch.Tensor, labels: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Cross-entropy over the LM head without the full (B, S, V) logits:
    with ``cfg.loss_chunk`` > 0 the sequence is cut into chunks of that
    many tokens, taken in order, and the loss is the mean of the chunks'
    means (the memory lever of the large-vocabulary archs)."""
    if cfg.loss_chunk <= 0 or x.shape[1] <= cfg.loss_chunk:
        return softmax_xent(embed.logits(x), labels)
    s, c = x.shape[1], cfg.loss_chunk
    assert s % c == 0, f"seq {s} not divisible by loss_chunk {c}"
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, c):
        total = total + softmax_xent(embed.logits(x[:, i:i + c]),
                                     labels[:, i:i + c])
    return total / (s // c)
