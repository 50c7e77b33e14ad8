"""Gradient compression for data parallelism across slow links (the port
of ``repro/training/grad_compression.py``).

* **bf16** — gradients rounded to bf16 before the optimizer takes them
  (what would cross the links), back in float32.
* **int8 with error feedback** — one scale per leaf (its max-abs over the
  whole layer stack, as the reference's stacked leaf has), int8
  quantization, and a float32 residual added back at the next step.

The port runs on one card with no all-reduce; the compression is applied
where the reference applies it, between the gradients and the optimizer,
so the arithmetic the optimizer sees is the same.  Gradients and residuals
are in the reference's leaf layout (see :mod:`.optimizer`).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.training.optimizer import Leaves, members, stacked_shape


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    mode: str = "none"        # none | bf16 | int8_ef


def compress_cast(grads: Leaves, cfg: CompressionConfig) -> Leaves:
    """bf16 path: a lossy round trip through bf16."""
    if cfg.mode != "bf16":
        return grads

    def cast(g):
        return g.to(torch.bfloat16).float()
    return {k: [cast(g) for g in v] if isinstance(v, list) else cast(v)
            for k, v in grads.items()}


def init_error_feedback(params: Leaves) -> dict:
    """Zero float32 residuals, one stacked tensor per leaf."""
    return {k: torch.zeros(stacked_shape(v), dtype=torch.float32,
                           device=members(v)[0].device)
            for k, v in params.items()}


@torch.no_grad()
def compress_int8_ef(grads: Leaves, residual: dict) -> tuple[Leaves, dict]:
    """int8 quantization with error feedback.  Returns (dequantized grads,
    new residuals); the residuals are written in place."""
    out = {}
    for path, leaf in grads.items():
        stacked = isinstance(leaf, list)
        r = residual[path]
        g32 = [g.float() + ri for g, ri in
               zip(members(leaf), r.unbind(0) if stacked else [r])]
        amax = torch.stack([torch.amax(torch.abs(x)) for x in g32]).amax()
        scale = torch.clamp(amax, min=1e-12) / 127.0
        deq = [torch.clamp(torch.round(x / scale), -127, 127)
               .to(torch.int8).float() * scale for x in g32]
        new_r = [x - d for x, d in zip(g32, deq)]
        r.copy_(torch.stack(new_r) if stacked else new_r[0])
        out[path] = deq if stacked else deq[0]
    return out, residual
