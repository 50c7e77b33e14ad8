"""The Mamba-2 mixer (the port of ``repro/models/ssm.py``).

Layout: d_inner = expand * d_model split into H heads of P = ssm_head_dim;
B/C projections shared per group (G = ssm_ngroups) over N = ssm_state
channels; a per-head scalar decay A and an input-dependent step dt through
softplus.  Prefill runs the chunked SSD scan through
:func:`repro_torch.kernels.ssd.ops.ssd` (kernel B6 on the card, the plain
``ssd_chunked`` on the CPU); decode is the plain one-token recurrence
(the reference has no kernel for it).  Training (:meth:`Mamba.forward`)
calls the plain, differentiable ``ssd_chunked`` on every device, as the
reference's ``mamba_forward`` does.

Parameters keep the reference's names (``in_z in_x in_b in_c in_dt
conv_{x,b,c}_{w,b} a_log d_skip dt_bias norm out_proj``), so a reference
parameter tree converts leaf for leaf.  The cache of a Mamba layer is
``{"conv_x", "conv_b", "conv_c", "ssm"}``, every leaf in the compute type.

A serving prefill over a right-padded bucket is given the real length
(:meth:`Mamba.prefill`): the pads' steps ``dt`` are set to 0, so the scan
leaves the state exactly as the last real token left it (decay exp(0) = 1,
input 0), and the conv state is taken from the last W-1 real inputs.  The
state handed to decode is that of the real prompt, where the reference's
has seen the pads.

A ``Mamba`` counts in plain host integers, as ``Moe.rows`` does
(:func:`repro_torch.tracing.count`):
``scan_tokens``, the tokens its prefills ran through the scan (pads
included), and ``state_steps``, the lanes its decode steps advanced.  The
span ``ssm.scan`` (:func:`repro_torch.tracing.span`) marks the prefill's
scan while a profiler records.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssd import ops
from repro_torch.kernels.ssd.ref import ssd_chunked, ssd_decode_step
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.tracing import count, span


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``, with no
    switch to the identity for large x."""
    return torch.logaddexp(x, torch.zeros_like(x))


def causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                init_state: torch.Tensor | None = None,
                length: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d: x (B, S, C), w (W, C).  Returns (silu(y +
    bias), the last W-1 inputs, or the W-1 inputs up to ``length`` where
    the rest are pads).  The W products are summed in x's type in a Python
    loop, as the reference does."""
    width = w.shape[0]
    pad = (init_state if init_state is not None
           else torch.zeros((x.shape[0], width - 1, x.shape[2]),
                            dtype=x.dtype, device=x.device))
    xp = torch.cat([pad, x], dim=1)                          # (B, S+W-1, C)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0][None, None]
    for i in range(1, width):
        y = y + xp[:, i:i + s] * w[i][None, None]
    end = xp.shape[1] if length is None else length + width - 1
    new_state = xp[:, end - (width - 1):end] if width > 1 else pad
    return F.silu(y + bias), new_state


def conv_decode_step(x_t: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                     conv_state: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """x_t (B, 1, C); conv_state (B, W-1, C), the previous inputs."""
    xp = torch.cat([conv_state, x_t], dim=1)                 # (B, W, C)
    y = torch.einsum("bwc,wc->bc", xp.float(), w.float()).to(x_t.dtype)
    return F.silu(y + bias)[:, None], xp[:, 1:]


def mamba_specs(cfg: ModelConfig) -> dict:
    return {
        "in_z": ("embed", "ssm_inner"),
        "in_x": ("embed", "ssm_inner"),
        "in_b": ("embed", None),
        "in_c": ("embed", None),
        "in_dt": ("embed", None),
        "conv_x_w": (None, "ssm_inner"),
        "conv_x_b": ("ssm_inner",),
        "conv_b_w": (None, None),
        "conv_b_b": (None,),
        "conv_c_w": (None, None),
        "conv_c_b": (None,),
        "a_log": ("ssm_heads",),
        "d_skip": ("ssm_heads",),
        "dt_bias": ("ssm_heads",),
        "norm": ("ssm_inner",),
        "out_proj": ("ssm_inner", "embed"),
    }


def mamba_state_specs() -> dict:
    return {"conv_x": ("act_batch", None, "ssm_inner"),
            "conv_b": ("act_batch", None, None),
            "conv_c": ("act_batch", None, None),
            "ssm": ("act_batch", "ssm_heads", None, None)}


class Mamba(nn.Module):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        d, di = cfg.d_model, cfg.d_inner
        h, gn = cfg.ssm_heads, cfg.ssm_ngroups * cfg.ssm_state
        dtype, f32 = layers.dtype_of(cfg), torch.float32

        def par(shape, dt=dtype):
            return layers.parameter(shape, dt, device)

        self.in_z, self.in_x = par((d, di)), par((d, di))
        self.in_b, self.in_c = par((d, gn)), par((d, gn))
        self.in_dt = par((d, h))
        self.conv_x_w, self.conv_x_b = par((cfg.ssm_conv, di)), par((di,))
        self.conv_b_w, self.conv_b_b = par((cfg.ssm_conv, gn)), par((gn,))
        self.conv_c_w, self.conv_c_b = par((cfg.ssm_conv, gn)), par((gn,))
        self.a_log, self.d_skip = par((h,), f32), par((h,), f32)
        self.dt_bias = par((h,), f32)
        self.norm = par((di,))
        self.out_proj = par((di, d))
        self.scan_tokens = 0
        self.state_steps = 0

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """The reference's scales: projections N(0, 1) / sqrt(d_model),
        conv weights 0.1 N(0, 1), out_proj N(0, 1) / sqrt(d_inner),
        a_log = log(1..H), d_skip and norm ones, biases zero."""
        s_in = 1.0 / math.sqrt(self.cfg.d_model)
        for p in (self.in_z, self.in_x, self.in_b, self.in_c, self.in_dt):
            layers.fill_normal(p, s_in, gen)
        for p in (self.conv_x_w, self.conv_b_w, self.conv_c_w):
            layers.fill_normal(p, 0.1, gen)
        for p in (self.conv_x_b, self.conv_b_b, self.conv_c_b, self.dt_bias):
            p.zero_()
        self.a_log.copy_(torch.log(torch.arange(
            1, self.cfg.ssm_heads + 1, dtype=torch.float32)))
        self.d_skip.fill_(1.0)
        self.norm.fill_(1.0)
        layers.fill_normal(self.out_proj, 1.0 / math.sqrt(self.cfg.d_inner),
                           gen)

    def _project(self, x_in: torch.Tensor):
        dt_c = x_in.dtype
        return tuple(x_in @ w.to(dt_c) for w in (
            self.in_z, self.in_x, self.in_b, self.in_c, self.in_dt))

    def _output(self, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """Gated RMSNorm, then the out-projection (Mamba-2 ordering)."""
        y = y * F.silu(z)
        y = layers.rms_norm(y, self.norm, self.cfg.norm_eps)
        return y @ self.out_proj.to(y.dtype)

    def prefill(self, x_in: torch.Tensor, length: int | None = None
                ) -> tuple[torch.Tensor, dict]:
        """The mixer over a full sequence x_in (B, S, D) from a zero state:
        (out (B, S, D), cache).  With ``length`` < S the tokens past it are
        right pads: the cache is the state after the first ``length``
        tokens, and the pads' outputs are not the model's."""
        count(self, "scan_tokens", x_in.shape[0] * x_in.shape[1])
        return self._mix(x_in, ops.ssd, length)

    def forward(self, x_in: torch.Tensor) -> torch.Tensor:
        """The training mixer over x_in (B, S, D) from a zero state, through
        the differentiable ``ssd_chunked``: out (B, S, D)."""
        return self._mix(x_in, ssd_chunked)[0]

    def _mix(self, x_in: torch.Tensor, scan, length: int | None = None
             ) -> tuple[torch.Tensor, dict]:
        cfg = self.cfg
        h, p = cfg.ssm_heads, cfg.ssm_head_dim
        g, n = cfg.ssm_ngroups, cfg.ssm_state
        dt_c = x_in.dtype
        bsz, s, _ = x_in.shape
        if length is not None and length >= s:
            length = None
        z, xr, bb, cc, dt = self._project(x_in)
        xr, conv_x = causal_conv(xr, self.conv_x_w.to(dt_c),
                                 self.conv_x_b.to(dt_c), length=length)
        bb, conv_b = causal_conv(bb, self.conv_b_w.to(dt_c),
                                 self.conv_b_b.to(dt_c), length=length)
        cc, conv_c = causal_conv(cc, self.conv_c_w.to(dt_c),
                                 self.conv_c_b.to(dt_c), length=length)
        xh = xr.reshape(bsz, s, h, p)
        dt_pos = softplus(dt.float() + self.dt_bias[None, None, :])
        if length is not None:
            # a step of 0 leaves the state exactly as it was
            dt_pos[:, length:] = 0.0
        a = -torch.exp(self.a_log)
        with span("ssm.scan"):
            y, ssm = scan(xh, dt_pos, a, bb.reshape(bsz, s, g, n),
                          cc.reshape(bsz, s, g, n), cfg.ssm_chunk)
        y = y + xh * self.d_skip[None, None, :, None].to(xh.dtype)
        out = self._output(y.reshape(bsz, s, cfg.d_inner), z)
        return out, {"conv_x": conv_x, "conv_b": conv_b, "conv_c": conv_c,
                     "ssm": ssm}

    def decode(self, x_in: torch.Tensor, state: dict
               ) -> tuple[torch.Tensor, dict]:
        """One token x_in (B, 1, D) from ``state``: (out (B, 1, D), new
        state)."""
        count(self, "state_steps", x_in.shape[0])
        cfg = self.cfg
        h, p = cfg.ssm_heads, cfg.ssm_head_dim
        g, n = cfg.ssm_ngroups, cfg.ssm_state
        dt_c = x_in.dtype
        z, xr, bb, cc, dt = self._project(x_in)
        xr, conv_x = conv_decode_step(xr, self.conv_x_w.to(dt_c),
                                      self.conv_x_b.to(dt_c), state["conv_x"])
        bb, conv_b = conv_decode_step(bb, self.conv_b_w.to(dt_c),
                                      self.conv_b_b.to(dt_c), state["conv_b"])
        cc, conv_c = conv_decode_step(cc, self.conv_c_w.to(dt_c),
                                      self.conv_c_b.to(dt_c), state["conv_c"])
        bsz = xr.shape[0]
        dt_pos = softplus(dt[:, 0].float() + self.dt_bias[None, :])
        a = -torch.exp(self.a_log)
        y, ssm = ssd_decode_step(state["ssm"], xr[:, 0].reshape(bsz, h, p),
                                 dt_pos, a, bb[:, 0].reshape(bsz, g, n),
                                 cc[:, 0].reshape(bsz, g, n))
        y = y.reshape(bsz, 1, cfg.d_inner) + (
            xr.reshape(bsz, 1, h, p)
            * self.d_skip[None, None, :, None].to(xr.dtype)
        ).reshape(bsz, 1, cfg.d_inner)
        out = self._output(y, z)
        return out, {"conv_x": conv_x, "conv_b": conv_b, "conv_c": conv_c,
                     "ssm": ssm}


def init_state(cfg: ModelConfig, batch: int, dtype: torch.dtype,
               device=None) -> dict:
    """Zero decode state of one Mamba layer, every leaf in ``dtype``."""
    gn = cfg.ssm_ngroups * cfg.ssm_state
    w = cfg.ssm_conv - 1

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {"conv_x": zeros(batch, w, cfg.d_inner),
            "conv_b": zeros(batch, w, gn), "conv_c": zeros(batch, w, gn),
            "ssm": zeros(batch, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state)}
