"""Plain float32 reference of the served MoE decoder (Mixtral-8x7B's layer
equations, arXiv:2401.04088), with TF32 off and dropless top-k routing.

A full forward pass over a prompt and the tokens served after it, layer by
layer for a batch of sequences so that each layer's weights are widened
once, attention in blocks of queries, each expert over just the tokens
routed to it.  It imports nothing of the program and reads the weights the
benchmark made (:mod:`perfbench.weights`).

As published: the token's embedding row, RMSNorm with the configuration's
``norm_eps`` (Mixtral's 1e-5), RoPE over the two halves of each head,
fully dense causal attention (a sliding window of ``sliding_window`` keys,
the token's own included, only where ``attn_type`` is ``"swa"``), GQA, the
router's softmax over all experts then the top ``top_k`` renormalised,
SwiGLU experts, an untied head.  The embedding is the benchmark's table
times sqrt(d_model): the weights' convention, which the program follows
by scaling the rows it looks up (see the configuration's ``assumed``).

``quant="fp8"`` is the control: every matmul's weight and input rounded
to float8 e4m3 with a scale per weight tensor and per input row (the step
below the bf16 the configuration serves in), the products then taken in
float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_FP8_MAX = 448.0


def _fp8(x: torch.Tensor, dim=None) -> torch.Tensor:
    """x rounded to float8 e4m3 under a max-abs scale (over ``dim``, or the
    whole tensor), back in float32."""
    amax = (x.abs().amax() if dim is None
            else x.abs().amax(dim=dim, keepdim=True)).clamp(min=1e-12)
    s = _FP8_MAX / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


class _Mm:
    """Matmuls in float32, or with both operands rounded to fp8."""

    def __init__(self, quant: str | None):
        if quant not in (None, "fp8"):
            raise ValueError(f"unknown control precision {quant!r}")
        self.quant = quant

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        w = w.float()
        return w if self.quant is None else _fp8(w)

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.quant is not None:
            x = _fp8(x, dim=-1)
        return x @ w


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (n, heads, hd) at positions 0..n-1, rotated over its halves."""
    n, _, hd = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=x.device) / hd)
    ang = torch.arange(n, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, window: int, block: int = 1024) -> torch.Tensor:
    """Causal attention of q (n, hq, hd) over k/v (n, hkv, hd), each query
    seeing the ``window`` keys up to itself (every earlier key where
    ``window`` is 0), in blocks of queries."""
    n, hq, hd = q.shape
    window = window if window > 0 else n
    g = hq // k.shape[1]
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    out = torch.empty_like(q)
    for q0 in range(0, n, block):
        q1 = min(n, q0 + block)
        k0 = max(0, q0 - window + 1)
        s = torch.einsum("qhd,khd->hqk", q[q0:q1], k[k0:q1]) / math.sqrt(hd)
        qi = torch.arange(q0, q1, device=q.device)[:, None]
        kj = torch.arange(k0, q1, device=q.device)[None, :]
        s = s.masked_fill(~((kj <= qi) & (kj > qi - window)), float("-inf"))
        out[q0:q1] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1),
                                  v[k0:q1])
    return out


def moe(x: torch.Tensor, w: dict, m: dict, mm: _Mm,
        margin: list | None = None) -> torch.Tensor:
    """Dropless top-k routing: every token to its ``top_k`` experts.
    ``margin``: a one-item list whose tensor takes each token's least gap
    between its k-th and (k+1)-th router logit."""
    router_logits = mm(x, w["router"])
    if margin is not None:
        top = torch.topk(router_logits, m["top_k"] + 1, dim=-1).values
        gap = top[:, -2] - top[:, -1]
        margin[0] = gap if margin[0] is None else torch.minimum(margin[0],
                                                               gap)
    probs = torch.softmax(router_logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :m["top_k"]], idx[:, :m["top_k"]]
    gates = gates / gates.sum(-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(m["n_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = mm(xe, w["wi"][e]) * F.silu(mm(xe, w["wg"][e]))
        y.index_add_(0, tok, mm(h, w["wo"][e]) * gates[tok, slot, None])
    return y


@torch.no_grad()
def logits(m: dict, weights: dict, seqs: list, device,
           quant: str | None = None, margins: list | None = None) -> list:
    """Float32 logits of each sequence at the positions it asks for.

    ``seqs``: (token ids, first, last) with ``first``..``last - 1`` the
    positions whose next-token logits are returned, as a (last - first, V)
    tensor per sequence.  ``margins``: a list that takes, per sequence,
    each position's least router margin over the layers (see :func:`moe`).
    """
    mg = [[None] for _ in seqs]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mm = _Mm(quant)
    d, hq, hkv, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    eps = m["norm_eps"]
    win = m["sliding_window"] if m.get("attn_type") == "swa" else 0
    table = weights["embed.table"]
    hs = [table[torch.as_tensor(t, device=device)].float() * math.sqrt(d)
          for t, _, _ in seqs]
    for i in range(m["n_layers"]):
        p = f"layers.{i}."
        a = {k: mm.weight(weights[p + "attn." + k].reshape(
            (d, -1) if k != "wo" else (hq * hd, d)))
            for k in ("wq", "wk", "wv", "wo")}
        e = {k: mm.weight(weights[p + "moe." + k])
             for k in ("router", "wi", "wg", "wo")}
        for j, x in enumerate(hs):
            n = x.shape[0]
            h = rms_norm(x, weights[p + "norm_mixer.scale"], eps)
            q = rope(mm(h, a["wq"]).view(n, hq, hd), m["rope_theta"])
            k = rope(mm(h, a["wk"]).view(n, hkv, hd), m["rope_theta"])
            v = mm(h, a["wv"]).view(n, hkv, hd)
            x = x + mm(attention(q, k, v, win).reshape(n, hq * hd), a["wo"])
            h = rms_norm(x, weights[p + "norm_mlp.scale"], eps)
            hs[j] = x + moe(h, e, m, mm, mg[j] if margins is not None
                            else None)
        del a, e
    head = mm.weight(weights["embed.head"])
    out = []
    if margins is not None:
        margins += [g[0][first:last] for g, (_, first, last) in zip(mg, seqs)]
    for x, (_, first, last) in zip(hs, seqs):
        h = rms_norm(x[first:last], weights["final_norm.scale"], eps)
        out.append(mm(h, head))
    return out
