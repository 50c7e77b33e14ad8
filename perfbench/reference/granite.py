"""Plain float32 reference of the served hybrid decoder, Granite-4.0-H
(granitemoehybrid: https://huggingface.co/ibm-granite/granite-4.0-h-small,
its ``config.json``), with TF32 off and dropless top-k routing.

A full forward pass over a prompt and the tokens served after it, layer by
layer for a batch of sequences so that each layer's weights are widened
once.  It imports nothing of the program and reads the weights the
benchmark made (:mod:`perfbench.hybrid_weights`, named as the program's
``state_dict``).

The layer equations as published:

* embedding: the token's row times ``embed_scale`` (``embedding_multiplier``);
* every layer: x + r * mixer(RMSNorm(x)), then x + r * (MoE(h) +
  shared(h)) with h = RMSNorm(x) and r = ``residual_scale``
  (``residual_multiplier``), RMSNorm eps ``norm_eps``;
* the mixer of layer i is attention where i % ``attn_every`` ==
  ``attn_offset`` (``layer_types``), else Mamba-2;
* attention: GQA, no positional encoding (``position_embedding_type``
  "nope"), causal, the softmax scale ``attn_scale``
  (``attention_multiplier``), no bias;
* Mamba-2: the input projected to z, x, B, C and dt; a depthwise causal
  conv of width ``ssm_conv`` with bias over x, B and C (``torch``'s
  ``conv1d``), then SiLU; dt = softplus(dt + dt_bias), A = -exp(A_log);
  the SSD scan of :func:`ssd` (the Mamba-2 paper's minimal chunked listing,
  arXiv:2405.21060) with ``ssm_ngroups`` groups of B and C shared by the
  heads; y + D x; the gated RMSNorm RMSNorm(y * SiLU(z)); the
  out-projection;
* MoE: the router's logits, the ``top_k`` largest, a softmax over those
  (GraniteMoe's gating); each chosen expert's SwiGLU (``wg`` under SiLU
  times ``wi``, then ``wo``) weighted by its gate; a shared SwiGLU expert
  of width ``shared_d_ff`` on every token;
* the tied head: RMSNorm(x) times the embedding table's transpose, divided
  by ``logit_divisor`` (``logits_scaling``).

Departures from the published model: the weights are the benchmark's
random ones; the input projection is read as five matrices (z, x, B, C,
dt) and the conv as three (x, B, C), which is the published
``in_proj``/``conv1d`` split by columns; the configuration's ``n_layers``
first layers only (the first pipeline stage) with the final norm and head
after them; float32 throughout, where the model is served in bf16.

``quant="fp8"`` is the control: every matmul's weight and input rounded
to float8 e4m3 with a scale per weight tensor and per input row (the step
below the bf16 the configuration serves in), as
:mod:`perfbench.reference.mixtral` does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.mixtral import _Mm, rms_norm


# ------------------------------------------------------------------ SSD
def segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., T) -> (..., T, T): out[i, j] = sum_{k=j+1..i} x[k] for i >= j,
    else -inf (the listing's stable segment sum)."""
    t = x.shape[-1]
    x = x[..., None].expand(*x.shape, t)
    lower = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device),
                       diagonal=-1)
    x = x.masked_fill(~lower, 0)
    out = torch.cumsum(x, dim=-2)
    diag = torch.tril(torch.ones(t, t, dtype=torch.bool, device=x.device))
    return out.masked_fill(~diag, float("-inf"))


def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        block_len: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-2 paper's minimal SSD from a zero state, one sequence.

    x (L, H, P) the input already times dt; a (L, H) the decay exponents
    dt * A; b, c (L, H, N).  Returns (y (L, H, P), final state (H, P, N)).
    A ragged end is padded with zero steps, which change nothing before
    them."""
    n_real = x.shape[0]
    pad = -n_real % block_len
    if pad:
        x, a, b, c = (torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
                      for t in (x, a, b, c))
    nc = x.shape[0] // block_len
    x, a, b, c = (t.reshape(nc, block_len, *t.shape[1:])
                  for t in (x, a, b, c))
    a = a.permute(2, 0, 1)                                    # (H, c, l)
    a_cs = torch.cumsum(a, dim=-1)
    # 1. the diagonal blocks' outputs
    ll = torch.exp(segsum(a))                                 # (H, c, l, s)
    y_diag = torch.einsum("clhn,cshn,hcls,cshp->clhp", c, b, ll, x)
    # 2. each chunk's state from its own inputs
    decay_states = torch.exp(a_cs[:, :, -1:] - a_cs)          # (H, c, l)
    states = torch.einsum("clhn,hcl,clhp->chpn", b, decay_states, x)
    # 3. the states passed between chunks
    states = torch.cat([torch.zeros_like(states[:1]), states], dim=0)
    decay_chunk = torch.exp(segsum(F.pad(a_cs[:, :, -1], (1, 0))))
    new_states = torch.einsum("hzc,chpn->zhpn", decay_chunk, states)
    states, final = new_states[:-1], new_states[-1]
    # 4. each chunk's state to its outputs
    y_off = torch.einsum("clhn,chpn,hcl->clhp", c, states, torch.exp(a_cs))
    y = (y_diag + y_off).reshape(nc * block_len, *x.shape[2:])
    return y[:n_real], final


# -------------------------------------------------------------- mixers
def causal_conv(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor
                ) -> torch.Tensor:
    """Depthwise causal conv1d of x (L, C) with w (W, C) and bias, SiLU."""
    width = w.shape[0]
    y = F.conv1d(x.T[None], w.T[:, None, :], bias, padding=width - 1,
                 groups=x.shape[1])[0, :, :x.shape[0]]
    return F.silu(y.T)


def mamba(h: torch.Tensor, w: dict, m: dict, mm: _Mm) -> torch.Tensor:
    """The Mamba-2 mixer over one sequence h (L, D)."""
    n = h.shape[0]
    heads, p = m["d_model"] * m["ssm_expand"] // m["ssm_head_dim"], \
        m["ssm_head_dim"]
    g, st = m["ssm_ngroups"], m["ssm_state"]
    z = mm(h, w["in_z"])
    xr = causal_conv(mm(h, w["in_x"]), w["conv_x_w"], w["conv_x_b"])
    bb = causal_conv(mm(h, w["in_b"]), w["conv_b_w"], w["conv_b_b"])
    cc = causal_conv(mm(h, w["in_c"]), w["conv_c_w"], w["conv_c_b"])
    dt = F.softplus(mm(h, w["in_dt"]) + w["dt_bias"])         # (L, H)
    a = -torch.exp(w["a_log"])
    xh = xr.view(n, heads, p)
    rep = heads // g
    bh = bb.view(n, g, st).repeat_interleave(rep, dim=1)
    ch = cc.view(n, g, st).repeat_interleave(rep, dim=1)
    y, _ = ssd(xh * dt[..., None], dt * a, bh, ch, m["ssm_chunk"])
    y = y + xh * w["d_skip"][:, None]
    y = rms_norm(y.reshape(n, -1) * F.silu(z), w["norm"], m["norm_eps"])
    return mm(y, w["out_proj"])


def attention(h: torch.Tensor, w: dict, m: dict, mm: _Mm,
              block: int = 1024) -> torch.Tensor:
    """Causal GQA without positional encoding over one sequence h (L, D),
    softmax scale ``attn_scale``, in blocks of queries."""
    n = h.shape[0]
    hq, hkv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    q = mm(h, w["wq"]).view(n, hq, hd)
    k = mm(h, w["wk"]).view(n, hkv, hd).repeat_interleave(hq // hkv, dim=1)
    v = mm(h, w["wv"]).view(n, hkv, hd).repeat_interleave(hq // hkv, dim=1)
    out = torch.empty_like(q)
    for q0 in range(0, n, block):
        q1 = min(n, q0 + block)
        s = torch.einsum("qhd,khd->hqk", q[q0:q1], k[:q1]) * m["attn_scale"]
        qi = torch.arange(q0, q1, device=h.device)[:, None]
        kj = torch.arange(q1, device=h.device)[None, :]
        s = s.masked_fill(kj > qi, float("-inf"))
        out[q0:q1] = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1),
                                  v[:q1])
    return mm(out.reshape(n, hq * hd), w["wo"])


def swiglu(x: torch.Tensor, wi, wg, wo, mm: _Mm) -> torch.Tensor:
    return mm(mm(x, wi) * F.silu(mm(x, wg)), wo)


def moe(x: torch.Tensor, w: dict, m: dict, mm: _Mm) -> torch.Tensor:
    """Dropless top-k routing with a softmax over the chosen logits, plus
    the shared expert."""
    top, idx = torch.topk(mm(x, w["router"]), m["top_k"], dim=-1)
    gates = torch.softmax(top, dim=-1)
    y = swiglu(x, w["shared.wi"], w["shared.wg"], w["shared.wo"], mm)
    for e in range(m["n_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            y.index_add_(0, tok, swiglu(x[tok], w["wi"][e], w["wg"][e],
                                        w["wo"][e], mm)
                         * gates[tok, slot, None])
    return y


def is_attention(m: dict, i: int) -> bool:
    return i % m["attn_every"] == m["attn_offset"] % m["attn_every"]


# ------------------------------------------------------------- forward
@torch.no_grad()
def logits(m: dict, weights: dict, seqs: list, device,
           quant: str | None = None) -> list:
    """Float32 logits of each sequence at the positions it asks for.

    ``seqs``: (token ids, first, last) with ``first``..``last - 1`` the
    positions whose next-token logits are returned, as a (last - first, V)
    tensor per sequence."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mm = _Mm(quant)
    d, r, eps = m["d_model"], m["residual_scale"], m["norm_eps"]
    table = weights["embed.table"]
    hs = [table[torch.as_tensor(t, device=device)].float() * m["embed_scale"]
          for t, _, _ in seqs]
    for i in range(m["n_layers"]):
        p = f"layers.{i}."
        if is_attention(m, i):
            mixer = attention
            wm = {k: mm.weight(weights[p + "attn." + k].reshape(
                (d, -1) if k != "wo" else (-1, d)))
                for k in ("wq", "wk", "wv", "wo")}
        else:
            mixer = mamba
            wm = {k: v.float() for k, v in weights.items()
                  if k.startswith(p + "mamba.")}
            wm = {k[len(p + "mamba."):]: v for k, v in wm.items()}
            for k in ("in_z", "in_x", "in_b", "in_c", "in_dt", "out_proj"):
                wm[k] = mm.weight(wm[k])
        we = {k: mm.weight(weights[p + "moe." + k])
              for k in ("router", "wi", "wg", "wo", "shared.wi", "shared.wg",
                        "shared.wo")}
        for j, x in enumerate(hs):
            h = rms_norm(x, weights[p + "norm_mixer.scale"], eps)
            x = x + r * mixer(h, wm, m, mm)
            h = rms_norm(x, weights[p + "norm_mlp.scale"], eps)
            hs[j] = x + r * moe(h, we, m, mm)
        del wm, we
    head = mm.weight(table).T
    out = []
    for x, (_, first, last) in zip(hs, seqs):
        h = rms_norm(x[first:last], weights["final_norm.scale"], eps)
        out.append(mm(h, head) / m["logit_divisor"])
    return out
