"""The served model's weights, made on the device from the run's seed.

The benchmark makes them and hands the same tensors to the program
(``ServingEngine(params=...)``) and to the reference.  One flat buffer in
the served type is filled with standard normals by one generator on the
card, a few large calls; each leaf is a view into it, scaled to its
fan-in (the embedding table to 0.02, the norms' scales drawn around 1, so
that a norm whose scale is dropped shows).
"""
from __future__ import annotations

import math

import torch

_CHUNK = 1 << 30
_ALIGN = 128


def layout(m: dict) -> list:
    """(name, shape, std, mean) of every leaf of a decoder-only MoE model,
    named as the program's ``state_dict``."""
    d, hq, hkv, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    e, f, v = m["n_experts"], m["d_ff"], m["vocab_size"]
    out = [("embed.table", (v, d), 0.02, 0.0),
           ("embed.head", (d, v), 1 / math.sqrt(d), 0.0),
           ("final_norm.scale", (d,), 0.1, 1.0)]
    for i in range(m["n_layers"]):
        p = f"layers.{i}."
        out += [(p + "norm_mixer.scale", (d,), 0.1, 1.0),
                (p + "attn.wq", (d, hq, hd), 1 / math.sqrt(d), 0.0),
                (p + "attn.wk", (d, hkv, hd), 1 / math.sqrt(d), 0.0),
                (p + "attn.wv", (d, hkv, hd), 1 / math.sqrt(d), 0.0),
                (p + "attn.wo", (hq, hd, d), 1 / math.sqrt(hq * hd), 0.0),
                (p + "norm_mlp.scale", (d,), 0.1, 1.0),
                (p + "moe.router", (d, e), 1 / math.sqrt(d), 0.0),
                (p + "moe.wi", (e, d, f), 1 / math.sqrt(d), 0.0),
                (p + "moe.wg", (e, d, f), 1 / math.sqrt(d), 0.0),
                (p + "moe.wo", (e, f, d), 1 / math.sqrt(f), 0.0)]
    return out


@torch.no_grad()
def make(m: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The weights of ``m`` for ``seed``: a dict of views into one buffer."""
    from perfbench.traffic import seed_words
    leaves = layout(m)
    offsets, n = [], 0
    for _, shape, _, _ in leaves:
        offsets.append(n)
        n += -(-math.prod(shape) // _ALIGN) * _ALIGN
    buf = torch.empty(n, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed_words(seed, 6).generate_state(2, "uint64")[0]))
    for i in range(0, n, _CHUNK):
        buf[i:i + _CHUNK].normal_(generator=gen)
    out = {}
    for (name, shape, std, mean), off in zip(leaves, offsets):
        t = buf[off:off + math.prod(shape)].view(shape)
        t.mul_(std).add_(mean)
        out[name] = t
    return out
