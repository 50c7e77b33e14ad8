"""The hybrid served model's weights (Granite-4.0-H: Mamba-2 and attention
mixers, a MoE with a shared expert in every layer, a tied head), made on
the device from the run's seed.

As :mod:`perfbench.weights`: one flat buffer in the served type filled
with standard normals by one generator on the card, each leaf a view into
it scaled to its fan-in, the norms' scales drawn around 1.  The Mamba
layers' per-head float32 leaves are drawn apart, in Mamba-2's own ranges so
that the random state neither explodes nor vanishes: A = -exp(a_log) with
exp(a_log) uniform in [1, 16], dt_bias the inverse softplus of a step
log-uniform in [0.001, 0.1], the skip D around 1.

The head is tied.  A table drawn at 1 / sqrt(d_model) makes the input
token's own row, times ``embed_scale``, outweigh the layers' branches
(times ``residual_scale``) in the residual stream, and the tied head then
serves each token's own id again whatever the mixers compute.  So the
table is drawn at :data:`TABLE_SCALE` / sqrt(d_model), where the token's
own row weighs about as much as the spread of the others' logits, and the
final norm's scale around ``logit_divisor`` / :data:`TABLE_SCALE`, so that
the logits (divided by ``logit_divisor``) have about unit scale, as an
untied head drawn at 1 / sqrt(d_model) gives them.
"""
from __future__ import annotations

import math

import torch

from perfbench import weights as weights_mod

#: The embedding table's std times sqrt(d_model) (see the module docstring).
TABLE_SCALE = 0.1


def is_attention(m: dict, i: int) -> bool:
    return i % m["attn_every"] == m["attn_offset"] % m["attn_every"]


def layout(m: dict) -> list:
    """(name, shape, std, mean) of every bf16 leaf, named as the program's
    ``state_dict``."""
    d, hq, hkv, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    e, f, fs, v = m["n_experts"], m["d_ff"], m["shared_d_ff"], m["vocab_size"]
    di = m["ssm_expand"] * d
    heads, gn, w = di // m["ssm_head_dim"], m["ssm_ngroups"] * m["ssm_state"], \
        m["ssm_conv"]
    head = m["logit_divisor"] / TABLE_SCALE
    out = [("embed.table", (v, d), TABLE_SCALE / math.sqrt(d), 0.0),
           ("final_norm.scale", (d,), 0.1 * head, head)]
    for i in range(m["n_layers"]):
        p = f"layers.{i}."
        out.append((p + "norm_mixer.scale", (d,), 0.1, 1.0))
        if is_attention(m, i):
            out += [(p + "attn.wq", (d, hq, hd), 1 / math.sqrt(d), 0.0),
                    (p + "attn.wk", (d, hkv, hd), 1 / math.sqrt(d), 0.0),
                    (p + "attn.wv", (d, hkv, hd), 1 / math.sqrt(d), 0.0),
                    (p + "attn.wo", (hq, hd, d), 1 / math.sqrt(hq * hd), 0.0)]
        else:
            q = p + "mamba."
            out += [(q + "in_z", (d, di), 1 / math.sqrt(d), 0.0),
                    (q + "in_x", (d, di), 1 / math.sqrt(d), 0.0),
                    (q + "in_b", (d, gn), 1 / math.sqrt(d), 0.0),
                    (q + "in_c", (d, gn), 1 / math.sqrt(d), 0.0),
                    (q + "in_dt", (d, heads), 1 / math.sqrt(d), 0.0),
                    (q + "conv_x_w", (w, di), 1 / math.sqrt(w), 0.0),
                    (q + "conv_x_b", (di,), 0.1, 0.0),
                    (q + "conv_b_w", (w, gn), 1 / math.sqrt(w), 0.0),
                    (q + "conv_b_b", (gn,), 0.1, 0.0),
                    (q + "conv_c_w", (w, gn), 1 / math.sqrt(w), 0.0),
                    (q + "conv_c_b", (gn,), 0.1, 0.0),
                    (q + "norm", (di,), 0.1, 1.0),
                    (q + "out_proj", (di, d), 1 / math.sqrt(di), 0.0)]
        out += [(p + "norm_mlp.scale", (d,), 0.1, 1.0),
                (p + "moe.router", (d, e), 1 / math.sqrt(d), 0.0),
                (p + "moe.wi", (e, d, f), 1 / math.sqrt(d), 0.0),
                (p + "moe.wg", (e, d, f), 1 / math.sqrt(d), 0.0),
                (p + "moe.wo", (e, f, d), 1 / math.sqrt(f), 0.0),
                (p + "moe.shared.wi", (d, fs), 1 / math.sqrt(d), 0.0),
                (p + "moe.shared.wg", (d, fs), 1 / math.sqrt(d), 0.0),
                (p + "moe.shared.wo", (fs, d), 1 / math.sqrt(fs), 0.0)]
    return out


@torch.no_grad()
def make(m: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The weights of ``m`` for ``seed``: views into one buffer, and each
    Mamba layer's float32 ``a_log``, ``dt_bias`` and ``d_skip``."""
    from perfbench.traffic import seed_words
    leaves = layout(m)
    offsets, n = [], 0
    for _, shape, _, _ in leaves:
        offsets.append(n)
        n += -(-math.prod(shape) // weights_mod._ALIGN) * weights_mod._ALIGN
    buf = torch.empty(n, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    words = seed_words(seed, 6).generate_state(2, "uint64")
    gen.manual_seed(int(words[0]))
    for i in range(0, n, weights_mod._CHUNK):
        buf[i:i + weights_mod._CHUNK].normal_(generator=gen)
    out = {}
    for (name, shape, std, mean), off in zip(leaves, offsets):
        t = buf[off:off + math.prod(shape)].view(shape)
        t.mul_(std).add_(mean)
        out[name] = t
    gen.manual_seed(int(words[1]))
    heads = m["ssm_expand"] * m["d_model"] // m["ssm_head_dim"]
    lo, hi = math.log(1e-3), math.log(1e-1)
    for i in range(m["n_layers"]):
        if is_attention(m, i):
            continue
        q = f"layers.{i}.mamba."
        u = torch.rand((3, heads), generator=gen, device=device)
        out[q + "a_log"] = torch.log1p(15.0 * u[0])
        step = torch.exp(lo + (hi - lo) * u[1])
        out[q + "dt_bias"] = step + torch.log(-torch.expm1(-step))
        out[q + "d_skip"] = 1.0 + 0.1 * (2.0 * u[2] - 1.0)
    return out
