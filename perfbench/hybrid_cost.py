"""The hybrid served model's arithmetic (Granite-4.0-H: Mamba-2 and
attention mixers, a MoE with a shared expert in every layer, a tied head):
the operations and bytes each measured piece of work needs, counted as
:mod:`perfbench.cost` counts them, over real tokens and real context only
(no bucket pads, no idle decode lanes, no empty expert rows), from the
configuration's shapes and the traffic's lengths.

Kernel B6 (the SSD scan of one Mamba layer's prefill over n real tokens)
is bound by the larger of its operations at the bf16 peak and its bytes
at the HBM rate:

* operations, a multiply-add counted as 2: C_l . B_s over each causal pair
  (l, s) of a chunk, one plane a group (2 G N a pair); those scores times
  the inputs, every head (2 H P a pair); each token's part of its chunk's
  state and the state's part of each token's output (2 x 2 H P N a
  token); the state passed between chunks (2 H P N a chunk);
* bytes: x, B and C read and y written in bf16, dt read in float32, once
  each, the final state written once in bf16.
"""
from __future__ import annotations

from perfbench import cost
from perfbench.hybrid_weights import is_attention


def ssm_dims(m: dict) -> tuple:
    """(d_inner, heads H, head dim P, groups G, state N, chunk Q)."""
    di = m["ssm_expand"] * m["d_model"]
    return (di, di // m["ssm_head_dim"], m["ssm_head_dim"], m["ssm_ngroups"],
            m["ssm_state"], m["ssm_chunk"])


def layer_counts(m: dict) -> tuple[int, int]:
    """(attention layers, Mamba layers) of the configuration's depth."""
    attn = sum(is_attention(m, i) for i in range(m["n_layers"]))
    return attn, m["n_layers"] - attn


def chunk_pairs(n: int, q: int) -> int:
    """Causal pairs inside the chunks of q tokens over n real tokens."""
    full, rest = divmod(n, q)
    return full * q * (q + 1) // 2 + rest * (rest + 1) // 2


def scan_flops(m: dict, n: int) -> float:
    _, h, p, g, st, q = ssm_dims(m)
    return (2 * chunk_pairs(n, q) * (g * st + h * p) + 4 * n * h * p * st
            + 2 * -(-n // q) * h * p * st)


def scan_bytes(m: dict, n: int) -> float:
    _, h, p, g, st, _ = ssm_dims(m)
    return 2 * n * (2 * h * p + 2 * g * st) + 4 * n * h + 2 * h * p * st


def scan_bound_s(m: dict, n: int) -> float:
    """Least time of kernel B6 over one Mamba layer's n real tokens."""
    return max(scan_flops(m, n) / cost.PEAK_BF16_FLOP_S,
               scan_bytes(m, n) / cost.HBM_BYTES_S)


def mamba_params_per_token(m: dict) -> int:
    """Weights one token multiplies in a Mamba mixer: the five input
    projections and the out-projection."""
    d = m["d_model"]
    di, h, _, g, st, _ = ssm_dims(m)
    return d * (2 * di + 2 * g * st + h) + di * d


def attn_params_per_token(m: dict) -> int:
    d, hq, hkv, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    return d * hq * hd + 2 * d * hkv * hd + hq * hd * d


def moe_params_per_token(m: dict) -> int:
    """The router, the ``top_k`` routed experts and the shared expert."""
    d = m["d_model"]
    return (d * m["n_experts"] + m["top_k"] * 3 * d * m["d_ff"]
            + 3 * d * m["shared_d_ff"])


def prefill_flops(m: dict, n: int) -> float:
    """Operations a prefill of n real tokens needs: every layer's weights
    for each token, the conv, the SSD scan, the attention scores over each
    token's real context, and the head once (the last token's logits)."""
    attn, mamba = layer_counts(m)
    di, _, _, g, st, _ = ssm_dims(m)
    conv = 2 * m["ssm_conv"] * (di + 2 * g * st) * n
    per_mamba = 2 * mamba_params_per_token(m) * n + conv + scan_flops(m, n)
    per_attn = (2 * attn_params_per_token(m) * n + 4 * cost.causal_pairs(n)
                * m["n_heads"] * m["head_dim"])
    return (mamba * per_mamba + attn * per_attn
            + m["n_layers"] * 2 * moe_params_per_token(m) * n
            + 2 * m["d_model"] * m["vocab_size"])


def decode_flops(m: dict, positions) -> float:
    """Operations one decode wave needs for the live sequences at
    ``positions``: their tokens through every layer (a Mamba layer's state
    updated and read once) and the head."""
    attn, mamba = layer_counts(m)
    di, h, p, g, st, _ = ssm_dims(m)
    b = len(positions)
    ctx = sum(cost.context(pos) for pos in positions)
    per_mamba = b * (2 * mamba_params_per_token(m)
                     + 2 * m["ssm_conv"] * (di + 2 * g * st) + 4 * h * p * st)
    per_attn = (2 * attn_params_per_token(m) * b
                + 4 * ctx * m["n_heads"] * m["head_dim"])
    return (mamba * per_mamba + attn * per_attn
            + m["n_layers"] * 2 * moe_params_per_token(m) * b
            + 2 * m["d_model"] * m["vocab_size"] * b)
