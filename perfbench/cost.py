"""The yardstick's arithmetic: the card's datasheet peaks and the operations
and bytes each measured piece of work needs.

Every count is of what the algorithm needs for the inputs it was given:
real tokens and real context (no bucket pads, no idle decode lanes, no
capacity rows an expert leaves empty, no key tiles past a window), each
input byte read once and each output byte written once.  A later change
that drops padded work therefore raises a share and never pushes it past
100 %.  The counts come from the configuration's shapes and the traffic's
lengths, never from the program's own counters.

Provenance: the peaks are NVIDIA's H100 SXM datasheet (as in
``src/repro_torch/launch/roofline.py`` and ``chip_smoke.py``); the
attention bounds follow ``chip_smoke.py``'s attention bounds, counted over
real lengths.
"""
from __future__ import annotations

import math

#: NVIDIA H100 SXM datasheet rates (dense, no sparsity) at its 700 W limit.
PEAK_BF16_FLOP_S = 989e12
HBM_BYTES_S = 3.35e12


def attention_window(m: dict) -> int:
    """The keys a query may see at most: the sliding window of a windowed
    model, 0 (no limit) for full causal attention."""
    return int(m["sliding_window"]) if m.get("attn_type") == "swa" else 0


# ------------------------------------------------------------ attention
def causal_pairs(n: int, window: int = 0) -> int:
    """Query-key pairs of causal attention over n positions, each query
    seeing at most ``window`` keys (itself included; 0 = no window)."""
    if window <= 0 or n <= window:
        return n * (n + 1) // 2
    return window * (window + 1) // 2 + (n - window) * window


def context(position: int, window: int = 0) -> int:
    """Keys a token at ``position`` attends."""
    return position + 1 if window <= 0 else min(position + 1, window)


def prefill_attention_bound_s(m: dict, n: int) -> float:
    """Least time of one layer's prefill attention over n real tokens:
    its operations (QK^T and PV, 2 each a multiply-add) at the bf16 peak,
    against q, k, v read once and the output written once."""
    hq, hkv, d = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    ops = 4 * causal_pairs(n, attention_window(m)) * hq * d
    nbytes = 2 * n * d * (2 * hq + 2 * hkv)
    return max(ops / PEAK_BF16_FLOP_S, nbytes / HBM_BYTES_S)


def decode_attention_bound_s(m: dict, positions) -> float:
    """Least time of one layer's decode attention for the live sequences at
    ``positions``: each one's real, window-capped cache (k and v), its
    query and its output, each once, against the operations."""
    hq, hkv, d = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    ctx = sum(context(p, attention_window(m)) for p in positions)
    nbytes = 2 * (2 * ctx * hkv * d + 2 * len(positions) * hq * d)
    ops = 4 * ctx * hq * d
    return max(ops / PEAK_BF16_FLOP_S, nbytes / HBM_BYTES_S)


# ------------------------------------------------------------ MoE decoder
def matmul_params_per_token(m: dict) -> int:
    """Weights one token multiplies in one layer: the attention
    projections, the router and its ``top_k`` routed experts' gated MLPs."""
    d, hq, hkv, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    attn = d * hq * hd + 2 * d * hkv * hd + hq * hd * d
    return attn + d * m["n_experts"] + m["top_k"] * 3 * d * m["d_ff"]


def prefill_flops(m: dict, n: int) -> float:
    """Operations a prefill of n real tokens needs: every layer's weights
    for each token, the scores over each token's real context, and the LM
    head once (the logits of the last token)."""
    per_layer = (2 * matmul_params_per_token(m) * n
                 + 4 * causal_pairs(n, attention_window(m))
                 * m["n_heads"] * m["head_dim"])
    return m["n_layers"] * per_layer + 2 * m["d_model"] * m["vocab_size"]


def decode_flops(m: dict, positions) -> float:
    """Operations one decode wave needs for the live sequences at
    ``positions``: their tokens through every layer and the head."""
    ctx = sum(context(p, attention_window(m)) for p in positions)
    per_layer = (2 * matmul_params_per_token(m) * len(positions)
                 + 4 * ctx * m["n_heads"] * m["head_dim"])
    return (m["n_layers"] * per_layer
            + 2 * m["d_model"] * m["vocab_size"] * len(positions))
