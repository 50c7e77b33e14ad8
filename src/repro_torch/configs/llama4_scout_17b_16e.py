"""llama4-scout-17b-16e [moe] — 48L d5120 40H (GQA kv=8) dff8192 V202048,
MoE 16 experts top-1 + shared expert (the 17B-active arithmetic only closes
with the shared expert: 48·(63M attn + 2·126M ffn) + 2·1.03B embed ≈ 17B
active; ≈109B total — matching the public figures).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    arch_id="llama4-scout-17b-16e",
    full=ModelConfig(
        name="llama4-scout-17b-16e", family="moe",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=202048,
        n_experts=16, top_k=1, shared_expert=True,
        mlp_act="silu", rope_theta=500000.0, tie_embeddings=False,
        loss_chunk=256, remat="full",
    ),
    smoke=ModelConfig(
        name="llama4-scout-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=512,
        n_experts=4, top_k=1, shared_expert=True,
        mlp_act="silu", tie_embeddings=False, param_dtype="float32",
    ),
    long_500k_ok=False,
    skip_reason=("pure full attention in the published config (treated as "
                 "full-attention backbone): 500k decode needs an unbounded "
                 "full KV cache with no sub-quadratic mechanism"),
    source="hf:meta-llama/Llama-4-Scout-17B-16E; unverified",
)
