"""mixtral-8x7b [moe] — 32L d4096 32H (GQA kv=8) dff14336 V32000,
MoE 8 experts top-2, sliding-window attention (W=4096, Mistral lineage).
SWA bounds the KV cache => long_500k runs with O(window) cache.
[arXiv:2401.04088; hf]
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    arch_id="mixtral-8x7b",
    full=ModelConfig(
        name="mixtral-8x7b", family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=32000,
        n_experts=8, top_k=2,
        attn_type="swa", sliding_window=4096,
        mlp_act="silu", rope_theta=1e6, tie_embeddings=False,
        remat="full",
    ),
    smoke=ModelConfig(
        name="mixtral-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=512,
        n_experts=4, top_k=2,
        attn_type="swa", sliding_window=16,
        mlp_act="silu", tie_embeddings=False, param_dtype="float32",
    ),
    long_500k_ok=True,
    source="arXiv:2401.04088; hf",
)
