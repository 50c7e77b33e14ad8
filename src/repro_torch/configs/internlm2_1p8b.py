"""internlm2-1.8b [dense] — 24L d2048 16H (GQA kv=8) dff8192 V92544.
[arXiv:2403.17297; hf]
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    arch_id="internlm2-1.8b",
    full=ModelConfig(
        name="internlm2-1.8b", family="dense",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=92544,
        mlp_act="silu", tie_embeddings=False, rope_theta=1e6,
        remat="full",
    ),
    smoke=ModelConfig(
        name="internlm2-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
        mlp_act="silu", tie_embeddings=False, param_dtype="float32",
    ),
    long_500k_ok=False,
    skip_reason="pure full attention: unbounded KV cache at 500k",
    source="arXiv:2403.17297; hf",
)
