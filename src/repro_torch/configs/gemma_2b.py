"""gemma-2b [dense] — 18L d2048 8H (MQA kv=1) dff16384 V256000,
GeGLU activation, head_dim=256.  [arXiv:2403.08295; hf]
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    arch_id="gemma-2b",
    full=ModelConfig(
        name="gemma-2b", family="dense",
        n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
        d_ff=16384, vocab_size=256000,
        mlp_act="gelu", tie_embeddings=True,
        loss_chunk=256, remat="full",
    ),
    smoke=ModelConfig(
        name="gemma-2b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=32,
        d_ff=128, vocab_size=512,
        mlp_act="gelu", tie_embeddings=True, param_dtype="float32",
    ),
    long_500k_ok=False,
    skip_reason="pure full attention: unbounded KV cache at 500k",
    source="arXiv:2403.08295; hf",
)
