"""qwen1.5-32b [dense] — 64L d5120 40H (GQA kv=40, i.e. full MHA KV)
dff27392 V152064, QKV bias.  [hf:Qwen/Qwen1.5-32B; hf]
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    arch_id="qwen1.5-32b",
    full=ModelConfig(
        name="qwen1.5-32b", family="dense",
        n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, head_dim=128,
        d_ff=27392, vocab_size=152064,
        qkv_bias=True, mlp_act="silu", tie_embeddings=False,
        loss_chunk=256, remat="full",
    ),
    smoke=ModelConfig(
        name="qwen1.5-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512,
        qkv_bias=True, mlp_act="silu", tie_embeddings=False,
        param_dtype="float32",
    ),
    long_500k_ok=False,
    skip_reason="pure full attention: unbounded KV cache at 500k",
    source="hf:Qwen/Qwen1.5-32B; hf",
)
