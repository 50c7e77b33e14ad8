"""chameleon-34b [vlm] — 48L d8192 64H (GQA kv=8) dff22016 V65536,
early fusion: images are VQ-VAE tokens in the unified 65536 vocab, so the
backbone is a plain decoder-only LM; the image tokenizer is the stubbed
modality frontend (input_specs supplies token ids directly).
[arXiv:2405.09818; unverified]
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    arch_id="chameleon-34b",
    full=ModelConfig(
        name="chameleon-34b", family="dense",
        n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=22016, vocab_size=65536,
        mlp_act="silu", tie_embeddings=False,
        remat="full",
    ),
    smoke=ModelConfig(
        name="chameleon-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
        mlp_act="silu", tie_embeddings=False, param_dtype="float32",
    ),
    long_500k_ok=False,
    skip_reason="pure full attention: unbounded KV cache at 500k",
    source="arXiv:2405.09818; unverified",
)
