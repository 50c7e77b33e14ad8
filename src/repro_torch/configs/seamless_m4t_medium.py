"""seamless-m4t-medium [audio] — enc-dec, 12+12L d1024 16H (kv=16) dff4096
V256206.  The speech frontend is a STUB per the brief: ``input_specs()``
supplies precomputed frame embeddings (B, S, d_model) to the encoder; the
text decoder cross-attends.  Decode shapes exercise the text decoder (it is
enc-DEC, not encoder-only, so decode runs).
[arXiv:2308.11596; hf]
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    arch_id="seamless-m4t-medium",
    full=ModelConfig(
        name="seamless-m4t-medium", family="encdec",
        n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
        d_ff=4096, vocab_size=256206,
        is_encoder_decoder=True, n_enc_layers=12,
        input_mode="embeddings",
        mlp_act="gelu", tie_embeddings=True,
        loss_chunk=256, remat="full",
    ),
    smoke=ModelConfig(
        name="seamless-smoke", family="encdec",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512,
        is_encoder_decoder=True, n_enc_layers=2,
        input_mode="embeddings",
        mlp_act="gelu", tie_embeddings=True, param_dtype="float32",
    ),
    long_500k_ok=False,
    skip_reason=("full attention enc-dec; a 500k-frame audio encode is also "
                 "outside the published model's domain"),
    source="arXiv:2308.11596; hf",
)
