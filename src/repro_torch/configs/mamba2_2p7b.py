"""mamba2-2.7b [ssm] — 64L d_model=2560, attention-free, d_ff=0,
ssm_state=128 (SSD).  d_inner=5120, head_dim=64 => 80 SSD heads, ngroups=1,
conv width 4, GPT-NeoX vocab 50280.  O(1) decode state => long_500k runs.
[arXiv:2405.21060; unverified]
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    arch_id="mamba2-2.7b",
    full=ModelConfig(
        name="mamba2-2.7b", family="ssm",
        n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
        ssm_ngroups=1, ssm_chunk=256,
        tie_embeddings=True, remat="full",
    ),
    smoke=ModelConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab_size=512,
        ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_head_dim=16,
        ssm_ngroups=1, ssm_chunk=16, param_dtype="float32",
    ),
    long_500k_ok=True,
    source="arXiv:2405.21060; unverified",
)
