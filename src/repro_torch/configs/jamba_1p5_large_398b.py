"""jamba-1.5-large-398b [hybrid] — 72L d8192 64H (GQA kv=8) dff24576 V65536,
attention:mamba 1:7 interleave (layer i is attention iff i%8==7), MoE 16
experts top-2 on every 2nd layer (Jamba's e=16 / top-2 / every-2 pattern).
Adaptation note: the Mamba mixer is Mamba-2 / SSD (the chunked form)
rather than Jamba's Mamba-1 selective scan — same state-space role, and the
chunks are matrix products.
Mamba layers give O(1) decode state; the 9 attention layers keep full KV
caches (linear per decoded token) => long_500k runs.
[arXiv:2403.19887; hf]
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    arch_id="jamba-1.5-large-398b",
    full=ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
        d_ff=24576, vocab_size=65536,
        attn_every=8,
        n_experts=16, top_k=2, moe_every=2, moe_offset=1,
        ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
        ssm_ngroups=1, ssm_chunk=256,
        mlp_act="silu", tie_embeddings=False,
        remat="full",
    ),
    smoke=ModelConfig(
        name="jamba-smoke", family="hybrid",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=96, vocab_size=512,
        attn_every=4,
        n_experts=4, top_k=2, moe_every=2, moe_offset=1,
        ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_head_dim=16,
        ssm_ngroups=1, ssm_chunk=16,
        mlp_act="silu", tie_embeddings=False, param_dtype="float32",
    ),
    long_500k_ok=True,
    source="arXiv:2403.19887; hf",
)
