"""gemma3-1b [dense] — 26L d1152 4H (GQA kv=1) dff6912 V262144,
5:1 local:global interleave (layer i global iff (i+1)%6==0 => globals at
5,11,17,23; 22 local layers with sliding window 512), head_dim=256.
Local layers keep O(window) ring caches; the 4 global layers keep the full
cache => long_500k is tractable (memory ≈ 4 global-layer caches).
[hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    arch_id="gemma3-1b",
    full=ModelConfig(
        name="gemma3-1b", family="dense",
        n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
        d_ff=6912, vocab_size=262144,
        attn_type="local_global", global_every=6, sliding_window=512,
        mlp_act="gelu", tie_embeddings=True, rope_theta=1e6,
        loss_chunk=256, remat="full",
    ),
    smoke=ModelConfig(
        name="gemma3-smoke", family="dense",
        n_layers=8, d_model=48, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=96, vocab_size=512,
        attn_type="local_global", global_every=3, sliding_window=16,
        mlp_act="gelu", tie_embeddings=True, param_dtype="float32",
    ),
    long_500k_ok=True,
    source="hf:google/gemma-3-1b-pt; unverified",
)
