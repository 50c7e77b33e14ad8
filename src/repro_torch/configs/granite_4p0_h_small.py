"""granite-4.0-h-small [hybrid] — 40L d4096 32H (GQA kv=8, head 128)
V100352 tied, Mamba-2 (128 heads x 64, state 128, 1 group, conv 4, chunk
256) in 36 layers and attention in layers 5, 15, 25 and 35 (i % 10 == 5),
no positional encoding, softmax scale 1/128; a MoE in every layer: 72
SwiGLU experts of width 768, top-10 (softmax over the ten chosen logits,
which is softmax, top-k, renormalised), plus a shared SwiGLU expert of
width 1536; embedding x 12, residual branches x 0.22, logits / 16, RMSNorm
eps 1e-5.  32.2 B parameters.
The port's one architecture without a copy in the reference: its fields
``attn_offset``, ``shared_d_ff``, ``position_embedding``, ``attn_scale``,
``embed_scale``, ``residual_scale`` and ``logit_divisor`` are the port's.
Mamba layers give O(1) decode state; the 4 attention layers keep full KV
caches => long_500k runs.
[https://huggingface.co/ibm-granite/granite-4.0-h-small/blob/main/config.json]
"""
from repro_torch.configs.base import ArchSpec
from repro_torch.models.config import ModelConfig

ARCH = ArchSpec(
    arch_id="granite-4.0-h-small",
    full=ModelConfig(
        name="granite-4.0-h-small", family="hybrid",
        n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
        d_ff=768, vocab_size=100352,
        attn_every=10, attn_offset=5,
        position_embedding="nope", attn_scale=0.0078125,
        n_experts=72, top_k=10, capacity_factor=7.2,
        shared_expert=True, shared_d_ff=1536,
        ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_head_dim=64,
        ssm_ngroups=1, ssm_chunk=256,
        mlp_act="silu", tie_embeddings=True, norm_eps=1e-5,
        embed_scale=12.0, residual_scale=0.22, logit_divisor=16.0,
        remat="full",
    ),
    smoke=ModelConfig(
        name="granite-smoke", family="hybrid",
        n_layers=8, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=32, vocab_size=512,
        attn_every=4, attn_offset=1,
        position_embedding="nope", attn_scale=0.0625,
        n_experts=12, top_k=4, capacity_factor=3.0,
        shared_expert=True, shared_d_ff=64,
        ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_head_dim=16,
        ssm_ngroups=1, ssm_chunk=16,
        mlp_act="silu", tie_embeddings=True, norm_eps=1e-5,
        embed_scale=12.0, residual_scale=0.22, logit_divisor=16.0,
        param_dtype="float32",
    ),
    long_500k_ok=True,
    source="https://huggingface.co/ibm-granite/granite-4.0-h-small",
)
