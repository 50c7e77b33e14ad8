"""Model configuration shared by the architectures (a copy of the
reference's ``repro/models/config.py`` plus the port's own fields).

One frozen dataclass describes every family (dense / MoE / SSM / hybrid /
enc-dec); per-arch config files in :mod:`repro_torch.configs` instantiate it with
the exact published numbers and a reduced smoke variant.

The port's own fields (``position_embedding``, ``attn_scale``,
``shared_d_ff``, ``attn_offset``, ``embed_scale``, ``residual_scale``,
``logit_divisor``) serve Granite-4.0-H; at their defaults each one is the
reference's behaviour and adds no operation to the model.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads

    # Attention pattern.
    attn_type: str = "full"           # full | swa | local_global
    sliding_window: int = 4096
    global_every: int = 6             # local:global: layer i is global iff
                                      # (i+1) % global_every == 0
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    position_embedding: str = "rope"  # rope | nope (no positional encoding)
    attn_scale: float = 0.0           # softmax scale; 0 -> 1 / sqrt(head_dim)

    # MLP.
    mlp_act: str = "silu"             # silu (SwiGLU) | gelu (GeGLU)

    # MoE.
    n_experts: int = 0
    top_k: int = 0
    shared_expert: bool = False
    shared_d_ff: int = 0              # the shared expert's width; 0 -> d_ff
    moe_every: int = 1                # layer i is MoE iff (i % moe_every)==moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba-2 / SSD).
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 256

    # Hybrid: layer i is attention iff i % attn_every == attn_offset %
    # attn_every (-1: the period's last layer, Jamba's; Granite-4.0-H: 5).
    attn_every: int = 0               # 0 -> no interleave (pure family)
    attn_offset: int = -1

    # Encoder-decoder.
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0

    # Embeddings / IO.
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    embed_scale: float = 0.0          # embedding multiplier; 0 -> sqrt(d_model)
    residual_scale: float = 1.0       # on both residual branches of a block
    logit_divisor: float = 1.0        # the LM head's logits are divided by it
    input_mode: str = "tokens"        # tokens | embeddings (audio stub)

    # Serving policy: ring (window-bounded) KV caches for SWA/local layers.
    # The serving engine disables rings when admitting right-padded prompts.
    serve_ring_caches: bool = True

    # Numerics & memory policy.
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "full"               # none | full   (training remat policy)
    loss_chunk: int = 0               # 0 = unchunked logits; else chunk tokens

    # Sharding profile name (the reference's repro.sharding.RULE_PROFILES;
    # the port has no sharding yet and only carries the field).
    sharding_profile: str = "auto"

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ------------------------------------------------------------- helpers
    @property
    def d_inner(self) -> int:
        """Mamba-2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def is_attn_layer(self, i: int) -> bool:
        """Hybrid interleave: which layers carry attention (vs Mamba)."""
        if self.family == "ssm":
            return False
        if self.family == "hybrid" and self.attn_every > 0:
            return (i % self.attn_every) == self.attn_offset % self.attn_every
        return True

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0:
            return False
        return (i % self.moe_every) == self.moe_offset

    def is_global_attn_layer(self, i: int) -> bool:
        """local:global interleave (gemma3): every Nth layer is global."""
        if self.attn_type != "local_global":
            return True
        return (i + 1) % self.global_every == 0

    def layer_kind(self, i: int) -> str:
        """Structural descriptor of layer i — drives the period-stack."""
        parts = []
        if self.is_attn_layer(i):
            if self.attn_type == "local_global":
                parts.append("gattn" if self.is_global_attn_layer(i) else "lattn")
            elif self.attn_type == "swa":
                parts.append("swa")
            else:
                parts.append("attn")
        else:
            parts.append("mamba")
        if self.is_moe_layer(i):
            parts.append("moe")
        elif self.d_ff > 0:
            parts.append("mlp")
        return "_".join(parts)

    def period(self) -> int:
        """Smallest repeating pattern length of layer kinds."""
        kinds = [self.layer_kind(i) for i in range(self.n_layers)]
        for p in range(1, self.n_layers + 1):
            if all(kinds[i] == kinds[i % p] for i in range(self.n_layers)):
                return p
        return self.n_layers

    # Counts for roofline MODEL_FLOPS = 6·N·D (N_active for MoE).
    def param_count(self) -> int:
        return _param_count(self, active_only=False)

    def active_param_count(self) -> int:
        return _param_count(self, active_only=True)


def _attn_params(cfg: ModelConfig) -> int:
    hd = cfg.head_dim
    q = cfg.d_model * cfg.n_heads * hd
    kv = 2 * cfg.d_model * cfg.n_kv_heads * hd
    o = cfg.n_heads * hd * cfg.d_model
    bias = (cfg.n_heads + 2 * cfg.n_kv_heads) * hd if cfg.qkv_bias else 0
    return q + kv + o + bias


def _ffn_params(cfg: ModelConfig, d_ff: int = 0) -> int:
    return 3 * cfg.d_model * (d_ff or cfg.d_ff)   # gated MLP: up, gate, down


def _mamba_params(cfg: ModelConfig) -> int:
    di, ns, ng = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups
    conv_dim = di + 2 * ng * ns
    in_proj = cfg.d_model * (2 * di + 2 * ng * ns + cfg.ssm_heads)
    conv = conv_dim * cfg.ssm_conv
    out_proj = di * cfg.d_model
    extras = 3 * cfg.ssm_heads + di          # A_log, D, dt_bias, norm
    return in_proj + conv + out_proj + extras


def _param_count(cfg: ModelConfig, active_only: bool) -> int:
    total = cfg.vocab_size * cfg.d_model
    if not cfg.tie_embeddings:
        total *= 2
    n_layers = cfg.n_layers + (cfg.n_enc_layers if cfg.is_encoder_decoder else 0)
    for i in range(cfg.n_layers):
        if cfg.is_attn_layer(i):
            total += _attn_params(cfg)
        else:
            total += _mamba_params(cfg)
        if cfg.is_moe_layer(i):
            n_live = (cfg.top_k if active_only else cfg.n_experts)
            total += n_live * _ffn_params(cfg)
            total += cfg.d_model * cfg.n_experts     # router
            if cfg.shared_expert:
                total += _ffn_params(cfg, cfg.shared_d_ff)
        else:
            total += _ffn_params(cfg)
        total += 2 * cfg.d_model                      # norms
    if cfg.is_encoder_decoder:
        for _ in range(cfg.n_enc_layers):
            total += _attn_params(cfg) + _ffn_params(cfg) + 2 * cfg.d_model
        # decoder cross-attention
        total += cfg.n_layers * (_attn_params(cfg) + cfg.d_model)
    return total
