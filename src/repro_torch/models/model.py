"""Model assembly: the decoder-only LM (dense, MoE, Mamba-2 and hybrid
families) and the encoder-decoder (the port of ``repro/models/model.py``).

:func:`build_model` returns an ``nn.Module``:

* :class:`DecoderOnlyLM`
    init_weights(gen)                               random weights from a seed
    train_loss(batch) -> (loss, aux)                differentiable
    prefill(tokens, max_len, last_index) -> (last_logits, caches)
    decode_step(tokens, caches, position) -> (logits, caches)
    decode_capturable(batch_size) -> whether a CUDA graph can record it
    init_caches(batch_size, seq_len) -> zero caches
* :class:`EncoderDecoderLM` (seamless-m4t: stub frontend embeddings ->
  encoder -> decoder that cross-attends)
    train_loss(batch) -> (loss, aux)
    prefill(embeds, tokens, max_len) -> (last_logits, {"self", "cross"})
    decode_step(tokens, caches, position) -> (logits, caches)
    init_caches(batch_size, seq_len, enc_len) -> zero caches

``tokens`` are (B, S) integer tensors, ``embeds`` (B, S_enc, D) frame
embeddings.  A training batch is a dict: ``{"tokens", "labels"}`` of (B,
S), plus ``"embeds"`` for the audio frontend stub (which replaces the
decoder-only model's tokens in its embeddings mode, and is the
encoder-decoder's source).  ``train_loss`` runs the plain differentiable
path the reference trains through (see :meth:`Block.forward`) and launches
no kernel; ``prefill``/``decode_step`` serve under ``torch.no_grad()``
through the kernels.  Caches are a list with one dict per layer, updated in place by
``decode_step``: ``{"k", "v"}`` for attention (see
:mod:`repro_torch.models.attention`), ``{"conv_x", "conv_b", "conv_c",
"ssm"}`` for Mamba (see :mod:`repro_torch.models.ssm`), side by side in
the hybrid family's mixed stack; the encoder-decoder's are ``{"self":
[...], "cross": [...]}``, the cross caches the decoder layers' K/V of the
encoder output.

``param_specs()`` and ``cache_specs(seq_len)`` give the logical axis names
of the parameters and caches as flat dicts keyed by the reference's leaf
paths (``"stack/pos0/attn/wq"``, ``"main/pos0/attn/k"``; a stacked leaf's
names lead with "layers"), in :func:`repro_torch.models.convert.
group_params`'s order, so they compare leaf for leaf with the reference's
trees; :mod:`repro_torch.sharding` resolves them.  The embedding is
constrained by :func:`repro_torch.sharding.constrain_act` (the identity
unless a sharding context is installed).
"""
from __future__ import annotations

import collections

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_mod
from repro_torch.models import layers
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.blocks import Block, block_specs
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import Moe
from repro_torch.sharding import constrain_act


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _ordered(flat: dict) -> dict:
    """``flat`` in ``jax.tree_util``'s flatten order (sorted keys at every
    level), as :func:`repro_torch.models.convert.group_params` orders."""
    return {k: flat[k] for k in sorted(flat, key=lambda x: x.split("/"))}


def _stacked(spec: tuple) -> tuple:
    return ("layers",) + tuple(spec)



class _LM(nn.Module):
    """What both model classes share: the token embedding and LM head, the
    final norm, and the decoder's caches."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = layers.Embedding(cfg, device)
        self.final_norm = layers.RMSNorm(cfg.d_model, layers.dtype_of(cfg),
                                         device)

    @property
    def device(self) -> torch.device:
        return self.final_norm.scale.device

    def _spec_stacks(self) -> list[tuple[str, list[str], bool]]:
        """(leaf prefix, the kinds of its period's positions, cross-attends)
        of each stack, as the reference's period stacks group them."""
        cfg = self.cfg
        kinds = [cfg.layer_kind(p) for p in range(cfg.period())]
        if cfg.is_encoder_decoder:
            return [("encoder", ["encattn_mlp"], False),
                    ("decoder", kinds, True)]
        return [("stack", kinds, False)]

    def param_specs(self) -> dict:
        """Leaf path -> the logical axis names of that leaf (see the module
        docstring)."""
        cfg = self.cfg
        out = {f"embed/{k}": v
               for k, v in layers.embedding_specs(cfg).items()}
        for norm in ("final_norm", "enc_norm"):
            if hasattr(self, norm):
                out[f"{norm}/scale"] = layers.rmsnorm_specs()["scale"]
        for stack, kinds, cross in self._spec_stacks():
            for pos, kind in enumerate(kinds):
                specs = block_specs(cfg, kind, cross_attention=cross)
                for k, v in _flat(specs).items():
                    out[f"{stack}/pos{pos}/{k}"] = _stacked(v)
        return _ordered(out)

    def _self_cache_specs(self, prefix: str = "") -> dict:
        """The decoder's caches' names as the reference's ``{"main": {pos:
        stacked}, "tail": {pos: single}}`` paths."""
        cfg = self.cfg
        kinds = self._spec_stacks()[-1][1]
        tail = cfg.n_layers % len(kinds)
        out = {}
        for pos, kind in enumerate(kinds):
            spec = ({"mamba": ssm_mod.mamba_state_specs()}
                    if "mamba" in kind else
                    {"attn": attn_mod.cache_specs()})
            for k, v in _flat(spec).items():
                out[f"{prefix}main/pos{pos}/{k}"] = _stacked(v)
                if pos < tail:
                    out[f"{prefix}tail/pos{pos}/{k}"] = v
        return out

    def layer_cache_paths(self, i: int) -> tuple[str, int | None]:
        """Where decoder layer i's cache lives among :meth:`cache_specs`'
        paths: (the path prefix, e.g. ``"main/pos0/"``, the row of the
        stacked leaf or None for a tail leaf)."""
        cfg = self.cfg
        period = len(self._spec_stacks()[-1][1])
        n_full = cfg.n_layers // period
        if i < n_full * period:
            return f"main/pos{i % period}/", i // period
        return f"tail/pos{i - n_full * period}/", None

    def _stack(self, blocks, x: torch.Tensor,
               memory: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """The training blocks over x (B, S, D): (x, the summed float32 aux
        loss).  With ``cfg.remat == "full"`` each block keeps only its input
        and is recomputed in the backward pass."""
        positions = torch.arange(x.shape[1], device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for blk in blocks:
            if self.cfg.remat == "full":
                x, a = checkpoint(blk, x, positions, memory,
                                  use_reentrant=False)
            else:
                x, a = blk(x, positions, memory)
            aux = aux + a
        return x, aux

    def _loss(self, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x, self.cfg.norm_eps)
        return layers.chunked_lm_loss(self.embed, x,
                                      labels.to(self.device), self.cfg)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x, self.cfg.norm_eps)
        return self.embed.logits(x)

    def _decoder_caches(self, blocks, batch_size: int, seq_len: int) -> list:
        cfg = self.cfg
        dtype = layers.dtype_of(cfg, "compute")
        return [ssm_mod.init_state(cfg, batch_size, dtype, self.device)
                if blk.is_mamba else
                attn_mod.init_cache(cfg, batch_size, blk.kv.slots(seq_len),
                                    dtype, self.device)
                for blk in blocks]


class DecoderOnlyLM(_LM):
    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, device)
        self.layers = nn.ModuleList(
            Block(cfg, cfg.layer_kind(i), device) for i in range(cfg.n_layers))

    def init_weights(self, gen: torch.Generator) -> "DecoderOnlyLM":
        """Random weights with the reference's scales, drawn from ``gen``
        (on the model's device) in a fixed order."""
        self.embed.init_weights(gen)
        for blk in self.layers:
            blk.init_weights(gen)
        self.final_norm.init_weights(gen)
        return self

    def train_loss(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """(mean token cross-entropy, summed MoE load-balancing loss), both
        float32 scalars, differentiable in the parameters."""
        cfg = self.cfg
        if cfg.input_mode == "embeddings" and "embeds" in batch:
            x = batch["embeds"].to(self.device, layers.dtype_of(cfg,
                                                                "compute"))
        else:
            x = self.embed.embed(batch["tokens"].to(self.device))
        x, aux = self._stack(self.layers, constrain_act(x))
        return self._loss(x, batch["labels"]), aux

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_len: int | None = None,
                last_index: int | torch.Tensor | None = None
                ) -> tuple[torch.Tensor, list]:
        """Prefill; caches get capacity ``max_len`` (>= prompt length).

        ``last_index``: position whose logits to return (defaults to the
        final position; right-padded prompts pass their true last index,
        and the Mamba layers' states are those after it: the pads past it
        leave them as they were).  Returns (logits (B, 1, V), caches); the
        MoE layers' aux loss is not computed, as the reference drops it.
        """
        x = constrain_act(self.embed.embed(tokens.to(self.device)))
        s = x.shape[1]
        max_len = max_len or s
        idx = s - 1 if last_index is None else int(last_index)
        positions = torch.arange(s, device=x.device)
        caches = []
        for blk in self.layers:
            x, cache = blk.prefill(x, positions, max_len, length=idx + 1)
            caches.append(cache)
        return self._head(x[:, idx:idx + 1]), caches

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, caches: list,
                    position: int | torch.Tensor
                    ) -> tuple[torch.Tensor, list]:
        """One token per sequence, tokens (B, 1), at ``position`` (an int or
        a (B,) tensor).  The caches are written in place and returned."""
        x = self.embed.embed(tokens.to(self.device))
        for blk, cache in zip(self.layers, caches):
            x = blk.decode(x, cache, position)
        return self._head(x), caches

    def decode_capturable(self, batch_size: int) -> bool:
        """Whether a :meth:`decode_step` of ``batch_size`` sequences at a
        (B,) position tensor can be recorded in a CUDA graph: whether no
        layer of it waits on the host.  Only an MoE layer can
        (:meth:`Moe.capturable`)."""
        return all(m.capturable(batch_size) for m in self.modules()
                   if isinstance(m, Moe))

    def decode_keys(self, caches: list, position: np.ndarray) -> np.ndarray:
        """The keys a :meth:`decode_step` at ``position`` (host integers,
        one a sequence) has kernel B5 read for each sequence, summed over
        the layers (:meth:`Block.decode_reads`; layers that read alike are
        counted together)."""
        reads = collections.Counter(blk.decode_reads(cache)
                                    for blk, cache in zip(self.layers, caches))
        reads.pop(None, None)
        return sum((n * layout.keys(length, position)
                    for (layout, length), n in reads.items()),
                   np.zeros_like(position))

    def init_caches(self, batch_size: int, seq_len: int) -> list:
        """Zero caches shaped for decoding against a seq_len context."""
        return self._decoder_caches(self.layers, batch_size, seq_len)

    def cache_specs(self, seq_len: int) -> dict:
        """Cache leaf path -> logical axis names (the reference's
        ``cache_specs``; ``seq_len`` is kept for its signature)."""
        return _ordered(self._self_cache_specs())


class EncoderDecoderLM(_LM):
    """seamless-m4t style: precomputed frame embeddings (the speech
    frontend is a stub, as in the reference) -> an encoder of unmasked
    self-attention blocks -> ``enc_norm`` -> a causal decoder whose blocks
    cross-attend to the encoder output."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__(cfg, device)
        dtype = layers.dtype_of(cfg)
        self.encoder = nn.ModuleList(
            Block(cfg, "encattn_mlp", device)
            for _ in range(cfg.n_enc_layers))
        self.decoder = nn.ModuleList(
            Block(cfg, cfg.layer_kind(i), device, cross=True)
            for i in range(cfg.n_layers))
        self.enc_norm = layers.RMSNorm(cfg.d_model, dtype, device)

    def init_weights(self, gen: torch.Generator) -> "EncoderDecoderLM":
        """Random weights with the reference's scales, drawn from ``gen``
        (on the model's device) in a fixed order."""
        self.embed.init_weights(gen)
        for blk in (*self.encoder, *self.decoder):
            blk.init_weights(gen)
        self.enc_norm.init_weights(gen)
        self.final_norm.init_weights(gen)
        return self

    def train_loss(self, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Encode ``batch["embeds"]``, then the decoder over
        ``batch["tokens"]`` cross-attending to it: (mean token
        cross-entropy, summed aux loss), differentiable."""
        cfg = self.cfg
        x = batch["embeds"].to(self.device, layers.dtype_of(cfg, "compute"))
        x, _ = self._stack(self.encoder, x)
        memory = self.enc_norm(x, cfg.norm_eps)
        x = self.embed.embed(batch["tokens"].to(self.device))
        x, aux = self._stack(self.decoder, x, memory)
        return self._loss(x, batch["labels"]), aux

    @torch.no_grad()
    def encode(self, embeds: torch.Tensor) -> torch.Tensor:
        """Frame embeddings (B, S_enc, D) -> the encoder memory, normed."""
        x = embeds.to(self.device, layers.dtype_of(self.cfg, "compute"))
        positions = torch.arange(x.shape[1], device=x.device)
        for blk in self.encoder:
            x, _ = blk.prefill(x, positions, None)
        return self.enc_norm(x, self.cfg.norm_eps)

    @torch.no_grad()
    def prefill(self, embeds: torch.Tensor, tokens: torch.Tensor,
                max_len: int | None = None) -> tuple[torch.Tensor, dict]:
        """Encode the source, then prefill the decoder over the target
        prefix ``tokens`` (B, S); self caches get capacity ``max_len``.
        Returns (logits (B, 1, V) at the last position, {"self": [...],
        "cross": [...]})."""
        memory = self.encode(embeds)
        cross = [blk.cross.project_kv(memory) for blk in self.decoder]
        x = self.embed.embed(tokens.to(self.device))
        s = x.shape[1]
        max_len = max_len or s
        positions = torch.arange(s, device=x.device)
        caches = []
        for blk, kv in zip(self.decoder, cross):
            x, cache = blk.prefill(x, positions, max_len, memory_kv=kv)
            caches.append(cache)
        return self._head(x[:, -1:]), {"self": caches, "cross": cross}

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, caches: dict,
                    position: int | torch.Tensor
                    ) -> tuple[torch.Tensor, dict]:
        """One target token per sequence, tokens (B, 1), at ``position``.
        The self caches are written in place; the cross caches are read."""
        x = self.embed.embed(tokens.to(self.device))
        for blk, cache, kv in zip(self.decoder, caches["self"],
                                  caches["cross"]):
            x = blk.decode(x, cache, position, memory_kv=kv)
        return self._head(x), caches

    def init_caches(self, batch_size: int, seq_len: int,
                    enc_len: int | None = None) -> dict:
        """Zero caches: self caches for a seq_len target context, cross
        caches for ``enc_len`` (default seq_len) source frames."""
        cfg = self.cfg
        dtype = layers.dtype_of(cfg, "compute")
        return {"self": self._decoder_caches(self.decoder, batch_size,
                                             seq_len),
                "cross": [attn_mod.init_cache(cfg, batch_size,
                                              enc_len or seq_len, dtype,
                                              self.device)
                          for _ in self.decoder]}

    def cache_specs(self, seq_len: int) -> dict:
        """Cache leaf path -> logical axis names: ``self/...`` as the
        decoder-only model's, ``cross/...`` the cross K/V's."""
        out = self._self_cache_specs("self/")
        cross = attn_mod.cache_specs()
        tail = self.cfg.n_layers % len(self._spec_stacks()[-1][1])
        for pos in range(len(self._spec_stacks()[-1][1])):
            for k, v in cross.items():
                out[f"cross/main/pos{pos}/{k}"] = _stacked(v)
                if pos < tail:
                    out[f"cross/tail/pos{pos}/{k}"] = v
        return _ordered(out)


def model_class(cfg: ModelConfig) -> type:
    return EncoderDecoderLM if cfg.is_encoder_decoder else DecoderOnlyLM


def build_model(cfg: ModelConfig, device: str | torch.device = "cuda",
                seed: int = 0) -> DecoderOnlyLM | EncoderDecoderLM:
    """The model of ``cfg`` on ``device`` with random weights drawn from a
    ``torch.Generator`` seeded with ``seed`` (to load given weights, see
    :func:`repro_torch.models.convert.model_from_state_dict`).  On the
    ``meta`` device there are no values to draw: the model's parameters
    are shapes and types only."""
    dev = resolve_device(device)
    model = model_class(cfg)(cfg, dev)
    if dev.type == "meta":
        return model
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return model.init_weights(gen)
