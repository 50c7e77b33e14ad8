"""Model zoo of the port: the dense, MoE and Mamba-2 decoder-only families
and the encoder-decoder on PyTorch (the hybrid family raises
``NotImplementedError`` naming its ROADMAP item)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (DecoderOnlyLM, EncoderDecoderLM,
                                      build_model)

__all__ = ["ModelConfig", "DecoderOnlyLM", "EncoderDecoderLM", "build_model"]
