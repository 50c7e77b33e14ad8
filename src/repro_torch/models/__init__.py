"""Model zoo of the port: the dense, MoE, Mamba-2 and hybrid decoder-only
families and the encoder-decoder on PyTorch."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (DecoderOnlyLM, EncoderDecoderLM,
                                      build_model)

__all__ = ["ModelConfig", "DecoderOnlyLM", "EncoderDecoderLM", "build_model"]
