"""Model zoo of the port: the dense and Mamba-2 decoder-only families on
PyTorch (the other families raise ``NotImplementedError`` naming their
ROADMAP item)."""
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import (DecoderOnlyLM, EncoderDecoderLM,
                                      build_model)

__all__ = ["ModelConfig", "DecoderOnlyLM", "EncoderDecoderLM", "build_model"]
