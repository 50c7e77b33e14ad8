"""Synthetic LM data of the port (``repro/data``)."""
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline

__all__ = ["DataConfig", "SyntheticPipeline"]
