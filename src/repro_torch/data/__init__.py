"""Synthetic token pipeline (a copy of the reference's ``repro.data``)."""
from repro_torch.data.pipeline import DataConfig, TokenPipeline

__all__ = ["DataConfig", "TokenPipeline"]
