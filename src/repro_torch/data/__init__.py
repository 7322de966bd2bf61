"""Synthetic training data: ``DataConfig`` and ``SyntheticPipeline``."""
from .pipeline import DataConfig, SyntheticPipeline

__all__ = ["DataConfig", "SyntheticPipeline"]
