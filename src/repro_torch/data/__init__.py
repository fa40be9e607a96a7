"""Synthetic data pipelines (port of ``repro/data``, the image task)."""

from repro_torch.data.pipeline import DataConfig, SyntheticImageTask

__all__ = ["DataConfig", "SyntheticImageTask"]
