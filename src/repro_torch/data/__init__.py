"""Synthetic data pipelines (port of ``repro/data``)."""

from repro_torch.data.pipeline import (DataConfig, SyntheticImageTask, SyntheticLMStream,
                                       make_global_batch)

__all__ = ["DataConfig", "SyntheticImageTask", "SyntheticLMStream", "make_global_batch"]
