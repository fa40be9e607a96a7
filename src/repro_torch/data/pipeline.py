"""Synthetic image task (port of ``repro/data/pipeline.py``,
``SyntheticImageTask``; the LM stream comes with LM training).

Gaussian class prototypes plus noise, 10-way classification, a learnable
signal for the SR-vs-fp32 experiments.  ``batch(step)`` is a pure function
of (seed, step), drawn from the task's own ``torch.Generator``s: the port
does not reproduce ``jax.random``'s stream, so parity tests feed both
packages the reference's batches as numpy arrays.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels.prng import fold_in


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab: int = 512
    seq_len: int = 128
    global_batch: int = 8


class SyntheticImageTask:
    """Gaussian class prototypes + noise; 10-way classification.  Batches
    are made on the CPU and moved to ``device`` (NHWC fp32, int64 labels)."""

    def __init__(self, cfg: DataConfig, hw: int = 32, classes: int = 10, *, device="cpu"):
        self.cfg, self.hw, self.classes = cfg, hw, classes
        self.device = torch.device(device)
        gen = torch.Generator().manual_seed(cfg.seed + 7)
        self.prototypes = torch.randn((classes, hw, hw, 3), generator=gen) * 0.5

    def batch(self, step: int):
        cfg = self.cfg
        gen = torch.Generator().manual_seed(fold_in(cfg.seed + 13, step))
        labels = torch.randint(0, self.classes, (cfg.global_batch,), generator=gen)
        x = self.prototypes[labels] + torch.randn((cfg.global_batch, self.hw, self.hw, 3),
                                                  generator=gen)
        return x.to(self.device), labels.to(self.device)
