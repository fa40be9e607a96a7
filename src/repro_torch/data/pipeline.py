"""Synthetic data pipelines (port of ``repro/data/pipeline.py``).

* :class:`SyntheticLMStream` — the reference's token stream bit for bit:
  ``batch(step)`` draws under ``fold_in(PRNGKey(seed), step)``, split three
  ways, ``randint`` / ``uniform`` / ``randint`` through the numpy threefry
  of :mod:`repro_torch.api.threefry`, and follows the permutation from
  ``np.random.default_rng(seed)``.  So both packages train on the same
  tokens and their losses compare.
* :class:`SyntheticImageTask` — Gaussian class prototypes plus noise,
  10-way classification, drawn from the task's own ``torch.Generator``s:
  the port does not reproduce ``jax.random.normal``, so parity tests feed
  both packages the reference's image batches as numpy arrays.

Both are pure functions of (seed, step), so a resumed run needs nothing
of the loader but its step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api import threefry
from repro_torch.kernels.prng import fold_in


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab: int = 512
    seq_len: int = 128
    global_batch: int = 8


class SyntheticLMStream:
    """Markov-ish token stream: next token = perm[prev], or with
    probability 0.1 a uniform token, so the cross-entropy floor is about
    0.1 log V and learning shows.  Batches are (global_batch, seq_len)
    int64 tensors on ``device`` (the reference's int32 values)."""

    def __init__(self, cfg: DataConfig, *, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.perm = np.random.default_rng(cfg.seed).permutation(cfg.vocab).astype(np.int32)

    def tokens(self, step: int) -> np.ndarray:
        """The reference's ``batch(step)`` as an int32 numpy array."""
        cfg = self.cfg
        key = threefry.fold_in(threefry.prng_key(cfg.seed), step)
        k1, k2, k3 = threefry.split(key, 3)
        rest_shape = (cfg.global_batch, cfg.seq_len - 1)
        first = threefry.randint(k1, (cfg.global_batch, 1), 0, cfg.vocab)
        noise = threefry.uniform(k2, rest_shape) < 0.1
        rand_tok = threefry.randint(k3, rest_shape, 0, cfg.vocab)
        out = np.empty((cfg.global_batch, cfg.seq_len), np.int32)
        out[:, 0] = tok = first[:, 0]
        for t in range(cfg.seq_len - 1):  # the reference's lax.scan over positions
            tok = np.where(noise[:, t], rand_tok[:, t], self.perm[tok])
            out[:, t + 1] = tok
        return out

    def batch(self, step: int) -> torch.Tensor:
        return torch.from_numpy(self.tokens(step).astype(np.int64)).to(self.device)


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


def make_global_batch(stream, step: int, n_shards: int = 1):
    """The host-global batch of ``step``; shard i's rows are the
    contiguous i-th of B / n_shards (the reference's layout).  The port
    runs on one device, so this is ``stream.batch(step)``."""
    return stream.batch(step)
