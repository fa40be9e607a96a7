"""Plain PyTorch version of the stochastic-rounding kernel (port of
``repro/kernels/stochastic_round/ref.py``, ``sr_reference``).

Bit-exact mirror of ``csrc/stochastic_round.cu`` and of the reference's
Pallas kernel: the counter is the flat element index, the hash is the
murmur3 finalizer of ``kernels/prng.py``, the uniform its top 24 bits,
and the clip/floor sequence is the same.  The reference pads the flat
array to whole (8, 1024) blocks before hashing; padding adds counters
past the end only, so the first ``n`` values do not depend on it.

A shard of a tensor split over the ``model`` axis takes the whole
tensor's counters: seen as (rows, cols), element (r, c) draws under
``base + r * row_stride + c`` (``ops.shard_counter``); the defaults give
the flat index.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.prng import hash_uint32, uniform_from_bits


def sr_reference(x: torch.Tensor, seed: int, *, il: int = 4, fl: int = 16, base: int = 0,
                 row_stride: int | None = None) -> torch.Tensor:
    flat = x.reshape(-1).to(torch.float32)
    cols = x.shape[-1] if x.ndim else 1
    eps = 2.0**-fl
    min_v, max_v = -(2.0**il), 2.0**il - eps
    xc = torch.clamp(flat, min_v, max_v)
    scaled = xc * (2.0**fl)
    lo = torch.floor(scaled)
    frac = scaled - lo
    counter = torch.arange(flat.shape[0], dtype=torch.int64, device=flat.device)
    if row_stride is not None and row_stride != cols:
        counter = counter // cols * row_stride + counter % cols
    counter = counter + base
    u = uniform_from_bits(hash_uint32(counter, seed))
    rounded = lo + (u < frac).to(torch.float32)
    return torch.clamp(rounded * eps, min_v, max_v).reshape(x.shape)
