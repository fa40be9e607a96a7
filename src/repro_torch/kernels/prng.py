"""Counter-based PRNG (port of ``repro/kernels/prng.py``).

The murmur3/splitmix 32-bit finalizer of (counter, seed): a stateless
stream, identical bit for bit between the CUDA kernels' epilogues and
these plain versions.  PyTorch has no usable uint32 arithmetic (shifts and
adds are not implemented for ``torch.uint32``), so the uint32 math runs in
int64 masked to 32 bits.  Products are split into two 16-bit halves so no
intermediate leaves the int64 range: only the low 32 bits of a product
matter, and both partial products stay below 2**48.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mul32(z: torch.Tensor, c: int) -> torch.Tensor:
    """(z * c) mod 2**32 for z in [0, 2**32) without int64 overflow."""
    lo = z * (c & 0xFFFF)
    hi = (z * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def hash_uint32(counter: torch.Tensor, seed: int | torch.Tensor) -> torch.Tensor:
    """Full-avalanche 32-bit finalizer of (counter ^ seed-mixed) values.

    counter: any-shape integer tensor of uint32 element indices (values
    taken mod 2**32); seed: uint32 scalar.  Returns int64 holding uniform
    uint32 values, shaped like ``counter``.
    """
    seed_mix = (int(seed) & _M32) * 0x9E3779B9 & _M32
    z = (counter.to(torch.int64) + seed_mix) & _M32
    z = _mul32(z ^ (z >> 16), 0x7FEB352D)
    z = _mul32(z ^ (z >> 15), 0x846CA68B)
    return z ^ (z >> 16)


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 values (in int64) -> float32 uniform in [0, 1), 24-bit."""
    return (bits.to(torch.int64) >> 8).to(torch.float32) * (1.0 / (1 << 24))
