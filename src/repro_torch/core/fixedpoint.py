"""Q(IL, FL) fixed-point grid (port of ``repro/core/fixedpoint.py``).

Quantized tensors are float32 values snapped to the grid
``q * 2**-FL``; float32 holds every Q4.16 grid point exactly.  The op
order (clip -> scale -> round -> x eps) is the reference's, so results
are bit-identical: ``torch.round`` rounds half to even like ``jnp.round``.

Serving only rounds to nearest.  The straight-through wrappers and the
threefry-driven ``quantize_stochastic`` belong to training and are not
ported yet.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class FixedPointFormat:
    """Q(IL, FL) signed fixed-point format; grid step ``eps = 2**-fl``,
    range ``[-2**il, 2**il - eps]``."""

    il: int = 4
    fl: int = 16

    @property
    def eps(self) -> float:
        return 2.0 ** (-self.fl)

    @property
    def max_value(self) -> float:
        return 2.0**self.il - self.eps

    @property
    def min_value(self) -> float:
        return -(2.0**self.il)

    @property
    def bits(self) -> int:
        """Storage bits per element (sign + IL + FL), as in the paper."""
        return 1 + self.il + self.fl


# The paper's Table-1 format.
SPRING_FORMAT = FixedPointFormat(il=4, fl=16)


def _clip_to_range(x: torch.Tensor, fmt: FixedPointFormat) -> torch.Tensor:
    return torch.clamp(x, fmt.min_value, fmt.max_value)


def quantize_nearest(x: torch.Tensor, fmt: FixedPointFormat = SPRING_FORMAT) -> torch.Tensor:
    """Deterministic round-to-nearest onto the Q(IL,FL) grid (paper Eq. 3)."""
    x = _clip_to_range(x.to(torch.float32), fmt)
    scaled = x * (2.0**fmt.fl)
    return torch.round(scaled) * fmt.eps


def quantize_stochastic_from_bits(
    random_bits: torch.Tensor, x: torch.Tensor, fmt: FixedPointFormat = SPRING_FORMAT
) -> torch.Tensor:
    """Stochastic rounding driven by external uint32 random bits (held in
    any integer dtype, shaped like ``x``) — the form the CUDA
    ``masked_matmul`` epilogue computes."""
    x = _clip_to_range(x.to(torch.float32), fmt)
    scaled = x * (2.0**fmt.fl)
    lo = torch.floor(scaled)
    frac = scaled - lo
    u = (random_bits.to(torch.int64) >> 8).to(torch.float32) * (1.0 / (1 << 24))
    rounded = lo + (u < frac).to(torch.float32)
    return _clip_to_range(rounded * fmt.eps, fmt)
