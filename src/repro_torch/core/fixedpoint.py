"""Q(IL, FL) fixed-point grid (port of ``repro/core/fixedpoint.py``).

Quantized tensors are float32 values snapped to the grid
``q * 2**-FL``; float32 holds every Q4.16 grid point exactly.  The op
order (clip -> scale -> round -> x eps) is the reference's, so results
are bit-identical: ``torch.round`` rounds half to even like ``jnp.round``.

Stochastic rounding (:func:`quantize_stochastic`) runs the
``stochastic_round`` kernel with a 32-bit seed drawn from an explicit
``torch.Generator``.  The reference draws its uniforms from
``jax.random`` (threefry, ``fixedpoint.py:90``); the port does not
reproduce that stream and is held to it statistically (unbiased within
CLT bounds, P(round up) = frac).  The straight-through wrappers are
``torch.autograd.Function``s whose gradient is the in-range mask.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.kernels.stochastic_round.ops import stochastic_round


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
# Wider accumulator format (2x(IL+FL), the paper's MAC-lane internal width).
SPRING_ACCUM_FORMAT = FixedPointFormat(il=8, fl=32)


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


def quantize_stochastic(gen: torch.Generator, x: torch.Tensor,
                        fmt: FixedPointFormat = SPRING_FORMAT,
                        counter: tuple[int, int] | None = None) -> torch.Tensor:
    """Stochastic rounding onto the Q(IL,FL) grid (paper Eq. 4): round up
    with probability equal to the fractional part, so E[Round(x)] = x for
    in-range x.  Draws one 32-bit seed from ``gen`` and runs
    ``stochastic_round`` (the CUDA kernel on the card).  ``counter`` is a
    shard's ``(base, row_stride)`` (``stochastic_round.shard_counter``): the
    shard then draws the whole tensor's uniforms at its elements."""
    seed = int(torch.randint(0, 2**32, (1,), generator=gen, dtype=torch.int64))
    base, row_stride = counter if counter is not None else (0, None)
    return stochastic_round(x, seed, il=fmt.il, fl=fmt.fl, base=base, row_stride=row_stride)


class _StraightThrough(torch.autograd.Function):
    """Forward: ``round_fn(x)``.  Backward: the gradient where x was in
    range, zero where it was clipped (the reference's custom_vjp)."""

    @staticmethod
    def forward(ctx, x, round_fn, fmt):
        # the mask is kept only when a gradient is wanted (serving runs
        # these wrappers too)
        keep = (x >= fmt.min_value) & (x <= fmt.max_value) if ctx.needs_input_grad[0] else None
        ctx.save_for_backward(keep)
        return round_fn(x)

    @staticmethod
    def backward(ctx, g):
        (keep,) = ctx.saved_tensors
        return torch.where(keep, g, 0.0), None, None


def ste_quantize_nearest(x: torch.Tensor, fmt: FixedPointFormat = SPRING_FORMAT) -> torch.Tensor:
    """:func:`quantize_nearest` with the straight-through gradient."""
    return _StraightThrough.apply(x, lambda v: quantize_nearest(v, fmt), fmt)


def ste_quantize_stochastic(gen: torch.Generator, x: torch.Tensor,
                            fmt: FixedPointFormat = SPRING_FORMAT,
                            counter: tuple[int, int] | None = None) -> torch.Tensor:
    """:func:`quantize_stochastic` with the straight-through gradient."""
    return _StraightThrough.apply(x, lambda v: quantize_stochastic(gen, v, fmt, counter), fmt)


def to_int(x: torch.Tensor, fmt: FixedPointFormat = SPRING_FORMAT) -> torch.Tensor:
    """Grid-snapped float -> raw int32 (``q`` such that ``x = q * eps``)."""
    return torch.round(x.to(torch.float32) * (2.0**fmt.fl)).to(torch.int32)


def from_int(q: torch.Tensor, fmt: FixedPointFormat = SPRING_FORMAT) -> torch.Tensor:
    return q.to(torch.float32) * fmt.eps


def quantization_noise_bound(fmt: FixedPointFormat) -> float:
    """Worst-case |x - Round(x)| for either rounding mode (< eps)."""
    return fmt.eps


def pytree_quantize_stochastic(gen: torch.Generator, tree: Any, fmt: FixedPointFormat) -> Any:
    """SR-quantize every tensor leaf of a nested dict / list / tuple, each
    leaf from its own seed drawn from ``gen`` in the tree's walk order (the
    reference splits one key per leaf)."""
    if isinstance(tree, dict):
        return {k: pytree_quantize_stochastic(gen, v, fmt) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(pytree_quantize_stochastic(gen, v, fmt) for v in tree)
    return quantize_stochastic(gen, tree, fmt)
