"""The stash storage format (port of ``repro/memstash/format.py``).

A :class:`StashedActivation` holds

  values — (capacity_len,) original dtype: non-zeros collapsed to the
           front, zero-padded tail;
  mask   — (ceil(n/32),) uint32 packed occupancy bits (1 bit/element);
  nnz    — () int32 live-value count;

plus the shape and dtype.  The layout is the reference's bit for bit
(values, mask words and nnz).  At the default capacity (the dense length)
a round trip is exact for any dtype; the one canonicalization is
``-0.0 -> +0.0``.  Below it the value buffer holds ``ceil(n * capacity)``
values: live values past the buffer (``overflow``) decode as zero.
Packing runs in plain torch, as the reference's does in jnp.

Byte accounting: logical bytes (the dense tensor at its dtype) and wire
bytes (the stored live values at ``value_bits`` each + one mask bit per
element, the perfmodel's ``bits/elem = value_bits * density + 1`` at the
measured density).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.masking import (
    MASK_WORD_BITS,
    collapse_to_front,
    expand_from_mask,
    pack_mask_bits,
    unpack_mask_bits,
)


#: bits per stored non-zero in the wire accounting (a Q4.16 value)
VALUE_BITS = 20


def formula_bits_per_elem(density: float, value_bits: int = VALUE_BITS):
    """Paper Fig. 5 traffic accounting: ``value_bits * density + 1``."""
    return value_bits * density + 1.0


@dataclasses.dataclass
class StashedActivation:
    """Binary-mask compressed tensor."""

    values: torch.Tensor
    mask: torch.Tensor
    nnz: torch.Tensor
    shape: tuple
    dtype: torch.dtype

    @property
    def n(self) -> int:
        return int(math.prod(self.shape))

    @property
    def capacity_len(self) -> int:
        return int(self.values.shape[0])

    @property
    def density(self) -> torch.Tensor:
        return self.nnz.to(torch.float32) / self.n

    @property
    def overflow(self) -> torch.Tensor:
        """Live values dropped because nnz exceeded the capacity buffer."""
        return torch.clamp(self.nnz - self.capacity_len, min=0)


def _capacity_len(n: int, capacity: float) -> int:
    return n if capacity >= 1.0 else max(1, int(math.ceil(n * capacity)))


def compress(x: torch.Tensor, capacity: float = 1.0) -> StashedActivation:
    """Dense tensor -> binary-mask compressed stash record."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    if n == 0:
        raise ValueError("cannot stash an empty tensor")
    bits = flat != 0
    return StashedActivation(
        values=collapse_to_front(flat, bits, _capacity_len(n, capacity)),
        mask=pack_mask_bits(bits),
        nnz=bits.sum().to(torch.int32),
        shape=tuple(x.shape),
        dtype=x.dtype,
    )


def decompress(sv: StashedActivation) -> torch.Tensor:
    """Compressed stash record -> dense tensor (bit-exact at capacity 1.0)."""
    bits = unpack_mask_bits(sv.mask, sv.n)
    return expand_from_mask(sv.values, bits).reshape(sv.shape)


# -- byte accounting ---------------------------------------------------------


def logical_bytes(sv: StashedActivation) -> float:
    """Dense footprint at the tensor's own dtype."""
    return float(sv.n * sv.values.element_size())


def dense_fp32_bytes(sv: StashedActivation) -> float:
    """Dense fp32 footprint — the paper's GPU-baseline comparison point."""
    return float(sv.n * 4)


def wire_bits(sv: StashedActivation, value_bits: int = VALUE_BITS) -> torch.Tensor:
    """Bits the memory interface moves: the stored live values + the packed
    mask words (``ceil(n/32)`` uint32s), the measured size of the
    representation rather than the formula."""
    mask_bits = sv.mask.shape[0] * MASK_WORD_BITS
    live = torch.clamp(sv.nnz, max=sv.capacity_len).to(torch.float32)
    return live * value_bits + mask_bits


def wire_bytes(sv: StashedActivation, value_bits: int = VALUE_BITS) -> torch.Tensor:
    return wire_bits(sv, value_bits) / 8.0
