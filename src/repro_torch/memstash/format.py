"""The stash storage format (port of ``repro/memstash/format.py``).

A :class:`StashedActivation` holds

  values — (n,) original dtype: non-zeros collapsed to the front,
           zero-padded tail;
  mask   — (ceil(n/32),) uint32 packed occupancy bits (1 bit/element);
  nnz    — () int32 live-value count;

plus the shape and dtype.  The layout is the reference's bit for bit
(values, mask words and nnz), so a round trip is exact for any dtype; the one canonicalization is ``-0.0 -> +0.0``.  Packing runs in
plain torch, as the reference's does in jnp.

Byte accounting: logical bytes (the dense tensor at its dtype) and wire
bytes (``nnz * VALUE_BITS`` + one mask bit per element, the perfmodel's
``bits/elem = VALUE_BITS * density + 1`` at the measured density).  The
reference's lossy value buffer below full capacity is not ported.
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


def compress(x: torch.Tensor) -> StashedActivation:
    """Dense tensor -> binary-mask compressed stash record."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    if n == 0:
        raise ValueError("cannot stash an empty tensor")
    bits = flat != 0
    return StashedActivation(
        values=collapse_to_front(flat, bits, n),
        mask=pack_mask_bits(bits),
        nnz=bits.sum().to(torch.int32),
        shape=tuple(x.shape),
        dtype=x.dtype,
    )


def decompress(sv: StashedActivation) -> torch.Tensor:
    """Compressed stash record -> dense tensor (bit-exact)."""
    bits = unpack_mask_bits(sv.mask, sv.n)
    return expand_from_mask(sv.values, bits).reshape(sv.shape)


# -- byte accounting ---------------------------------------------------------


def logical_bytes(sv: StashedActivation) -> float:
    """Dense footprint at the tensor's own dtype."""
    return float(sv.n * sv.values.element_size())


def dense_fp32_bytes(sv: StashedActivation) -> float:
    """Dense fp32 footprint — the paper's GPU-baseline comparison point."""
    return float(sv.n * 4)


def wire_bits(sv: StashedActivation) -> torch.Tensor:
    """Bits the memory interface moves: data + the packed mask words."""
    mask_bits = sv.mask.shape[0] * MASK_WORD_BITS
    return sv.nnz.to(torch.float32) * VALUE_BITS + mask_bits


def wire_bytes(sv: StashedActivation) -> torch.Tensor:
    return wire_bits(sv) / 8.0
