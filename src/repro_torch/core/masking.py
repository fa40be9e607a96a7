"""Binary-mask sparsity encoding (port of ``repro/core/masking.py``).

A dense vector is stored as its non-zeros collapsed to the front plus a
1-bit-per-element mask packed 32 per word: bit i of word w is element
``32*w + i``.  Mask words are ``torch.uint32``.  PyTorch implements no
shifts or adds on that dtype, so the bit arithmetic runs in int64 and
only the finished words are cast.

The bit and collapse functions also take a leading batch of blocks: the
last axis is the block, so one call covers all (layer, slot) blocks of a
KV leaf.  :class:`MaskedVector`, :func:`mask_encode` and
:func:`mask_decode` are the flat compressed form of paper Fig. 5, with its
storage accounting (:func:`compressed_bits`, :func:`compression_ratio`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MASK_WORD_BITS = 32


def _n_words(n: int) -> int:
    return (n + MASK_WORD_BITS - 1) // MASK_WORD_BITS


def pack_mask_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., n) bool -> (..., ceil(n/32)) uint32, bit i of word w = 32*w+i."""
    n = bits.shape[-1]
    pad = _n_words(n) * MASK_WORD_BITS - n
    b = torch.nn.functional.pad(bits.to(torch.int64), (0, pad))
    b = b.reshape(*bits.shape[:-1], -1, MASK_WORD_BITS)
    shifts = torch.arange(MASK_WORD_BITS, dtype=torch.int64, device=bits.device)
    return (b << shifts).sum(dim=-1).to(torch.uint32)


def unpack_mask_bits(words: torch.Tensor, length: int) -> torch.Tensor:
    """(..., w) uint32 -> (..., length) bool."""
    shifts = torch.arange(MASK_WORD_BITS, dtype=torch.int64, device=words.device)
    bits = (words.to(torch.int64)[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :length].to(torch.bool)


def collapse_to_front(flat: torch.Tensor, bits: torch.Tensor, capacity_len: int) -> torch.Tensor:
    """Fig. 7(c) zero-collapsing shifter as a cumsum-scatter along the last
    axis: elements whose ``bits`` are set move to the front of a
    ``capacity_len`` buffer; dead and overflow elements drop."""
    dest = torch.cumsum(bits.to(torch.int64), dim=-1) - 1
    dest = torch.where(bits, dest, capacity_len)
    out = torch.zeros(*flat.shape[:-1], capacity_len + 1, dtype=flat.dtype,
                      device=flat.device)
    # dead/overflow elements land in the extra column, which is cut off
    out.scatter_(-1, dest.clamp(max=capacity_len), flat)
    return out[..., :capacity_len]


def expand_from_mask(values: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`collapse_to_front` along the last axis; positions
    past the value buffer's capacity decode as zero."""
    cap = values.shape[-1]
    src = torch.cumsum(bits.to(torch.int64), dim=-1) - 1
    valid = bits & (src < cap)
    gathered = torch.gather(values, -1, src.clamp(0, cap - 1))
    return torch.where(valid, gathered, torch.zeros((), dtype=values.dtype,
                                                    device=values.device))


class MaskedVector(NamedTuple):
    """Binary-mask compressed tensor (flat).

    values:  (length,) float32, non-zeros collapsed to the front,
             zero-padded tail;
    mask:    (ceil(length/32),) uint32 packed position bits;
    nnz:     () int32 number of live values;
    length:  python int, the original dense length.
    """

    values: torch.Tensor
    mask: torch.Tensor
    nnz: torch.Tensor
    length: int


def mask_encode(x: torch.Tensor) -> MaskedVector:
    """Dense tensor -> flat binary-mask compressed form (fp32 values)."""
    x = x.reshape(-1).to(torch.float32)
    n = x.shape[0]
    bits = x != 0.0
    return MaskedVector(values=collapse_to_front(x, bits, n), mask=pack_mask_bits(bits),
                        nnz=bits.sum(dtype=torch.int32), length=n)


def mask_decode(mv: MaskedVector) -> torch.Tensor:
    """Compressed form -> dense (length,)."""
    return expand_from_mask(mv.values, unpack_mask_bits(mv.mask, mv.length))


def compressed_bits(mv: MaskedVector, value_bits: int) -> torch.Tensor:
    """Total storage bits of the compressed form (paper Fig. 5 accounting)."""
    return mv.nnz * value_bits + mv.length


def compression_ratio(mv: MaskedVector, value_bits: int) -> torch.Tensor:
    """Dense bits / compressed bits.  Fig. 5: 16 elems, 6 nnz, 16b -> 2.29x."""
    bits = compressed_bits(mv, value_bits).to(torch.float32)
    # a float32 division, as jnp's (``scalar / tensor`` would multiply by
    # the reciprocal)
    return torch.div(bits.new_tensor(mv.length * value_bits), bits)


def tile_occupancy(dense: torch.Tensor, tile_m: int, tile_n: int) -> torch.Tensor:
    """(M, N) -> (M/tile_m, N/tile_n) bool, True where the tile holds a
    non-zero: the tile-granular form of the mask AND, which the
    ``masked_matmul`` kernel uses to skip whole tiles.  M and N must be
    tile-divisible (callers pad)."""
    m, n = dense.shape
    if m % tile_m or n % tile_n:
        raise ValueError(f"tile_occupancy: {tuple(dense.shape)} not divisible into "
                         f"({tile_m}, {tile_n}) tiles")
    t = dense.reshape(m // tile_m, tile_m, n // tile_n, tile_n)
    return (t != 0.0).any(dim=3).any(dim=1)


def density(x: torch.Tensor) -> torch.Tensor:
    """Fraction of non-zero elements (1 - sparsity)."""
    return (x != 0.0).to(torch.float32).mean()
