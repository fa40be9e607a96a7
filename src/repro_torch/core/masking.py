"""Binary-mask sparsity encoding (port of ``repro/core/masking.py``).

A dense vector is stored as its non-zeros collapsed to the front plus a
1-bit-per-element mask packed 32 per word: bit i of word w is element
``32*w + i``.  Mask words are ``torch.uint32``.  PyTorch implements no
shifts or adds on that dtype, so the bit arithmetic runs in int64 and
only the finished words are cast.

Every function here also takes a leading batch of blocks: the last axis
is the block, so one call covers all (layer, slot) blocks of a KV leaf.
"""

from __future__ import annotations

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
