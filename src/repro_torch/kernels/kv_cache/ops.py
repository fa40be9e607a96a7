"""KV-cache block compression: ``kv_pack`` / ``kv_unpack`` (port of
``repro/kernels/kv_cache/ops.py``).

A KV block is stored as its non-zeros collapsed to the front of a
dense-length value buffer (values kept verbatim in the block's dtype) plus
one packed occupancy bit per element.  Both functions work along the last
axis, so one call packs every (layer, slot) block of a cache leaf: the
mask words come from one ``mask_pack`` kernel launch on CUDA, the value
collapse is a torch cumsum + scatter (it never was a Pallas kernel,
``repro/kernels/mask_compress/mc_kernel.py:12-15``).
:func:`kv_pack_reference` is the same with the plain mask pack.
``kv_unpack`` is plain torch on every device, as the reference's was.
"""

from __future__ import annotations

import torch

from repro_torch.core.masking import (
    MASK_WORD_BITS,
    _n_words,
    collapse_to_front,
    expand_from_mask,
    unpack_mask_bits,
)
from repro_torch.kernels import registry
from repro_torch.kernels.mask_compress.ops import mask_pack_reference, pack_words

#: SPRING storage width of one cached value on the RRAM interface
#: (IL4 + FL16 fixed point).
KV_VALUE_BITS = 20


def _pack(x: torch.Tensor, pack) -> dict:
    n = x.shape[-1]
    bits = x != 0
    return {
        "values": collapse_to_front(x, bits, n),
        "mask": pack(x),
        "nnz": bits.sum(dim=-1, dtype=torch.int32),
    }


def kv_pack(x: torch.Tensor) -> dict:
    """Blocks (..., n) -> {"values": (..., n) x.dtype, "mask": (...,
    ceil(n/32)) uint32, "nnz": (...) int32}.  The only canonicalization is
    ``-0.0 -> +0.0`` (its occupancy bit is 0)."""
    packed = _pack(x, pack_words)
    if registry.metrics_active():
        # the reference's keys over every block of the call (one block: its
        # wire bytes and density); a device read, so only inside a recorder
        nnz = float(packed["nnz"].sum())
        registry.note_metric("kv_pack",
                             wire_bytes=(nnz * KV_VALUE_BITS
                                         + packed["mask"].numel() * MASK_WORD_BITS) / 8.0,
                             density=nnz / float(x.numel()))
    return packed


def kv_pack_reference(x: torch.Tensor) -> dict:
    """Plain version of :func:`kv_pack` (the mask words from
    ``mask_pack_reference``)."""
    return _pack(x, mask_pack_reference)


def kv_unpack(values: torch.Tensor, mask: torch.Tensor, length: int) -> torch.Tensor:
    """Packed blocks -> dense (..., length) (``kv_pack`` inverse)."""
    return expand_from_mask(values, unpack_mask_bits(mask, length))


def kv_wire_bits(nnz, length: int, value_bits: int = KV_VALUE_BITS):
    """Bits the memory interface moves for one packed block: live values at
    the 20-bit SPRING width + the mask words actually stored."""
    return nnz * value_bits + _n_words(length) * MASK_WORD_BITS
