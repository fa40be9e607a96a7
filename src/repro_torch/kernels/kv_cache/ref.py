"""Element-serial numpy oracles for the KV-cache block format (port of
``repro/kernels/kv_cache/ref.py``, unchanged): one flattened KV block is
its non-zeros collapsed to the front of a dense-length value buffer plus
one packed occupancy bit per element.  Test oracles for ``kv_pack`` /
``kv_unpack``, on no card path.
"""

from __future__ import annotations

import numpy as np


def kv_pack_reference(x: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """Flattened block -> (values, mask_words, nnz), element-serial.

    values keeps the block's own dtype and dense length (capacity = n, so
    the round trip is bit-exact); mask_words is ``ceil(n/32)`` uint32 with
    bit i of word w = element ``32*w + i``.
    """
    flat = np.asarray(x).reshape(-1)
    n = flat.shape[0]
    values = np.zeros_like(flat)
    p = 0
    for v in flat:
        if v != 0:
            values[p] = v
            p += 1
    bits = (flat != 0).astype(np.uint32)
    words = np.zeros(((n + 31) // 32,), np.uint32)
    for i, b in enumerate(bits):
        if b:
            words[i // 32] |= np.uint32(1) << np.uint32(i % 32)
    return values, words, p


def kv_unpack_reference(values: np.ndarray, words: np.ndarray, length: int) -> np.ndarray:
    """Inverse of :func:`kv_pack_reference` (flat dense block)."""
    out = np.zeros((length,), values.dtype)
    p = 0
    for i in range(length):
        if (words[i // 32] >> np.uint32(i % 32)) & np.uint32(1):
            out[i] = values[p]
            p += 1
    return out


def kv_wire_bits_reference(nnz: int, length: int, value_bits: int = 20) -> int:
    """Bits the SPRING memory interface moves for one packed block: 20-bit
    values for the live entries + the packed mask words actually stored."""
    return nnz * value_bits + ((length + 31) // 32) * 32
