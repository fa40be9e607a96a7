"""Numpy oracles for the binary-mask machinery (port of
``repro/kernels/mask_compress/ref.py``, unchanged): the *faithful*
element-serial Algorithm 1 from the paper (sequential scanning and
filtering mechanism), the zero-collapsing shifter, the whole pre-compute
module, and the mask-pack, dangling-filter, mask-unpack and stash
round-trip oracles.  They are test oracles, on no card path: the CPU
tests and ``benchmarks.bench_kernels --smoke --device cpu`` hold the
plain PyTorch versions against them.
"""

from __future__ import annotations

import numpy as np


def algorithm1_filter(
    in_data: np.ndarray, output_mask: np.ndarray, filter_mask: np.ndarray
) -> np.ndarray:
    """Verbatim Algorithm 1 (paper §3.1).

    in_data: the zero-free value stream of one operand (its non-zeros in
    order).  output_mask: dense AND-mask bits.  filter_mask: dense bits of
    this operand's dangling positions (own_mask XOR output_mask).
    Returns the stream with dangling entries zeroed in place (the
    zero-collapsing shifter then compacts it — ``collapse_zeros``).
    """
    out_data = np.zeros_like(in_data)
    data_pointer = 0
    for mask_pointer in range(len(output_mask)):
        if output_mask[mask_pointer] == 1:
            out_data[data_pointer] = in_data[data_pointer]
            data_pointer += 1
        elif filter_mask[mask_pointer] == 1:
            out_data[data_pointer] = 0
            data_pointer += 1
    return out_data


def collapse_zeros(stream: np.ndarray) -> np.ndarray:
    """Fig. 7(c) zero-collapsing shifter, element-serial."""
    out = np.zeros_like(stream)
    p = 0
    for v in stream:
        if v != 0:
            out[p] = v
            p += 1
    return out


def precompute_module_reference(a_dense: np.ndarray, w_dense: np.ndarray):
    """Full pre-compute sparsity module, element-serial (oracle).

    Returns (a_matched, w_matched, out_mask_bits): aligned zero-free
    streams (padded with zeros to dense length) + the AND mask.
    """
    a_dense = np.asarray(a_dense, np.float32)
    w_dense = np.asarray(w_dense, np.float32)
    a_bits = (a_dense != 0).astype(np.int32)
    w_bits = (w_dense != 0).astype(np.int32)
    out_bits = a_bits & w_bits
    a_filter = a_bits ^ out_bits
    w_filter = w_bits ^ out_bits
    a_stream = np.concatenate([a_dense[a_dense != 0], np.zeros(len(a_dense) - (a_dense != 0).sum(), np.float32)])
    w_stream = np.concatenate([w_dense[w_dense != 0], np.zeros(len(w_dense) - (w_dense != 0).sum(), np.float32)])
    a_matched = collapse_zeros(algorithm1_filter(a_stream, out_bits, a_filter))
    w_matched = collapse_zeros(algorithm1_filter(w_stream, out_bits, w_filter))
    return a_matched, w_matched, out_bits


def mask_pack_reference(x: np.ndarray) -> np.ndarray:
    """(R, C) -> (R, C/32) uint32, bit i of word w = element 32*w+i."""
    r, c = x.shape
    bits = (x != 0).astype(np.uint32).reshape(r, c // 32, 32)
    shifts = np.arange(32, dtype=np.uint32)
    return (bits << shifts).sum(axis=2).astype(np.uint32)


def dangling_filter_reference(a: np.ndarray, w: np.ndarray):
    joint = (a != 0) & (w != 0)
    return np.where(joint, a, 0).astype(np.float32), np.where(joint, w, 0).astype(np.float32)


def mask_unpack_reference(words: np.ndarray, length: int) -> np.ndarray:
    """(W,) uint32 packed words -> (length,) {0,1} bits (mask_pack inverse)."""
    shifts = np.arange(32, dtype=np.uint32)
    bits = (words[:, None] >> shifts) & np.uint32(1)
    return bits.reshape(-1)[:length].astype(np.int32)


def stash_roundtrip_reference(x: np.ndarray) -> np.ndarray:
    """Element-serial memstash oracle: collapse non-zeros behind the packed
    mask, then re-expand — what ``memstash.compress``/``decompress`` do
    vectorized.  Returns the reconstructed dense array."""
    flat = x.reshape(-1)
    stream = np.zeros_like(flat)
    p = 0
    for v in flat:
        if v != 0:
            stream[p] = v
            p += 1
    bits = (flat != 0).astype(np.int32)
    out = np.zeros_like(flat)
    q = 0
    for i, b in enumerate(bits):
        if b:
            out[i] = stream[q]
            q += 1
    return out.reshape(x.shape)
