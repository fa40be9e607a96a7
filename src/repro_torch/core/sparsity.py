"""Pre-/post-compute sparsity modules (port of ``repro/core/sparsity.py``;
SPRING P1, paper Figs. 6-7, Algorithm 1).

The pre-compute sparsity module takes compressed activations and weights
with their binary masks and produces *matched* zero-free operand streams
for the MAC lanes:

  1. mask generation (Fig. 7a): ``out = a_mask AND w_mask``; per-operand
     filter masks ``a_filter = a_mask XOR out``, ``w_filter = w_mask XOR out``.
  2. dangling-data filter (Fig. 7b / Algorithm 1): drop non-zeros whose
     partner at the same index is zero.
  3. zero-collapsing shifter (Fig. 7c): re-compact the filtered stream.

The post-compute sparsity module re-encodes outputs after the activation
function so data stays zero-free in on-chip memory.

These are the functional forms, in plain torch as the reference's are in
jnp.  The dense-domain filter, :func:`apply_joint_mask`, is the plain
version of the ``dangling_filter`` kernel
(``kernels/mask_compress/ops.py``), defined once there; the element-serial
Algorithm 1 oracle is ``kernels/mask_compress/ref.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.masking import (
    MaskedVector,
    collapse_to_front,
    mask_encode,
    pack_mask_bits,
    unpack_mask_bits,
)
from repro_torch.kernels.mask_compress.ops import dangling_filter_reference


class MatchedOperands(NamedTuple):
    """Output of the pre-compute sparsity module: aligned zero-free streams."""

    a_values: torch.Tensor  # (n,) float32, matched non-zeros collapsed to front
    w_values: torch.Tensor  # (n,) float32, aligned with a_values
    out_mask: torch.Tensor  # packed uint32 AND-mask
    n_matched: torch.Tensor  # () int32


def generate_masks(a_mask: torch.Tensor,
                   w_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fig. 7(a): output mask = AND; filter masks = XOR with the AND, all
    on packed uint32 words (the bitwise gates of the hardware).  The words
    are combined in int64: torch has no bitwise ops on uint32."""
    a, w = a_mask.to(torch.int64), w_mask.to(torch.int64)
    out = a & w
    return tuple(v.to(torch.uint32) for v in (out, a ^ out, w ^ out))


def _filter_and_collapse(values: torch.Tensor, own_mask_bits: torch.Tensor,
                         out_mask_bits: torch.Tensor) -> torch.Tensor:
    """Fig. 7(b)+(c) vectorized: drop dangling non-zeros, re-collapse.

    ``values`` is the zero-free stream of one operand, ``own_mask_bits``
    its dense position bits, ``out_mask_bits`` the AND bits.  An element
    of the stream survives iff its dense position is set in the AND mask.
    """
    n = own_mask_bits.shape[0]
    # position of each dense index inside the incoming zero-free stream
    src = torch.cumsum(own_mask_bits.to(torch.int64), 0) - 1
    dense_vals = torch.where(own_mask_bits, values[src.clamp(0, n - 1)], 0.0)
    # keep only AND-mask survivors, then collapse
    kept = torch.where(out_mask_bits, dense_vals, 0.0)
    return collapse_to_front(kept.to(torch.float32), out_mask_bits, n)


def precompute_sparsity(a: MaskedVector, w: MaskedVector) -> MatchedOperands:
    """The full pre-compute sparsity module on compressed operands."""
    if a.length != w.length:
        raise ValueError(f"precompute_sparsity: lengths {a.length} and {w.length} differ")
    out_words, _, _ = generate_masks(a.mask, w.mask)
    out_bits = unpack_mask_bits(out_words, a.length)
    a_bits = unpack_mask_bits(a.mask, a.length)
    w_bits = unpack_mask_bits(w.mask, w.length)
    return MatchedOperands(
        a_values=_filter_and_collapse(a.values, a_bits, out_bits),
        w_values=_filter_and_collapse(w.values, w_bits, out_bits),
        out_mask=out_words,
        n_matched=out_bits.sum(dtype=torch.int32),
    )


def sparse_dot(a: MaskedVector, w: MaskedVector) -> torch.Tensor:
    """Dot product evaluated entirely in the zero-free domain: equals
    ``mask_decode(a) @ mask_decode(w)`` but touches only matched non-zero
    pairs, the MAC-lane computation of the paper."""
    m = precompute_sparsity(a, w)
    return torch.dot(m.a_values, m.w_values)


def postcompute_sparsity(y: torch.Tensor) -> MaskedVector:
    """Post-compute sparsity module: re-encode after the activation fn."""
    return mask_encode(y)


def relu_then_encode(y: torch.Tensor) -> MaskedVector:
    """Common CNN path: ReLU creates the sparsity the encoder captures."""
    return postcompute_sparsity(torch.relu(y))


#: Dense-domain equivalent of the dangling-data filter: zero each operand
#: where the other is zero.  That changes no product (it was already
#: zero), which is exactly why SPRING can skip them; the returned values
#: are what the MAC lanes see.  One definition, the plain version of the
#: ``dangling_filter`` kernel.
apply_joint_mask = dangling_filter_reference


def mask_words_from_dense(x: torch.Tensor) -> torch.Tensor:
    """Packed occupancy mask of a dense tensor (flattened)."""
    return pack_mask_bits(x.reshape(-1) != 0.0)
