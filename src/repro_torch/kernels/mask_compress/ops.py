"""Mask packing (port of ``repro/kernels/mask_compress/ops.py``, the
``mask_pack`` / ``mask_unpack`` ops).

``mask_pack`` packs along the last axis, one block per row: (..., n)
values -> (..., ceil(n/32)) ``torch.uint32`` words, bit i of word w set iff
element ``32*w + i`` is non-zero.  A CUDA tensor launches the warp-ballot
kernel in ``csrc/mask_pack.cu`` (one launch for all blocks) or raises; a
CPU tensor runs :func:`mask_pack_reference`.  The JAX op packs the
flattened array; a 1-D input here gives the same words, without the
kernel's lane padding.

``mask_unpack`` is a shift-and-test on every backend (its Pallas
registrations aliased the jnp lowering), so it has only the plain form.
``dangling_filter`` is off the serving path and not ported yet.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.masking import pack_mask_bits, unpack_mask_bits
from repro_torch.kernels import cuda

_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda.load("mask_pack")
    lib.mask_pack_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    lib.mask_pack_launch.restype = ctypes.c_int
    return lib


def mask_pack_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: (..., n) -> (..., ceil(n/32)) uint32 words."""
    return pack_mask_bits(x != 0)


def _launch(x: torch.Tensor) -> torch.Tensor:
    if x.dtype not in _ELEM_BYTES:
        raise TypeError(f"mask_pack: unsupported dtype {x.dtype} on CUDA")
    lead, block_len = x.shape[:-1], x.shape[-1]
    x2 = x.contiguous().reshape(-1, block_len)
    n_words = -(-block_len // 32)
    with torch.cuda.device(x.device):
        out = torch.empty((x2.shape[0], n_words), dtype=torch.uint32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        cuda.check(_lib().mask_pack_launch(x2.data_ptr(), out.data_ptr(), x2.shape[0],
                                           block_len, _ELEM_BYTES[x.dtype], stream),
                   "mask_pack")
    mask_pack.launches += 1
    return out.reshape(*lead, n_words)


def mask_pack(x: torch.Tensor) -> torch.Tensor:
    """Packed occupancy words of every block (last axis) of ``x``."""
    if x.ndim == 0:
        raise ValueError("mask_pack: needs at least one axis")
    if x.is_cuda:
        return _launch(x)
    return mask_pack_reference(x)


#: kernel launches made by this wrapper (the CPU path counts nothing)
mask_pack.launches = 0


def mask_unpack(words: torch.Tensor, length: int) -> torch.Tensor:
    """Packed words (..., w) -> (..., length) bool (``mask_pack`` inverse)."""
    return unpack_mask_bits(words, length)
