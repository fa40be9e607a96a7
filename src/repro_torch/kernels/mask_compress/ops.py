"""Mask packing and the dangling-data filter (port of
``repro/kernels/mask_compress/ops.py``: the ``mask_pack``,
``mask_unpack`` and ``dangling_filter`` ops).

``mask_pack`` packs along the last axis, one block per row: (..., n)
values -> (..., ceil(n/32)) ``torch.uint32`` words, bit i of word w set iff
element ``32*w + i`` is non-zero.  A CUDA tensor (bf16, fp16 or fp32)
launches one kernel of ``csrc/mask_pack.cu`` for all blocks, on the route
:func:`plan` chooses, or raises; a CPU tensor runs
:func:`mask_pack_reference`.  The JAX op packs the flattened array (any
float, cast to fp32); a 1-D input here gives the same words, without the
kernel's lane padding.

``dangling_filter(a, w)`` is the paper's pre-compute filter (Figs. 7a/7b):
each operand keeps only the entries where both are non-zero.  A CUDA
tensor launches ``csrc/dangling_filter.cu`` (one pass over the flattened
operands, no padding) or raises; a CPU tensor runs
:func:`dangling_filter_reference`.  Outputs keep the inputs' dtype, as the
reference's oracle does (its Pallas route casts to fp32).

``mask_unpack`` is a shift-and-test on every backend (its Pallas
registrations aliased the jnp lowering), so it has only the plain form.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.core.masking import pack_mask_bits, unpack_mask_bits
from repro_torch.kernels import cuda, registry

#: bytes per value of the dtypes the mask_pack kernels take: 16-bit types
#: share one magnitude test (bits 0-14), fp32 its own (bits 0-30)
_ELEM_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.float16: 2}
#: the dangling filter's kernel is instantiated for these
_FILTER_DTYPES = (torch.float32, torch.bfloat16)
#: threads of a CTA on both routes, and the stream route's CTAs per SM
THREADS, STREAM_CTAS_PER_SM = 256, 4


class Plan(NamedTuple):
    route: str  # "stream" or "lane"
    ctas: int


@functools.cache
def plan(n_blocks: int, block_len: int, elem_bytes: int, aligned: bool, n_sms: int) -> Plan:
    """The kernel's route and grid for ``n_blocks`` blocks of ``block_len``
    values of ``elem_bytes`` bytes (``aligned``: the operand starts on a
    16-byte boundary).  ``stream`` where every block ends on a word
    boundary and the operand is aligned, so the blocks are one flat stream
    of 16-byte chunks: warp steps of 32 words, walked by at most
    :data:`STREAM_CTAS_PER_SM` CTAs per SM with a grid-stride loop (step s
    on warp s mod the grid's warps).  ``lane`` otherwise: one warp per
    word, in order.  Cached per shape: the wrapper asks on every call."""
    words = n_blocks * -(-block_len // 32)
    warps = THREADS // 32
    if block_len % 32 == 0 and aligned:
        steps = -(-words // 32)
        return Plan("stream", min(-(-steps // warps), n_sms * STREAM_CTAS_PER_SM))
    return Plan("lane", -(-words // warps))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda.load("mask_pack")
    lib.mask_pack_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                                     ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
    lib.mask_pack_launch.restype = ctypes.c_int
    return lib


@functools.cache
def _filter_lib() -> ctypes.CDLL:
    lib = cuda.load("dangling_filter")
    p = ctypes.c_void_p
    lib.dangling_filter_launch.argtypes = [p, p, p, p, ctypes.c_longlong, ctypes.c_int, p]
    lib.dangling_filter_launch.restype = ctypes.c_int
    return lib


def mask_pack_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version: (..., n) -> (..., ceil(n/32)) uint32 words."""
    return pack_mask_bits(x != 0)


def _launch(x: torch.Tensor, route: str | None = None) -> torch.Tensor:
    """The kernel on a card tensor (one counted launch), on the route
    :func:`plan` chooses; ``route="lane"`` forces the lane kernel on a
    stream-shaped operand (the card tests and ``chip_smoke.py`` time and
    check both routes on one input)."""
    elem = _ELEM_BYTES.get(x.dtype)
    if elem is None:
        raise TypeError(f"mask_pack: unsupported dtype {x.dtype} on CUDA")
    if not x.is_contiguous():
        x = x.contiguous()
    *lead, block_len = x.shape
    n_blocks, ptr, dev = math.prod(lead), x.data_ptr(), x.device
    p = plan(n_blocks, block_len, elem, ptr % 16 == 0 and route != "lane",
             cuda.sm_count(dev.index))
    if route is not None and route != p.route:
        raise ValueError(f"mask_pack: route {route!r} needs block_len % 32 == 0 and a "
                         f"16-byte aligned operand")
    out = torch.empty((*lead, -(-block_len // 32)), dtype=torch.uint32, device=dev)
    if p.ctas:
        with cuda.on_device(dev):
            cuda.check(_lib().mask_pack_launch(ptr, out.data_ptr(), n_blocks, block_len, elem,
                                               p.route == "stream", p.ctas, cuda.stream(dev)),
                       "mask_pack")
        mask_pack.launches += 1
    return out


def pack_words(x: torch.Tensor) -> torch.Tensor:
    """What :func:`mask_pack` returns, without its metric row (``kv_pack``
    notes its own, as the reference's does)."""
    if x.ndim == 0:
        raise ValueError("mask_pack: needs at least one axis")
    return _launch(x) if x.is_cuda else mask_pack_reference(x)


def mask_pack(x: torch.Tensor) -> torch.Tensor:
    """Packed occupancy words of every block (last axis) of ``x``."""
    words = pack_words(x)
    if registry.metrics_active():
        # wire bytes of the packed representation, one bit per element in
        # whole uint32 words (ceil(n/32)*4 for one block), from shapes alone
        registry.note_metric("mask_pack", wire_bytes=float(words.numel() * 4))
    return words


#: kernel launches made by this wrapper (the CPU path counts nothing)
mask_pack.launches = 0


def mask_unpack(words: torch.Tensor, length: int) -> torch.Tensor:
    """Packed words (..., w) -> (..., length) bool (``mask_pack`` inverse)."""
    return unpack_mask_bits(words, length)


def dangling_filter_reference(a: torch.Tensor, w: torch.Tensor):
    """Plain version of :func:`dangling_filter`: zero each operand where
    the other is zero, in each operand's own dtype.  Zeroing changes no
    product (it was already zero), which is why SPRING can skip them."""
    joint = (a != 0.0) & (w != 0.0)
    return torch.where(joint, a, 0.0), torch.where(joint, w, 0.0)


def _filter_launch(a: torch.Tensor, w: torch.Tensor):
    if a.dtype not in _FILTER_DTYPES or w.dtype != a.dtype:
        raise TypeError(f"dangling_filter: CUDA takes fp32 or bf16 operands of one dtype, got "
                        f"{a.dtype}, {w.dtype}")
    if w.device != a.device:
        raise ValueError(f"dangling_filter: a on {a.device}, w on {w.device}")
    a, w = a.contiguous(), w.contiguous()
    a_out, w_out = torch.empty_like(a), torch.empty_like(w)
    with cuda.on_device(a.device):
        cuda.check(_filter_lib().dangling_filter_launch(
            a.data_ptr(), w.data_ptr(), a_out.data_ptr(), w_out.data_ptr(), a.numel(),
            _ELEM_BYTES[a.dtype], cuda.stream(a.device)), "dangling_filter")
    dangling_filter.launches += 1
    return a_out, w_out


def dangling_filter(a: torch.Tensor, w: torch.Tensor):
    """Zero each operand where the other is zero (pre-compute filter)."""
    if a.shape != w.shape:
        raise ValueError(f"dangling_filter: shapes {tuple(a.shape)} and {tuple(w.shape)} differ")
    if a.is_cuda:
        return _filter_launch(a, w)
    return dangling_filter_reference(a, w)


#: kernel launches made by this wrapper (the CPU path counts nothing)
dangling_filter.launches = 0
