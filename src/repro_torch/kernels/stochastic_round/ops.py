"""Public wrapper for the stochastic-rounding kernel (port of
``repro/kernels/stochastic_round/ops.py``).

``stochastic_round`` dispatches on the tensor's device: a CUDA tensor
launches the one-thread-per-element kernel in ``csrc/stochastic_round.cu``
(and counts one launch) or raises; a CPU tensor runs
:func:`~repro_torch.kernels.stochastic_round.ref.sr_reference`.  Both give
the reference's ``sr_reference`` bit for bit.  Every model-level SR site
of the port (``core.fixedpoint.quantize_stochastic``) runs on it.

``base`` and ``row_stride`` round a shard of a tensor split over the
``model`` axis with the whole tensor's counters (:func:`shard_counter`):
element (r, c) of the shard, seen as (rows, cols), takes counter ``base +
r * row_stride + c``, so the shard's result is the slice of the whole
tensor's.  The defaults (0, cols) are the flat index.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.stochastic_round.ref import sr_reference

__all__ = ["stochastic_round", "sr_reference", "shard_counter"]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda.load("stochastic_round")
    f = ctypes.c_float
    lib.stochastic_round_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_longlong, ctypes.c_uint, f, f, f, f,
                                            ctypes.c_ulonglong, ctypes.c_longlong,
                                            ctypes.c_ulonglong, ctypes.c_void_p]
    lib.stochastic_round_launch.restype = ctypes.c_int
    return lib


def shard_counter(full_shape, dim: int, lo: int) -> tuple[int, int]:
    """``(base, row_stride)`` of the shard of a ``full_shape`` tensor
    that starts at index ``lo`` along ``dim`` (its other dims whole), for a
    tensor seen as (rows, its last dim): the shard's first element's flat
    index in the whole tensor, and the whole tensor's row length."""
    full_shape = tuple(full_shape)
    cols = full_shape[-1] if full_shape else 1
    if dim == len(full_shape) - 1:
        return lo, cols
    inner = 1
    for n in full_shape[dim + 1:]:
        inner *= n
    return lo * inner, cols


def _launch(x: torch.Tensor, seed: int, il: int, fl: int, base: int,
            row_stride: int) -> torch.Tensor:
    x = x.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    eps = 2.0**-fl
    cols = x.shape[-1] if x.ndim else 1
    with cuda.on_device(x.device):
        cuda.check(_lib().stochastic_round_launch(
            x.data_ptr(), out.data_ptr(), x.numel(), int(seed) & 0xFFFFFFFF, 2.0**fl, eps,
            -(2.0**il), 2.0**il - eps, base, cols, row_stride, cuda.stream(x.device)),
            "stochastic_round")
    stochastic_round.launches += 1
    return out


def stochastic_round(x: torch.Tensor, seed: int, *, il: int = 4, fl: int = 16,
                     base: int = 0, row_stride: int | None = None) -> torch.Tensor:
    """SR of every element of ``x`` onto Q(il, fl); counter = flat index,
    or for a shard ``base + row * row_stride + col`` (the module docstring)."""
    cols = x.shape[-1] if x.ndim else 1
    row_stride = cols if row_stride is None else int(row_stride)
    if row_stride < cols or base < 0:
        raise ValueError(f"a shard's row_stride {row_stride} is below its row length {cols}, "
                         f"or its base {base} is negative")
    if x.is_cuda:
        return _launch(x, seed, il, fl, int(base), row_stride)
    return sr_reference(x, seed, il=il, fl=fl, base=int(base), row_stride=row_stride)


#: kernel launches made by this wrapper (the CPU path counts nothing)
stochastic_round.launches = 0
