"""Public wrapper for the stochastic-rounding kernel (port of
``repro/kernels/stochastic_round/ops.py``).

``stochastic_round`` dispatches on the tensor's device: a CUDA tensor
launches the one-thread-per-element kernel in ``csrc/stochastic_round.cu``
(and counts one launch) or raises; a CPU tensor runs
:func:`~repro_torch.kernels.stochastic_round.ref.sr_reference`.  Both give
the reference's ``sr_reference`` bit for bit.  Every model-level SR site
of the port (``core.fixedpoint.quantize_stochastic``) runs on it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.stochastic_round.ref import sr_reference

__all__ = ["stochastic_round", "sr_reference"]


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda.load("stochastic_round")
    f = ctypes.c_float
    lib.stochastic_round_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                            ctypes.c_longlong, ctypes.c_uint, f, f, f, f,
                                            ctypes.c_void_p]
    lib.stochastic_round_launch.restype = ctypes.c_int
    return lib


def _launch(x: torch.Tensor, seed: int, il: int, fl: int) -> torch.Tensor:
    x = x.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    eps = 2.0**-fl
    with cuda.on_device(x.device):
        cuda.check(_lib().stochastic_round_launch(
            x.data_ptr(), out.data_ptr(), x.numel(), int(seed) & 0xFFFFFFFF, 2.0**fl, eps,
            -(2.0**il), 2.0**il - eps, cuda.stream(x.device)), "stochastic_round")
    stochastic_round.launches += 1
    return out


def stochastic_round(x: torch.Tensor, seed: int, *, il: int = 4, fl: int = 16) -> torch.Tensor:
    """SR of every element of ``x`` onto Q(il, fl); counter = flat index."""
    if x.is_cuda:
        return _launch(x, seed, il, fl)
    return sr_reference(x, seed, il=il, fl=fl)


#: kernel launches made by this wrapper (the CPU path counts nothing)
stochastic_round.launches = 0
