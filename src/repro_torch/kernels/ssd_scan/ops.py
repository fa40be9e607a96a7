"""Public wrapper for the SSD chunked scan (port of
``repro/kernels/ssd_scan/ops.py`` and ``ssd_kernel.py``).

``ssd_scan(x, dt, a, b, c, return_state=False)`` computes the Mamba-2 SSD
recurrence over x (B, S, H, P) with dt (B, S, H), a (H,) and b/c
(B, S, G, N); y comes back in x's dtype and, with ``return_state``, the
final (B, H, N, P) state in fp32 (the prefill -> decode cache handoff,
which the reference's Pallas kernel cannot give and its jnp form can).
A CUDA tensor launches the three kernels of ``csrc/ssd_scan.cu`` (one
counted launch per call) or raises; a CPU tensor runs
:func:`~repro_torch.kernels.ssd_scan.ref.ssd_scan_chunked`.

x, b and c are read through their strides (only the last axis must be
contiguous), so the model hands the kernel the views it splits off its
convolved projection without a copy.  A ragged S is handled inside the
kernel as the reference's padding with dt = 0, x = b = c = 0.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.ssd_scan.ref import CHUNK, ssd_scan_chunked, ssd_scan_reference

__all__ = ["ssd_scan", "ssd_scan_chunked", "ssd_scan_reference", "CHUNK"]

#: head dims (P) the CUDA kernels are instantiated for, and the largest state
HEAD_DIMS = (32, 64)
MAX_STATE = 256
_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda.load("ssd_scan")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ssd_scan_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, *([ll] * 12),
                                    p, p, p, p, p, p, p]
    lib.ssd_scan_launch.restype = i
    return lib


def _check(x, dt, a, b, c) -> None:
    if x.ndim != 4 or dt.ndim != 3 or a.ndim != 1 or b.ndim != 4 or c.ndim != 4:
        raise ValueError("ssd_scan: x (B,S,H,P), dt (B,S,H), a (H,), b/c (B,S,G,N)")
    bsz, s, h, _ = x.shape
    if (tuple(dt.shape) != (bsz, s, h) or tuple(a.shape) != (h,) or b.shape != c.shape
            or tuple(b.shape[:2]) != (bsz, s)):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"a {tuple(a.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)} disagree")
    if b.shape[2] == 0 or h % b.shape[2]:
        raise ValueError(f"ssd_scan: {h} heads do not divide into {b.shape[2]} groups")


def _launch(x, dt, a, b, c):
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"ssd_scan: CUDA takes fp32 or bf16 x/b/c of one dtype, got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"ssd_scan: CUDA takes fp32 dt and a, got {dt.dtype}, {a.dtype}")
    if any(t.device != x.device for t in (dt, a, b, c)):
        raise ValueError("ssd_scan: every operand must be on one CUDA device")
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if p not in HEAD_DIMS or not 1 <= n <= MAX_STATE:
        raise ValueError(f"ssd_scan: head_dim {p} not in {HEAD_DIMS} or d_state {n} "
                         f"not in [1, {MAX_STATE}]")
    x, dt, b, c = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, dt, b, c))
    a = a.contiguous()
    nc = -(-s // CHUNK)
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((bsz, h, n, p), **f32)
    if y.numel() == 0:
        return y, state.zero_()
    y_acc = y if x.dtype == torch.float32 else torch.empty(y.shape, **f32)
    cum = torch.empty((bsz, nc, h, CHUNK), **f32)
    chunk_decay = torch.empty((bsz, nc, h), **f32)
    chunk_state = torch.empty((bsz, nc, h, n, p), **f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        cuda.check(_lib().ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
            bsz, s, h, p, g, n, int(x.dtype == torch.bfloat16),
            *x.stride()[:3], *dt.stride(), *b.stride()[:3], *c.stride()[:3],
            y.data_ptr(), y_acc.data_ptr(), cum.data_ptr(), chunk_decay.data_ptr(),
            chunk_state.data_ptr(), state.data_ptr(), stream), "ssd_scan")
    ssd_scan.launches += 1
    return y, state


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, return_state: bool = False):
    """SSD scan: y (B,S,H,P) in x's dtype, and with ``return_state`` the
    final (B,H,N,P) fp32 state as well."""
    _check(x, dt, a, b, c)
    if x.is_cuda:
        y, state = _launch(x, dt, a, b, c)
    else:
        y, state = ssd_scan_chunked(x, dt, a, b, c, return_state=True)
    return (y, state) if return_state else y


#: kernel launches made by this wrapper, one per call of the three-kernel
#: scan (the CPU path counts nothing)
ssd_scan.launches = 0
