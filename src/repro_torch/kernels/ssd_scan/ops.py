"""Public wrapper for the SSD chunked scan (port of
``repro/kernels/ssd_scan/ops.py`` and ``ssd_kernel.py``).

``ssd_scan(x, dt, a, b, c, return_state=False)`` computes the Mamba-2 SSD
recurrence over x (B, S, H, P) with dt (B, S, H), a (H,) and b/c
(B, S, G, N); y comes back in x's dtype and, with ``return_state``, the
final (B, H, N, P) state in fp32 (the prefill -> decode cache handoff,
which the reference's Pallas kernel cannot give and its jnp form can).
A CUDA tensor launches the four stage kernels of ``csrc/ssd_scan.cu`` (one
counted launch per call) or raises; a CPU tensor runs
:func:`~repro_torch.kernels.ssd_scan.ref.ssd_scan_chunked`.  The kernels
have no backward (nor has the reference's Pallas kernel), so on the card
a call that autograd would need to differentiate raises instead of
dropping the gradient; the plain version stays differentiable.

Each stage kernel has its launcher here (``_scores``, ``_state``,
``_passing``, ``_scan``, on operands :func:`ssd_scan` has checked) and its
plain version in ``ref.py`` (``ssd_chunk_scores``, ``ssd_chunk_state``,
``ssd_state_passing``, ``ssd_chunk_scan``); the card tests and
``chip_smoke.py`` hold each launcher against its plain stage.

x, b and c are read through their strides (only the last axis must be
contiguous), so the model hands the kernel the views it splits off its
convolved projection without a copy.  A ragged S is handled inside the
kernels as the reference's padding with dt = 0, x = b = c = 0.
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
    lib.ssd_chunk_scores_launch.argtypes = [p, p, i, i, i, i, i, *([ll] * 6), p, p]
    lib.ssd_chunk_state_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, *([ll] * 9), p, p, p]
    lib.ssd_state_passing_launch.argtypes = [p, p, i, i, i, i, p, p, p]
    lib.ssd_chunk_scan_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, *([ll] * 9),
                                          p, p]
    for fn in (lib.ssd_chunk_scores_launch, lib.ssd_chunk_state_launch,
               lib.ssd_state_passing_launch, lib.ssd_chunk_scan_launch):
        fn.restype = i
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


def _check_cuda(x, dt, a, b, c) -> None:
    """What the kernels take: fp32 or bf16 x/b/c of one dtype, fp32 dt and
    a, one device, P in HEAD_DIMS, N up to MAX_STATE, and no gradient."""
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"ssd_scan: CUDA takes fp32 or bf16 x/b/c of one dtype, got "
                        f"{x.dtype}, {b.dtype}, {c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError(f"ssd_scan: CUDA takes fp32 dt and a, got {dt.dtype}, {a.dtype}")
    if any(t.device != x.device for t in (dt, a, b, c)):
        raise ValueError("ssd_scan: every operand must be on one CUDA device")
    p, n = x.shape[3], b.shape[3]
    if p not in HEAD_DIMS or not 1 <= n <= MAX_STATE:
        raise ValueError(f"ssd_scan: head_dim {p} not in {HEAD_DIMS} or d_state {n} "
                         f"not in [1, {MAX_STATE}]")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, dt, a, b, c)):
        raise ValueError("ssd_scan: the kernel forward has no gradient; "
                         "run it under torch.no_grad() or on plain tensors")


def _rows(*ts):
    """The operands with a contiguous last axis (views are kept)."""
    return tuple(t if t.stride(-1) == 1 else t.contiguous() for t in ts)


def _bf16(t) -> int:
    return int(t.dtype == torch.bfloat16)


# -- the four stages on the card ----------------------------------------------------


def _scores(b, c):
    bsz, s, g, n = b.shape
    cb = torch.empty((bsz, -(-s // CHUNK), g, CHUNK, CHUNK), dtype=torch.float32,
                     device=b.device)
    cuda.check(_lib().ssd_chunk_scores_launch(
        b.data_ptr(), c.data_ptr(), _bf16(b), bsz, s, g, n, *b.stride()[:3], *c.stride()[:3],
        cb.data_ptr(), cuda.stream(b.device)), "ssd_chunk_scores")
    return cb


def _state(x, dt, a, b):
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    nc = -(-s // CHUNK)
    st = torch.empty((bsz, nc, h, n, p), dtype=torch.float32, device=x.device)
    cum = torch.empty((bsz, nc, h, CHUNK), dtype=torch.float32, device=x.device)
    cuda.check(_lib().ssd_chunk_state_launch(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), _bf16(x), bsz, s, h, p, g, n,
        *x.stride()[:3], *dt.stride(), *b.stride()[:3], st.data_ptr(), cum.data_ptr(),
        cuda.stream(x.device)), "ssd_chunk_state")
    return st, cum


def _passing(st, cum):
    bsz, nc, h, n, p = st.shape
    h_prev = torch.empty_like(st)
    final = torch.empty((bsz, h, n, p), dtype=torch.float32, device=st.device)
    cuda.check(_lib().ssd_state_passing_launch(
        st.data_ptr(), cum.data_ptr(), bsz, nc, h, n * p, h_prev.data_ptr(), final.data_ptr(),
        cuda.stream(st.device)), "ssd_state_passing")
    return h_prev, final


def _scan(x, dt, c, cb, cum, h_prev):
    bsz, s, h, p = x.shape
    g, n = c.shape[2], c.shape[3]
    y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
    cuda.check(_lib().ssd_chunk_scan_launch(
        x.data_ptr(), dt.data_ptr(), c.data_ptr(), cb.data_ptr(), cum.data_ptr(),
        h_prev.data_ptr(), _bf16(x), bsz, s, h, p, g, n, *x.stride()[:3], *dt.stride(),
        *c.stride()[:3], y.data_ptr(), cuda.stream(x.device)), "ssd_chunk_scan")
    return y


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, return_state: bool = False):
    """SSD scan: y (B,S,H,P) in x's dtype, and with ``return_state`` the
    final (B,H,N,P) fp32 state as well."""
    _check(x, dt, a, b, c)
    if x.is_cuda:
        _check_cuda(x, dt, a, b, c)
        bsz, s, h, p = x.shape
        if x.numel() == 0:
            y = torch.empty((bsz, s, h, p), dtype=x.dtype, device=x.device)
            state = torch.zeros((bsz, h, b.shape[3], p), dtype=torch.float32, device=x.device)
        else:
            x, dt, b, c = _rows(x, dt, b, c)
            with cuda.on_device(x.device):
                cb = _scores(b, c)
                st, cum = _state(x, dt, a.contiguous(), b)
                h_prev, state = _passing(st, cum)
                y = _scan(x, dt, c, cb, cum, h_prev)
            ssd_scan.launches += 1
    else:
        y, state = ssd_scan_chunked(x, dt, a, b, c, return_state=True)
    return (y, state) if return_state else y


#: kernel launches made by this wrapper, one per call of the four-stage
#: scan (the CPU path counts nothing)
ssd_scan.launches = 0
