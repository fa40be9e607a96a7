"""Public wrapper for flash attention (port of
``repro/kernels/flash_attention/ops.py``).

``flash_attention(q, k, v, *, causal, window)`` takes the reference's
layout, q (B, H, Sq, D) and k/v (B, HKV, Skv, D) with H % HKV == 0, and
returns (B, H, Sq, D) in q's dtype.  It dispatches on the tensors' device:
a CUDA tensor launches the kernel in ``csrc/flash_attention.cu`` (one
launch, counted) or raises; a CPU tensor runs
:func:`~repro_torch.kernels.flash_attention.ref.attention_reference`.
The kernel has no backward (nor has the reference's Pallas kernel), so on
the card a call that autograd would need to differentiate raises instead
of dropping the gradient; the plain version stays differentiable.

The kernel reads q/k/v through their strides (only the D axis must be
contiguous), so the model hands it transposed views of its (B, S, H, D)
projections without a copy, and the output is allocated in q's own layout.
Keys at index >= Skv never enter the softmax on either path: the kernel
masks its ragged last kv tile by index.  (The reference's Pallas route
pads Skv with zero keys and masks them only causally, so its non-causal
ragged case differs from its own oracle; the port follows the oracle.)
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.flash_attention.ref import attention_reference

__all__ = ["flash_attention", "attention_reference"]

#: head dims the CUDA kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda.load("flash_attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                           *([ll] * 12), i, i, ctypes.c_float, p]
    lib.flash_attention_launch.restype = i
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: Optional[int]) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D (B, H, S, D)")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if k.shape[1] == 0 or h % k.shape[1]:
        raise ValueError(f"flash_attention: {h} heads do not divide into {k.shape[1]} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")


def _launch(q, k, v, causal: bool, window: Optional[int]) -> torch.Tensor:
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: CUDA takes fp32 or bf16 q/k/v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)  # keeps q's layout when q is dense
    if out.numel() == 0:
        return out
    with cuda.on_device(q.device):
        cuda.check(_lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, hkv, sq, skv, d, int(q.dtype == torch.bfloat16),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            int(causal), 0 if window is None else int(window), 1.0 / (d**0.5),
            cuda.stream(q.device)), "flash_attention")
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Multi-head attention; q (B,H,Sq,D), k/v (B,HKV,Skv,D) -> (B,H,Sq,D)."""
    _check(q, k, v, window)
    if q.is_cuda:
        if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
            raise ValueError("flash_attention: the kernel forward has no gradient; "
                             "run it under torch.no_grad() or on plain tensors")
        return _launch(q, k, v, causal, window)
    return attention_reference(q, k, v, causal=causal, window=window)


#: kernel launches made by this wrapper (the CPU path counts nothing)
flash_attention.launches = 0
