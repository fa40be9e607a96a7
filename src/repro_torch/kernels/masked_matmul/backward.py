"""Sparsity-aware backward GEMMs of the masked matmul (port of
``repro/kernels/masked_matmul/backward.py``).

For ``y = x @ w`` the two backward products

  dL/dx = g @ w.T        (cotangent  x  transposed weights)
  dL/dw = x.T @ g        (stashed activation  x  cotangent)

inherit the ReLU sparsity of ``x`` and ``g`` and run on the same
tile-skipping kernel as the forward, with the SR epilogue off: gradients
stay fp32, SR belongs to the weight update.  On CUDA tensors both launch
``masked_mm_kernel`` reading ``w.T`` / ``x.T`` in place through the
kernel's column-major layout (the reference materializes the transposes
before its Pallas call); on CPU tensors they run the plain versions, the
reference's ``_dx_ref`` / ``_dw_ref``.  The reference's jnp, interpret and
pallas rungs have no counterpart: the device picks the route.

:class:`MaskedMatmulFn` is the port of the reference's ``_mm_bw``
custom_vjp: the forward product, with the operands alone as residual.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.masked_matmul import ops as mm_ops

__all__ = ["masked_matmul_dx", "masked_matmul_dw", "masked_matmul_dx_reference",
           "masked_matmul_dw_reference", "MaskedMatmulFn"]


def masked_matmul_dx_reference(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`masked_matmul_dx` (the reference's ``_dx_ref``)."""
    return torch.matmul(g.to(torch.float32), w.to(torch.float32).T)


def masked_matmul_dw_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`masked_matmul_dw` (the reference's ``_dw_ref``)."""
    return torch.matmul(x.to(torch.float32).T, g.to(torch.float32))


def _check(op: str, a: torch.Tensor, b: torch.Tensor, dim_a: int, dim_b: int) -> None:
    if a.ndim != 2 or b.ndim != 2 or a.shape[dim_a] != b.shape[dim_b]:
        raise ValueError(f"{op}: bad shapes {tuple(a.shape)}, {tuple(b.shape)}")


def masked_matmul_dx(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dL/dx = g @ w.T.  g: (M, N) cotangent; w: (K, N).  Returns (M, K)
    fp32.  CUDA tensors launch the kernel (one counted launch), CPU
    tensors run :func:`masked_matmul_dx_reference`."""
    _check("masked_matmul_dx", g, w, 1, 1)
    if not g.is_cuda:
        mm_ops.note_plain("masked_matmul_dx", g, w.T)
        return masked_matmul_dx_reference(g, w)
    out = mm_ops.launch(g, w.T, 0, 4, 16, False, op="masked_matmul_dx")
    masked_matmul_dx.launches += 1
    return out


def masked_matmul_dw(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dL/dw = x.T @ g.  x: (M, K) forward activation; g: (M, N)
    cotangent.  Returns (K, N) fp32.  CUDA tensors launch the kernel (one
    counted launch), CPU tensors run :func:`masked_matmul_dw_reference`."""
    _check("masked_matmul_dw", x, g, 0, 0)
    if not x.is_cuda:
        mm_ops.note_plain("masked_matmul_dw", x.T, g)
        return masked_matmul_dw_reference(x, g)
    out = mm_ops.launch(x.T, g, 0, 4, 16, False, op="masked_matmul_dw")
    masked_matmul_dw.launches += 1
    return out


#: kernel launches made by these wrappers (the CPU path counts nothing)
masked_matmul_dx.launches = 0
masked_matmul_dw.launches = 0


class MaskedMatmulFn(torch.autograd.Function):
    """``masked_matmul`` forward with dx/dw through the backward kernels.

    The residual is the (sparse) operands only, never the product; the
    SR epilogue is straight-through (range clipping is the caller's STE
    quantizer), as in the reference's ``_mm_bw``."""

    @staticmethod
    def forward(ctx, x, w, seed, il, fl, apply_sr):
        ctx.save_for_backward(x, w)
        return mm_ops.forward(x, w, seed, il=il, fl=fl, apply_sr=apply_sr)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = masked_matmul_dx(g, w) if ctx.needs_input_grad[0] else None
        dw = masked_matmul_dw(x, g) if ctx.needs_input_grad[1] else None
        return dx, dw, None, None, None, None
