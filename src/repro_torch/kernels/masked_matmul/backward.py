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
Inside ``registry.record_kernel_metrics`` each backward product notes its
``tile_skip`` (:func:`backward_tile_skip`), and :func:`sparsity_probe`
measures the forward and backward skip fractions that ``perfmodel`` reads.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import registry
from repro_torch.kernels.masked_matmul import ops as mm_ops

__all__ = ["masked_matmul_dx", "masked_matmul_dw", "masked_matmul_dx_reference",
           "masked_matmul_dw_reference", "MaskedMatmulFn", "backward_tile_skip",
           "sparsity_probe"]


def masked_matmul_dx_reference(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`masked_matmul_dx` (the reference's ``_dx_ref``)."""
    return torch.matmul(g.to(torch.float32), w.to(torch.float32).T)


def masked_matmul_dw_reference(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`masked_matmul_dw` (the reference's ``_dw_ref``)."""
    return torch.matmul(x.to(torch.float32).T, g.to(torch.float32))


def _check(op: str, a: torch.Tensor, b: torch.Tensor, dim_a: int, dim_b: int) -> None:
    if a.ndim != 2 or b.ndim != 2 or a.shape[dim_a] != b.shape[dim_b]:
        raise ValueError(f"{op}: bad shapes {tuple(a.shape)}, {tuple(b.shape)}")


def backward_tile_skip(a: torch.Tensor, b: torch.Tensor) -> float:
    """Tile-skip fraction of one backward product ``a @ b`` (transposes
    already applied), at the reference's 128 tiles."""
    return mm_ops.tile_skip_fraction(a, b)


def _note_skip(op: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if registry.metrics_active():
        registry.note_metric(op, tile_skip=backward_tile_skip(a, b))


def masked_matmul_dx(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dL/dx = g @ w.T.  g: (M, N) cotangent; w: (K, N).  Returns (M, K)
    fp32.  CUDA tensors launch the kernel (one counted launch), CPU
    tensors run :func:`masked_matmul_dx_reference`."""
    _check("masked_matmul_dx", g, w, 1, 1)
    _note_skip("masked_matmul_dx", g, w.T)
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
    _note_skip("masked_matmul_dw", x.T, g)
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


def sparsity_probe(density: float = 0.5, size: int = 512, seed: int = 0,
                   device="cuda") -> dict:
    """Measured forward and backward tile-skip fractions at a tile-granular
    density (the reference's ``sparsity_probe``).

    One ``masked_matmul`` forward and one autograd backward (dx and dw
    through their kernels on the card) on ``size``-square operands whose
    128 x 128 tiles are kept with probability ``density``, at least one
    tile of each dropped when ``density < 1``, inside
    ``record_kernel_metrics``; returns what the hooks measured, under the
    reference's keys.  Operands come from a ``torch.Generator`` seeded
    with ``seed``, so the fractions are not the reference's own draws.
    """
    gen = torch.Generator().manual_seed(seed)
    tile = mm_ops.BM

    def tile_sparse(shape):
        v = torch.randn(shape, generator=gen) * 0.05
        keep = torch.rand(shape[0] // tile, shape[1] // tile, generator=gen) < density
        if density < 1.0:  # at least one skippable tile per operand
            keep[0, 0] = False
        keep = keep.repeat_interleave(tile, 0).repeat_interleave(tile, 1)
        return (v * keep).to(device)

    x = tile_sparse((size, size)).requires_grad_(True)
    w = tile_sparse((size, size)).requires_grad_(True)
    with registry.record_kernel_metrics() as rows:
        with torch.no_grad():
            mm_ops.masked_matmul(x, w, apply_sr=False)  # forward: records its skip
        y = mm_ops.masked_matmul(x, w, apply_sr=False, backward="auto")
        torch.sum(torch.relu(y) ** 2).backward()         # backward: dx and dw skips
    s = registry.metric_summary(rows)
    dx = s.get("masked_matmul_dx", {}).get("tile_skip")
    dw = s.get("masked_matmul_dw", {}).get("tile_skip")
    bwd = [v for v in (dx, dw) if v is not None]
    return {
        "density": density,
        "size": size,
        "forward_tile_skip": s.get("masked_matmul", {}).get("tile_skip"),
        "backward_tile_skip_dx": dx,
        "backward_tile_skip_dw": dw,
        "backward_tile_skip": sum(bwd) / len(bwd) if bwd else None,
    }
