"""Gradient compression for the inter-pod data-parallel reduction (port
of ``repro/runtime/compression.py``).

Gradients crossing the pod-to-pod link are sent as stochastically-rounded
int8 with per-tensor scales and an error-feedback memory (Seide et al.'15
/ 1-bit Adam lineage; the SR quantizer is the paper's Eq. 4 on a dynamic
grid).  Wire bytes drop 2x vs bf16 / 4x vs fp32; EF makes the compression
error O(1/steps) instead of accumulating.

A ring all-reduce cannot sum int8 without overflow, so the exchange is an
all-gather of the int8 payloads and their scales over the ``pod`` axis,
then the scale-weighted sum and ``/n`` on every rank: int8 is what moves
on the wire.  The uniform draws come from the port's counter hash
(``kernels/prng.py``) under explicit 32-bit seeds, folded per leaf; the
reference's threefry stream is not reproduced, so the rounding is held
statistically.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.kernels.prng import fold_in, hash_uint32, uniform_from_bits
from repro_torch.optim.optimizers import tree_leaves, tree_map

#: elements whose draws are made at once (bounds the int64 hash's memory)
DRAW_CHUNK = 1 << 24


def sr_quantize_int8(x: torch.Tensor, seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Stochastic-rounding int8 quantization with a per-tensor scale: element
    i rounds up with probability ``frac`` under draw ``hash(i, seed)``."""
    xf = x.to(torch.float32)
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    flat = xf.reshape(-1)
    q = torch.empty(flat.shape, dtype=torch.int8, device=x.device)
    for start in range(0, flat.numel(), DRAW_CHUNK):
        scaled = flat[start:start + DRAW_CHUNK] / scale
        lo = torch.floor(scaled)
        idx = torch.arange(start, start + scaled.numel(), device=x.device)
        u = uniform_from_bits(hash_uint32(idx, seed))
        q[start:start + DRAW_CHUNK] = torch.clamp(lo + (u < scaled - lo).to(torch.float32),
                                                  -127, 127).to(torch.int8)
    return q.reshape(x.shape), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compressed_allreduce_mean(x: torch.Tensor, axis_name: str, seed: int,
                              ef: Optional[torch.Tensor] = None) -> tuple:
    """Mean over ``axis_name`` of the installed mesh with int8 on the wire
    and error feedback; returns (mean, new_error_feedback)."""
    from repro_torch.dist.collectives import _axis_mesh

    mesh = _axis_mesh(axis_name)
    local = x.to(torch.float32) + (0.0 if ef is None else ef)
    q, scale = sr_quantize_int8(local, seed)
    new_ef = local - dequantize_int8(q, scale)
    # the int8 payload crosses the link; the scales are one f32 each
    all_q = mesh.all_gather(q, axis_name)  # (P, ...)
    all_s = mesh.all_gather(scale, axis_name)  # (P,)
    total = torch.tensordot(all_s, all_q.to(torch.float32), dims=([0], [0]))
    return total / mesh.axis_size(axis_name), new_ef


def compressed_allreduce_tree(grads: Any, axis_name: str, seed: int,
                              ef_tree: Optional[Any] = None) -> tuple:
    """Tree version: leaf i under seed ``fold_in(seed, i)``, with its own EF
    buffer (``ef_tree`` shaped like ``grads``, or None)."""
    leaves = tree_leaves(grads)
    efs = tree_leaves(ef_tree) if ef_tree is not None else [None] * len(leaves)
    outs, new_efs = [], []
    for i, (leaf, e) in enumerate(zip(leaves, efs)):
        o, ne = compressed_allreduce_mean(leaf, axis_name, fold_in(seed, i), e)
        outs.append(o.to(leaf.dtype))
        new_efs.append(ne)
    out_it, ef_it = iter(outs), iter(new_efs)
    return tree_map(lambda _: next(out_it), grads), tree_map(lambda _: next(ef_it), grads)


def compression_wire_bytes(grads: Any, n_pods: int) -> dict[str, float]:
    """Bytes per rank crossing the pod links, by exchange kind."""
    n = sum(x.numel() for x in tree_leaves(grads))
    return {
        "fp32_ring": 2 * (n_pods - 1) / n_pods * n * 4,
        "bf16_ring": 2 * (n_pods - 1) / n_pods * n * 2,
        "int8_gather": (n_pods - 1) * n * 1,
    }
