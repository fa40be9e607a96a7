"""Foundational layers (port of ``repro/models/layers.py``).

Functional style on plain parameter dicts, as in the reference: dense
kernels are ``(d_in, d_out)`` tensors under ``{"kernel": ...}``, so the
JAX parameter tree maps one to one (``repro_torch.convert``).  Every
projection funnels through :func:`~repro_torch.core.spring_ops.spring_matmul`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.spring_ops import DENSE, DENSE_DTYPE, KeyGen, SpringConfig, spring_matmul
from repro_torch.memstash.config import MemstashConfig


@dataclasses.dataclass
class SpringContext:
    """Per-call numerics context threaded through every layer.

    ``keys`` is the SR generator stream (a :class:`KeyGen`; None rounds to
    nearest); ``memstash`` the compressed-activation-stash policy of the
    conv/fc stash points (None: every point resolves to "none").
    Magnitude pruning and the int8 KV cache are not ported: both must stay
    at their defaults.
    """

    cfg: SpringConfig = DENSE
    keys: Optional[KeyGen] = None
    prune_ratio: float = 0.0
    int8_cache: bool = False
    memstash: Optional[MemstashConfig] = None

    def __post_init__(self):
        if self.prune_ratio != 0.0 or self.int8_cache:
            raise NotImplementedError("prune_ratio and int8_cache are not ported")

    def stash_policy(self, elems: Optional[int] = None) -> str:
        """Resolve the checkpoint policy for a stash point of ``elems``."""
        if self.memstash is None:
            return "none"
        return self.memstash.policy_for(elems)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, device=None,
               scale: float | None = None) -> dict:
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32, device=device)
    return {"kernel": w.mul_(scale)}


def dense_apply(params: dict, x: torch.Tensor, ctx: SpringContext) -> torch.Tensor:
    w = params["kernel"]
    shape = x.shape
    y = spring_matmul(x.reshape(-1, shape[-1]), w, ctx.cfg, ctx.keys)
    y = y.reshape(*shape[:-1], w.shape[-1])
    if "bias" in params:
        y = (y + params["bias"].to(y.dtype)).to(y.dtype)
    return y


def embed_init(gen: torch.Generator, vocab: int, d: int, *, device=None) -> dict:
    emb = torch.randn((vocab, d), generator=gen, dtype=torch.float32, device=device)
    return {"embedding": emb.mul_(0.02)}


def embed_apply(params: dict, tokens: torch.Tensor, ctx: SpringContext) -> torch.Tensor:
    # quantized modes carry fp32 activations (the Q4.16 grid does not fit
    # in bf16); dense mode computes in bf16
    act_dtype = torch.float32 if ctx.cfg.is_quantized else DENSE_DTYPE
    return params["embedding"][tokens].to(act_dtype)


def rmsnorm_init(d: int, *, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


#: rows (dim 0) of every call that :func:`fixed_rows` makes
ROW_BLOCK = 8


def fixed_rows(fn, *xs: torch.Tensor) -> torch.Tensor:
    """``fn`` over ``xs`` in blocks of exactly ``ROW_BLOCK`` rows (dim 0),
    the last block zero-padded, the results concatenated without the
    padding.  cuBLAS and torch's reduction kernels choose their algorithm,
    and so their summation order, by the operands' shapes: on the card a
    row reduced in a batch of 4 and in a batch of 2 can differ in its last
    bits.  Here every call has the same shape whatever the batch's size,
    and each row's result reads only that row, so serving's decode is
    batch-invariant (the same tokens after a rescale, or a resume into
    another slot) on every device."""
    b, out = xs[0].shape[0], []
    for start in range(0, b, ROW_BLOCK):
        n = min(ROW_BLOCK, b - start)
        block = [x[start:start + n] for x in xs]
        if n < ROW_BLOCK:
            block = [F.pad(x, (0, 0) * (x.ndim - 1) + (0, ROW_BLOCK - n)) for x in block]
        out.append(fn(*block)[:n])
    return out[0] if len(out) == 1 else torch.cat(out)


def _mean_square(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x * x, dim=-1, keepdim=True)


def rmsnorm_apply(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm.  For one position per row (a decode step) the mean of
    squares is reduced in fixed row blocks (:func:`fixed_rows`)."""
    xf = x.to(torch.float32)
    var = fixed_rows(_mean_square, xf) if xf.ndim == 3 and xf.shape[1] == 1 \
        else _mean_square(xf)
    y = xf * torch.rsqrt(var + eps) * params["scale"]
    return y.to(x.dtype)


def rope_apply(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, D) with D even; positions: (B, S) integer."""
    d = x.shape[-1]
    exponent = torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions[..., None].to(torch.float32) * inv_freq  # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu_init(gen: torch.Generator, d: int, d_ff: int, *, device=None) -> dict:
    return {
        "gate": dense_init(gen, d, d_ff, device=device),
        "up": dense_init(gen, d, d_ff, device=device),
        "down": dense_init(gen, d_ff, d, device=device),
    }


def swiglu_apply(params: dict, x: torch.Tensor, ctx: SpringContext) -> torch.Tensor:
    g = dense_apply(params["gate"], x, ctx)
    u = dense_apply(params["up"], x, ctx)
    gf = g.to(torch.float32)
    h = (gf * torch.sigmoid(gf)).to(g.dtype) * u  # jax.nn.silu = x * sigmoid(x)
    return dense_apply(params["down"], h, ctx)
