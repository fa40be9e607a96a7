"""Mamba-2 block (SSD) [arXiv:2405.21060] (port of ``repro/models/ssm.py``).

Per block: in_proj -> split(z, xBC, dt); a short causal depthwise conv over
xBC; the SSD scan (``kernels.ssd_scan``: the CUDA kernels on the card, the
chunked plain version on the CPU; where a gradient is wanted on the card,
``ssd_scan_trainable``: the kernels forward, the chunked form's VJP
backward); gated RMSNorm of y * silu(z); out_proj.
Decode keeps a (conv, ssm) state pair per layer, O(1) in sequence length;
the one-token decode update stays plain torch, as in the reference, its
state readout in fixed row blocks (``layers.fixed_rows``: batch-invariant;
the 4-tap conv sum reads equal at 4 and at 2 rows on the card, so it runs
batched).

Under a mesh that splits weights over ``model`` (``dist.tensor``) a rank
runs the heads ``[r H/m, (r+1) H/m)`` that its ``out_proj`` rows read
(:func:`_rank_heads`).  ``in_proj``'s column shard does not fall on the
z / x / B / C / dt boundaries, so its output is gathered whole over
``model`` (where the divisibility fallback keeps ``in_proj`` whole, every
rank computes it whole); the rank takes z, x and dt of its heads and the
one state group's B / C whole, runs the conv on those channels and the SSD scan on
its heads, gathers the gated product whole for the norm (the unsharded
bits), and feeds its ``d_inner / m`` columns to ``out_proj``'s row shard,
summed over ``model``.  ``conv_w``, ``conv_b``, ``a_log``, ``dt_bias``,
``d_skip`` and the norm stay whole on every rank, sliced where they are
read, their gradients summed over ``model``.  The ``ssm`` state holds the
rank's heads; the ``conv`` state holds the whole ``conv_dim``, the same
bits on every rank (the rank has the whole projection anyway).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.dist.tensor import column_input, copy_to_model, gather_from_model
from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_trainable
from repro_torch.models.layers import (
    SpringContext,
    dense_apply,
    dense_init,
    fixed_rows,
    rmsnorm_apply,
    rmsnorm_init,
)
from repro_torch.runtime.sharding import weight_split

CONV_K = 4


@dataclasses.dataclass(frozen=True)
class SSMSpec:
    d_inner: int  # = n_heads * head_dim
    n_heads: int
    d_state: int = 128
    n_groups: int = 1

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)  # jax.nn.silu


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))  # jax.nn.softplus


def _proj_out(spec: SSMSpec) -> int:
    return 2 * spec.d_inner + 2 * spec.n_groups * spec.d_state + spec.n_heads


def ssm_init(gen: torch.Generator, d: int, spec: SSMSpec, *, device=None) -> dict:
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(gen, d, _proj_out(spec), device=device),
        "conv_w": torch.randn((CONV_K, spec.conv_dim), generator=gen, **f32).mul_(0.2),
        "conv_b": torch.zeros((spec.conv_dim,), **f32),
        "a_log": torch.log(torch.linspace(1.0, 16.0, spec.n_heads, **f32)),
        "dt_bias": torch.zeros((spec.n_heads,), **f32),
        "d_skip": torch.ones((spec.n_heads,), **f32),
        "norm": rmsnorm_init(spec.d_inner, device=device),
        "out_proj": dense_init(gen, spec.d_inner, d, device=device),
    }


def _splits(spec: SSMSpec, d_model: int) -> tuple:
    """``in_proj``'s and ``out_proj``'s splits over ``model`` (or None)."""
    return (weight_split(("w_embed", "w_mlp"), (d_model, _proj_out(spec))),
            weight_split(("w_mlp", "w_embed"), (spec.d_inner, d_model)))


def _rank_heads(spec: SSMSpec, so) -> tuple:
    """The heads ``[h0, h1)`` whose ``d_inner`` columns ``out_proj``'s row
    shard ``so`` reads (all of them unsplit)."""
    p = spec.head_dim
    if so is None:
        return 0, spec.n_heads
    if so.lo % p or so.hi % p or spec.n_groups != 1:
        raise NotImplementedError(
            f"out_proj rows [{so.lo}, {so.hi}) are not whole heads of {p} columns of one "
            f"state group ({spec.n_groups} groups)")
    return so.lo // p, so.hi // p


def _channels(spec: SSMSpec, h0: int, h1: int, device) -> torch.Tensor:
    """The rank's channels of the conv input ``xBC``: x of its heads, B and
    C whole (one group)."""
    di, p = spec.d_inner, spec.head_dim
    return torch.cat([torch.arange(h0 * p, h1 * p),
                      torch.arange(di, spec.conv_dim)]).to(device)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, width CONV_K, via shifted adds.  x: (B,S,C)."""
    s = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(CONV_K):
        shift = CONV_K - 1 - i
        xi = torch.nn.functional.pad(x, (0, 0, shift, 0))[:, :s]
        out = out + xi.to(torch.float32) * w[i]
    return (out + b).to(x.dtype)


def ssm_apply(params: dict, x: torch.Tensor, ctx: SpringContext, spec: SSMSpec,
              cache: Optional[dict] = None):
    """Prefill (cache None; the final SSD state and the last CONV_K - 1 raw
    conv inputs become the decode cache) or one-token decode (cache
    {"conv": (B, CONV_K-1, conv_dim), "ssm": (B, H', N, P)}, H' the rank's
    heads).  Returns ``(out, new_cache)``."""
    b, s, d = x.shape
    di, n, p = spec.d_inner, spec.d_state, spec.head_dim
    s_in, s_out = _splits(spec, d)

    zxbcdt = dense_apply(params["in_proj"], column_input(x, s_in), ctx, s_in)
    if s_in is not None:  # the rank's columns cross the z / x / B / C / dt bounds
        zxbcdt = gather_from_model(zxbcdt, -1)
    elif s_out is not None:  # whole on every rank, each reading its heads' parts
        zxbcdt = copy_to_model(zxbcdt)
    z, xbc, dt_raw = torch.split(zxbcdt, [di, spec.conv_dim, spec.n_heads], dim=-1)
    h0, h1 = _rank_heads(spec, s_out)
    h, g = h1 - h0, spec.n_groups
    # the whole leaves a rank reads its slices of: their gradients sum over model
    whole = (params if s_out is None else
             {k: copy_to_model(params[k]) for k in ("conv_w", "conv_b", "a_log", "dt_bias",
                                                   "d_skip")}
             | {"norm": {"scale": copy_to_model(params["norm"]["scale"])}})
    chans = None
    if s_out is not None:
        chans = _channels(spec, h0, h1, x.device)
        z, dt_raw = z[..., h0 * p:h1 * p], dt_raw[..., h0:h1]
    dt = _softplus(dt_raw.to(torch.float32) + whole["dt_bias"][h0:h1])  # (B,S,H')
    a = -torch.exp(whole["a_log"][h0:h1])  # (H',)

    if cache is None:
        conv_w, conv_b = whole["conv_w"], whole["conv_b"]
        if chans is not None:
            xbc, conv_w, conv_b = (xbc.index_select(-1, chans), conv_w.index_select(1, chans),
                                   conv_b.index_select(0, chans))
        xbc = _silu(_causal_conv(xbc, conv_w, conv_b).to(torch.float32)).to(x.dtype)
        xs, bm, cm = torch.split(xbc, [h * p, g * n, g * n], dim=-1)
        xs = xs.reshape(b, s, h, p)  # views: the kernel reads them through strides
        bm, cm = bm.reshape(b, s, g, n), cm.reshape(b, s, g, n)
        operands = (xs, dt, a, bm, cm)
        grad = torch.is_grad_enabled() and any(t.requires_grad for t in operands)
        scan = ssd_scan_trainable if grad and xs.is_cuda else ssd_scan
        y, final_state = scan(*operands, return_state=True)
        new_cache = {"conv": zxbcdt[:, s - (CONV_K - 1):, di:di + spec.conv_dim]
                     .to(torch.bfloat16),
                     "ssm": final_state.to(torch.bfloat16)}
    else:
        if s != 1:
            raise ValueError("decode processes one token per step")
        # the conv state and its sum stay whole (the unsharded shapes' bits)
        conv_state = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)], dim=1)  # (B,K,C)
        acc = (conv_state.to(torch.float32) * params["conv_w"][None]).sum(dim=1) \
            + params["conv_b"]
        xbc1 = _silu(acc).to(x.dtype)  # (B, conv_dim)
        if chans is not None:
            xbc1 = xbc1.index_select(-1, chans)
        xs, bm, cm = torch.split(xbc1, [h * p, g * n, g * n], dim=-1)
        xs = xs.reshape(b, h, p)
        bmr = bm.reshape(b, g, n).repeat_interleave(h // g, dim=1).to(torch.float32)
        cmr = cm.reshape(b, g, n).repeat_interleave(h // g, dim=1).to(torch.float32)
        dt1 = dt[:, 0]  # (B,H')
        alpha = torch.exp(dt1 * a[None, :])
        ssm = cache["ssm"].to(torch.float32) * alpha[..., None, None] + torch.einsum(
            "bhn,bhp->bhnp", bmr * dt1[..., None], xs.to(torch.float32))
        y = fixed_rows(lambda c, s: torch.einsum("bhn,bhnp->bhp", c, s), cmr, ssm)
        y = y.reshape(b, 1, h, p)
        new_cache = {"conv": conv_state[:, 1:], "ssm": ssm.to(cache["ssm"].dtype)}
        xs = xs.reshape(b, 1, h, p)

    y = y + whole["d_skip"][h0:h1][None, None, :, None] * xs.to(torch.float32)
    y = y.reshape(b, s, h * p)
    y = y.to(x.dtype) * _silu(z.to(torch.float32)).to(x.dtype)
    if s_out is not None:  # the norm spans d_inner: gathered whole, the unsharded bits
        y = gather_from_model(y, -1)
    y = rmsnorm_apply(whole["norm"], y)
    if s_out is not None:  # the columns out_proj's rows read
        y = y.narrow(-1, s_out.lo, s_out.hi - s_out.lo)
    out = dense_apply(params["out_proj"], y, ctx, s_out)
    return out, new_cache


def ssm_init_cache(batch: int, spec: SSMSpec, dtype=torch.bfloat16, *, device=None,
                   d_model: Optional[int] = None) -> dict:
    """Zero decode state.  Given the layer's ``d_model``, under a mesh that
    splits the layer over ``model`` the ``ssm`` state holds the rank's
    heads (the ``conv`` state stays whole)."""
    h0, h1 = _rank_heads(spec, None if d_model is None else _splits(spec, d_model)[1])
    return {
        "conv": torch.zeros((batch, CONV_K - 1, spec.conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, h1 - h0, spec.d_state, spec.head_dim), dtype=dtype,
                           device=device),
    }
