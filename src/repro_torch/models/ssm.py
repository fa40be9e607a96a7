"""Mamba-2 block (SSD) [arXiv:2405.21060] (port of ``repro/models/ssm.py``).

Per block: in_proj -> split(z, xBC, dt); a short causal depthwise conv over
xBC; the SSD scan (``kernels.ssd_scan``: the CUDA kernels on the card, the
chunked plain version on the CPU); gated RMSNorm of y * silu(z); out_proj.
Decode keeps a (conv, ssm) state pair per layer, O(1) in sequence length;
the one-token decode update stays plain torch, as in the reference, its
state readout in fixed row blocks (``layers.fixed_rows``: batch-invariant;
the 4-tap conv sum reads equal at 4 and at 2 rows on the card, so it runs
batched).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models.layers import (
    SpringContext,
    dense_apply,
    dense_init,
    fixed_rows,
    rmsnorm_apply,
    rmsnorm_init,
)

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


def ssm_init(gen: torch.Generator, d: int, spec: SSMSpec, *, device=None) -> dict:
    proj_out = 2 * spec.d_inner + 2 * spec.n_groups * spec.d_state + spec.n_heads
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(gen, d, proj_out, device=device),
        "conv_w": torch.randn((CONV_K, spec.conv_dim), generator=gen, **f32).mul_(0.2),
        "conv_b": torch.zeros((spec.conv_dim,), **f32),
        "a_log": torch.log(torch.linspace(1.0, 16.0, spec.n_heads, **f32)),
        "dt_bias": torch.zeros((spec.n_heads,), **f32),
        "d_skip": torch.ones((spec.n_heads,), **f32),
        "norm": rmsnorm_init(spec.d_inner, device=device),
        "out_proj": dense_init(gen, spec.d_inner, d, device=device),
    }


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
    {"conv": (B, CONV_K-1, conv_dim), "ssm": (B, H, N, P)}).  Returns
    ``(out, new_cache)``."""
    b, s, _ = x.shape
    di, h, n, g = spec.d_inner, spec.n_heads, spec.d_state, spec.n_groups
    p = spec.head_dim

    zxbcdt = dense_apply(params["in_proj"], x, ctx)
    z, xbc, dt_raw = torch.split(zxbcdt, [di, spec.conv_dim, h], dim=-1)
    dt = _softplus(dt_raw.to(torch.float32) + params["dt_bias"])  # (B,S,H)
    a = -torch.exp(params["a_log"])  # (H,)

    if cache is None:
        xbc = _silu(_causal_conv(xbc, params["conv_w"], params["conv_b"])
                    .to(torch.float32)).to(x.dtype)
        xs, bm, cm = torch.split(xbc, [di, g * n, g * n], dim=-1)
        xs = xs.reshape(b, s, h, p)  # views: the kernel reads them through strides
        bm, cm = bm.reshape(b, s, g, n), cm.reshape(b, s, g, n)
        y, final_state = ssd_scan(xs, dt, a, bm, cm, return_state=True)
        new_cache = {"conv": zxbcdt[:, s - (CONV_K - 1):, di:di + spec.conv_dim]
                     .to(torch.bfloat16),
                     "ssm": final_state.to(torch.bfloat16)}
    else:
        if s != 1:
            raise ValueError("decode processes one token per step")
        conv_state = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)], dim=1)  # (B,K,C)
        acc = (conv_state.to(torch.float32) * params["conv_w"][None]).sum(dim=1) \
            + params["conv_b"]
        xbc1 = _silu(acc).to(x.dtype)  # (B, conv_dim)
        xs, bm, cm = torch.split(xbc1, [di, g * n, g * n], dim=-1)
        xs = xs.reshape(b, h, p)
        bmr = bm.reshape(b, g, n).repeat_interleave(h // g, dim=1).to(torch.float32)
        cmr = cm.reshape(b, g, n).repeat_interleave(h // g, dim=1).to(torch.float32)
        dt1 = dt[:, 0]  # (B,H)
        alpha = torch.exp(dt1 * a[None, :])
        ssm = cache["ssm"].to(torch.float32) * alpha[..., None, None] + torch.einsum(
            "bhn,bhp->bhnp", bmr * dt1[..., None], xs.to(torch.float32))
        y = fixed_rows(lambda c, s: torch.einsum("bhn,bhnp->bhp", c, s), cmr, ssm)
        y = y.reshape(b, 1, h, p)
        new_cache = {"conv": conv_state[:, 1:], "ssm": ssm.to(cache["ssm"].dtype)}
        xs = xs.reshape(b, 1, h, p)

    y = y + params["d_skip"][None, None, :, None] * xs.to(torch.float32)
    y = y.reshape(b, s, di)
    y = rmsnorm_apply(params["norm"],
                      y.to(x.dtype) * _silu(z.to(torch.float32)).to(x.dtype))
    out = dense_apply(params["out_proj"], y, ctx)
    return out, new_cache


def ssm_init_cache(batch: int, spec: SSMSpec, dtype=torch.bfloat16, *, device=None) -> dict:
    return {
        "conv": torch.zeros((batch, CONV_K - 1, spec.conv_dim), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, spec.n_heads, spec.d_state, spec.head_dim), dtype=dtype,
                           device=device),
    }
