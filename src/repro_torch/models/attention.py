"""GQA attention (port of ``repro/models/attention.py``).

Two regimes, as in the reference:

  * prefill — full-sequence attention through the ``flash_attention``
    wrapper on every device (the reference's route when the kernel is
    pinned, ``attention.py:169-176``): the CUDA kernel on the card, reading
    the (B, S, H, D) projections in place through strides, its plain
    version on the CPU; the serving cache it emits is bf16, like the
    reference's (``attention.py:200-201``);
  * decode — one new token per row against the cache, each row at its own
    position (a per-slot ``(B,)`` vector, or a scalar broadcast to it).  The
    new k/v row is written into the bf16 cache first and attended from
    there, so the current token's key is bf16-rounded exactly as in the
    reference (``_row_update``, ``attention.py:41-45``).

Decode attention stays plain torch, as in the reference; its score
product runs in fixed row blocks (``layers.fixed_rows``) so that a row's
result does not depend on the batch's size.  MLA, sliding windows, the qkv bias and the int8 cache are
not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import (SpringContext, dense_apply, dense_init, fixed_rows,
                                        rope_apply)


def _pos_vec(pos, b: int, device) -> torch.Tensor:
    """Decode position(s) as a (B,) int64 vector (scalar broadcasts)."""
    p = torch.as_tensor(pos, device=device).to(torch.int64)
    return p.expand(b) if p.ndim == 0 else p


def _row_update(cache_leaf: torch.Tensor, new: torch.Tensor, slot_v: torch.Tensor) -> torch.Tensor:
    """Copy of the cache with row b's new entry written at ``slot_v[b]``."""
    b = new.shape[0]
    out = cache_leaf.clone()
    out[torch.arange(b, device=out.device), slot_v] = new[:, 0].to(cache_leaf.dtype)
    return out


def _scores(qh: torch.Tensor, ck: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bkgd,bskd->bkgs", qh, ck)


def _decode_attend(qh: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                   pos_v: torch.Tensor) -> torch.Tensor:
    """fp32 attention of (B, KV, G, D) queries over the (B, S, KV, D) cache
    up to each row's position.  The score product runs in fixed row blocks
    (``fixed_rows``): on the card its batched GEMM's sums differ with the
    batch's size.  The softmax and the value product read equal at 4 and at
    2 rows there, so they run batched."""
    d, s_max = qh.shape[-1], ck.shape[1]
    scores = fixed_rows(_scores, qh.to(torch.float32), ck.to(torch.float32)) / (d**0.5)
    valid = torch.arange(s_max, device=qh.device)[None, :] <= pos_v[:, None]
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full((), -1e30, device=qh.device))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bkgs,bskd->bkgd", p, cv.to(torch.float32))


@dataclasses.dataclass(frozen=True)
class AttnSpec:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    causal: bool = True
    window: Optional[int] = None
    qkv_bias: bool = False


def gqa_init(gen: torch.Generator, d: int, spec: AttnSpec, *, device=None) -> dict:
    if spec.window is not None or spec.qkv_bias:
        raise NotImplementedError("sliding-window and qkv-bias attention are not ported")
    h, kv, hd = spec.n_heads, spec.n_kv_heads, spec.head_dim
    return {
        "wq": dense_init(gen, d, h * hd, device=device),
        "wk": dense_init(gen, d, kv * hd, device=device),
        "wv": dense_init(gen, d, kv * hd, device=device),
        "wo": dense_init(gen, h * hd, d, device=device),
    }


def gqa_apply(
    params: dict,
    x: torch.Tensor,
    ctx: SpringContext,
    spec: AttnSpec,
    positions: torch.Tensor,
    cache: Optional[dict] = None,
    pos=None,
    return_cache: bool = False,
):
    """Full-sequence attention (cache None) or one-token decode (cache set).
    Returns ``(out, new_cache)``."""
    b, s, _ = x.shape
    h, kv, d = spec.n_heads, spec.n_kv_heads, spec.head_dim
    q = dense_apply(params["wq"], x, ctx).reshape(b, s, h, d)
    k = dense_apply(params["wk"], x, ctx).reshape(b, s, kv, d)
    v = dense_apply(params["wv"], x, ctx).reshape(b, s, kv, d)
    q = rope_apply(q, positions, spec.rope_theta)
    k = rope_apply(k, positions, spec.rope_theta)

    if cache is None:
        # (B,S,H,D) -> (B,H,S,D) views; the output comes back in q's layout,
        # so the transpose back is contiguous again
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                              causal=spec.causal).transpose(1, 2)
        new_cache = ({"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
                     if return_cache else None)
    else:
        if s != 1:
            raise ValueError("decode processes one token per step")
        pos_v = _pos_vec(pos, b, x.device)
        ck = _row_update(cache["k"], k, pos_v)
        cv = _row_update(cache["v"], v, pos_v)
        qh = q.reshape(b, kv, h // kv, d)
        out = _decode_attend(qh, ck, cv, pos_v)
        out = out.reshape(b, 1, h, d).to(x.dtype)
        new_cache = {"k": ck, "v": cv}

    out = dense_apply(params["wo"], out.reshape(b, s, h * d), ctx)
    return out, new_cache


def gqa_init_cache(batch: int, spec: AttnSpec, max_len: int, dtype=torch.bfloat16,
                   *, device=None) -> dict:
    shape = (batch, max_len, spec.n_kv_heads, spec.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
