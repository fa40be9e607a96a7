"""GQA attention (port of ``repro/models/attention.py``).

Two regimes, as in the reference:

  * prefill — full-sequence attention in plain torch, in query chunks of
    ``Q_CHUNK`` (``_chunked_attention``); the serving cache it emits is
    bf16, like the reference's (``attention.py:200-201``);
  * decode — one new token per row against the cache, each row at its own
    position (a per-slot ``(B,)`` vector, or a scalar broadcast to it).  The
    new k/v row is written into the bf16 cache first and attended from
    there, so the current token's key is bf16-rounded exactly as in the
    reference (``_row_update``, ``attention.py:41-45``).

MLA, sliding windows and the int8 cache are not ported yet.  The flash
attention Pallas kernel is off the serving path (it only runs when pinned).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models.layers import SpringContext, dense_apply, dense_init, rope_apply

Q_CHUNK = 1024


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


def _chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       causal: bool, q_chunk: int = Q_CHUNK) -> torch.Tensor:
    """Dense-math attention over query chunks; q (B,S,H,D), k/v (B,S,KV,D)."""
    b, s, h, d = q.shape
    skv, kv_heads, dv = k.shape[1], k.shape[2], v.shape[-1]
    group = h // kv_heads
    scale = 1.0 / (d**0.5)
    qc = q_chunk if s % q_chunk == 0 else s
    kf = k.to(torch.float32)
    vf = v.to(torch.float32)
    k_idx = torch.arange(skv, device=q.device)
    outs = []
    for ci in range(s // qc):
        q_blk = q[:, ci * qc:(ci + 1) * qc].to(torch.float32)
        q_idx = ci * qc + torch.arange(qc, device=q.device)
        qh = q_blk.reshape(b, qc, kv_heads, group, d)
        scores = torch.einsum("bqkgd,bskd->bkgqs", qh, kf) * scale
        if causal:
            mask = q_idx[:, None] >= k_idx[None, :]
            scores = torch.where(mask, scores, torch.full((), -1e30, device=q.device))
        p = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgqs,bskd->bqkgd", p, vf)
        outs.append(out.reshape(b, qc, h, dv).to(q.dtype))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


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
        out = _chunked_attention(q, k, v, causal=spec.causal)
        new_cache = ({"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}
                     if return_cache else None)
    else:
        if s != 1:
            raise ValueError("decode processes one token per step")
        pos_v = _pos_vec(pos, b, x.device)
        ck = _row_update(cache["k"], k, pos_v)
        cv = _row_update(cache["v"], v, pos_v)
        s_max = ck.shape[1]
        group = h // kv
        qh = q.reshape(b, kv, group, d)
        scores = torch.einsum("bkgd,bskd->bkgs", qh.to(torch.float32),
                              ck.to(torch.float32)) / (d**0.5)
        valid = torch.arange(s_max, device=x.device)[None, :] <= pos_v[:, None]
        scores = torch.where(valid[:, None, None, :], scores,
                             torch.full((), -1e30, device=x.device))
        p = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgs,bskd->bkgd", p, cv.to(torch.float32))
        out = out.reshape(b, 1, h, d).to(x.dtype)
        new_cache = {"k": ck, "v": cv}

    out = dense_apply(params["wo"], out.reshape(b, s, h * d), ctx)
    return out, new_cache


def gqa_init_cache(batch: int, spec: AttnSpec, max_len: int, dtype=torch.bfloat16,
                   *, device=None) -> dict:
    shape = (batch, max_len, spec.n_kv_heads, spec.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
