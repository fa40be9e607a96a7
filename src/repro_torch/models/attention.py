"""GQA attention, full and sliding-window, and DeepSeek's multi-head
latent attention (port of ``repro/models/attention.py``).

Two regimes, as in the reference:

  * full sequence — the context's ``attention`` route.  ``"flash"``
    (serving's prefill) runs the ``flash_attention`` wrapper on every
    device (the reference's route when the kernel is pinned,
    ``attention.py:169-176``): the CUDA kernel on the card, reading the
    (B, S, H, D) projections in place through strides, its plain version
    on the CPU; the serving cache it emits is bf16, like the reference's
    (``attention.py:200-201``).  ``"chunked"`` (training, unless
    ``flash_attention`` is pinned) runs :func:`_chunked_attention`, the
    reference's differentiable attention over query chunks, each
    recomputed in the backward pass: the card's kernel has no gradient;
  * decode — one new token per row against the cache, each row at its own
    position (a per-slot ``(B,)`` vector, or a scalar broadcast to it).  The
    new k/v row is written into the bf16 cache first and attended from
    there, so the current token's key is bf16-rounded exactly as in the
    reference (``_row_update``, ``attention.py:41-45``).

A window spec (recurrentgemma's local attention) keeps ring caches,
``k_ring`` / ``v_ring`` of ``window`` rows with slot(p) = p % window for
any prompt length: prefill scatters its last ``window`` rows there (zero
padded below the window), decode writes at ``pos % window`` and masks by
each slot's absolute position (``attention.py:184-201``, ``:228-253``).
A ``qkv_bias`` spec (qwen2) gives ``wq`` / ``wk`` / ``wv`` a bias, which
``dense_apply`` adds.

Decode attention stays plain torch, as in the reference; its score
product runs in fixed row blocks (``layers.fixed_rows``) so that a row's
result does not depend on the batch's size.

MLA (deepseek-v2-lite-16b, ``attention.py:291-381``) caches the 512-wide
latent ``ckv`` and the shared rope key ``krope`` (bf16, seq axis -2).
Prefill expands the latent to per-head keys and values (the standard
form) and attends through :func:`_chunked_attention` (q/k D 192, v D
128), as the reference does: it never calls ``flash_attention``.  Decode
writes the new latent and rope rows into the cache first and attends in
the latent space (the absorbed form), every product in fixed row blocks.
The up-projections ``wuk`` / ``wuv`` are raw fp32 kernels in every mode,
never quantized.  Under a head split over ``model`` a rank holds its heads'
columns of ``wq`` / ``wuk`` / ``wuv`` and rows of ``wo`` (summed over
``model``); ``wdkv`` and ``wkr`` stay whole, and so does the latent cache
on every rank, whose gradient (its rows read by each rank's heads alone)
is summed over ``model``.

Under a mesh that splits weights over ``model`` (``dist.tensor``), ``wq``
/ ``wk`` / ``wv`` are column shards and ``wo`` a row shard: a rank computes
the heads whose output columns its ``wo`` rows read, and the kv heads
those query heads read (:func:`_rank_heads`); flash attention, the chunked
attention and the decode run on those local heads, and the decode cache
holds the rank's kv heads.  Where a shard's columns are not whole heads
(H or HKV not a multiple of the split), the projection's output is
gathered over ``model`` (exact) and the rank keeps the heads it needs; a
rank whose query heads straddle kv groups unevenly repeats its kv heads
once per query head.

The int8 cache (``SpringContext.int8_cache``, full attention only; rings
and MLA's latent stay bf16): prefill returns ``{"k_q8", "k_sc", "v_q8",
"v_sc"}``, each cache line rounded half to even to int8 under one bf16
scale per (row, position, kv head), max |x| / 127 (:func:`_q8`, the
reference's ``attention.py:48-58``).  Decode writes the new token's
lines first and attends with the scales factored out of the products
(``attention.py:202-226``): the scores are ``(q . k_q8) * k_sc`` and the
probabilities are scaled by ``v_sc`` before the value product, both
products in fixed row blocks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.utils.checkpoint

from repro_torch.dist.tensor import column_input, copy_to_model, gather_from_model
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import (SpringContext, dense_apply, dense_init, fixed_rows,
                                        rope_apply)
from repro_torch.runtime.sharding import weight_split


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


def _q8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, seq, head) int8 lines of ``x`` (..., D) and their bf16
    scales (...,): round half to even of x / scale, clipped to +-127."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-9
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale[..., 0].to(torch.bfloat16)


def _dq8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale.to(torch.float32)[..., None]


def _scores(qh: torch.Tensor, ck: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bkgd,bskd->bkgs", qh, ck)


def _values(p: torch.Tensor, cv: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bkgs,bskd->bkgd", p, cv)


def _valid(pos_v: torch.Tensor, s_max: int, window: Optional[int]) -> torch.Tensor:
    """(B, S) live cache slots of each row at position ``pos_v``: slots up to
    it, or for a ring the slots whose absolute position p = pos - ((pos - i)
    mod S) is real (>= 0) and inside the window."""
    idx = torch.arange(s_max, device=pos_v.device)[None, :]
    if window is None:
        return idx <= pos_v[:, None]
    abs_pos = pos_v[:, None] - torch.remainder(pos_v[:, None] - idx, s_max)
    return (abs_pos >= 0) & (abs_pos > pos_v[:, None] - window)


def _decode_attend(qh: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """fp32 attention of (B, KV, G, D) queries over the (B, S, KV, D) cache's
    ``valid`` (B, S) slots.  The score and value products run in fixed row
    blocks (``fixed_rows``): on the card their batched GEMMs' sums differ
    with the batch's size (the value product's at one query head a kv head,
    olmoe's MHA).  The softmax reads equal at 4 and at 2 rows there, so it
    runs batched."""
    d = qh.shape[-1]
    scores = fixed_rows(_scores, qh.to(torch.float32), ck.to(torch.float32)) / (d**0.5)
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full((), -1e30, device=qh.device))
    p = torch.softmax(scores, dim=-1)
    return fixed_rows(_values, p, cv.to(torch.float32))


#: query rows per chunk of :func:`_chunked_attention` (the reference's)
Q_CHUNK = 1024


def _chunked_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, Skv, KV, D)
    v: torch.Tensor,
    *,
    causal: bool,
    window: Optional[int],
    q_chunk: int = Q_CHUNK,
) -> torch.Tensor:
    """Dense fp32 attention over query chunks (port of the reference's
    ``_chunked_attention``, ``attention.py:81-136``): each chunk sees the
    whole kv, or with a window only the last ``window + chunk`` keys, and
    is recomputed in the backward pass (``torch.utils.checkpoint``, the
    reference's ``jax.checkpoint``), so the live scores are one chunk's
    (B, H, chunk, band).  A sequence that is not a multiple of
    ``q_chunk`` is one chunk.  Returns (B, S, H, Dv) in q's dtype."""
    b, s, h, d = q.shape
    skv, kv_heads, dv = k.shape[1], k.shape[2], v.shape[-1]
    group = h // kv_heads
    scale = 1.0 / (d**0.5)
    qc = q_chunk if s % q_chunk == 0 else s
    kf, vf = k.to(torch.float32), v.to(torch.float32)

    def one_chunk(q, kf, vf, ci: int):
        q_blk = q[:, ci * qc:(ci + 1) * qc].to(torch.float32)
        q_idx = ci * qc + torch.arange(qc, device=q.device)
        start, band = 0, skv
        if window is not None:
            # only the last (window + qc) keys can be visible to this chunk
            band = min(skv, window + qc)
            start = min(max(ci * qc + qc - band, 0), skv - band)
        k_blk, v_blk = kf[:, start:start + band], vf[:, start:start + band]
        k_idx = start + torch.arange(band, device=q.device)
        qh = q_blk.reshape(b, qc, kv_heads, group, d)
        scores = torch.einsum("bqkgd,bskd->bkgqs", qh, k_blk) * scale
        mask = torch.ones((qc, band), dtype=torch.bool, device=q.device)
        if causal:
            mask &= q_idx[:, None] >= k_idx[None, :]
        if window is not None:
            mask &= k_idx[None, :] > q_idx[:, None] - window
        scores = torch.where(mask, scores, torch.full((), -1e30, device=q.device))
        p = torch.softmax(scores, dim=-1)
        out = torch.einsum("bkgqs,bskd->bqkgd", p, v_blk)
        return out.reshape(b, qc, h, dv).to(q.dtype)

    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    outs = [torch.utils.checkpoint.checkpoint(one_chunk, q, kf, vf, ci, use_reentrant=False)
            if grad else one_chunk(q, kf, vf, ci) for ci in range(s // qc)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


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
    h, kv, hd, bias = spec.n_heads, spec.n_kv_heads, spec.head_dim, spec.qkv_bias
    return {
        "wq": dense_init(gen, d, h * hd, device=device, bias=bias),
        "wk": dense_init(gen, d, kv * hd, device=device, bias=bias),
        "wv": dense_init(gen, d, kv * hd, device=device, bias=bias),
        "wo": dense_init(gen, h * hd, d, device=device),
    }


def _ring(x: torch.Tensor, window: int) -> torch.Tensor:
    """A prefill's (B, S, KV, D) rows as a ``window``-row ring with slot(p)
    = p % window: zero-padded when S < window, else the last ``window``
    rows scattered to their slots."""
    b, s = x.shape[:2]
    if s < window:
        return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, window - s))
    ring = torch.zeros((b, window, *x.shape[2:]), dtype=x.dtype, device=x.device)
    ring[:, torch.arange(s - window, s, device=x.device) % window] = x[:, s - window:]
    return ring


@dataclasses.dataclass(frozen=True)
class _Heads:
    """A rank's share of an attention layer under a ``model`` split: query
    heads ``[h0, h1)``, kv heads ``[kv0, kv1)``, and the columns ``[c0, c1)``
    of the (B, S, H*D) attention output its ``wo`` rows read."""

    h0: int
    h1: int
    kv0: int
    kv1: int
    c0: int
    c1: int


def _rank_heads(spec: AttnSpec, so) -> _Heads:
    h, kv, d = spec.n_heads, spec.n_kv_heads, spec.head_dim
    c0, c1 = (0, h * d) if so is None else (so.lo, so.hi)
    h0, h1 = c0 // d, -(-c1 // d)
    g = h // kv
    return _Heads(h0, h1, h0 // g, (h1 - 1) // g + 1, c0, c1)


def cache_heads(spec: AttnSpec, d_model: int, rank: Optional[int] = None) -> Optional[tuple]:
    """The whole kv heads a rank's decode cache holds, in its order, under
    the active mesh's ``model`` split (None: the whole cache, nothing
    split): the kv heads its query heads read (:func:`_rank_heads`), one a
    query head where those straddle kv groups unevenly, as
    :func:`_local_qkv` builds them.  ``rank`` names another rank of the
    axis than this one (the ``wo`` split's extent is every rank's)."""
    h, kv, d = spec.n_heads, spec.n_kv_heads, spec.head_dim
    so = weight_split(("w_qkv", "w_embed"), (h * d, d_model))
    if so is None:  # wq / wk split only where wo does
        return None
    if rank is not None:
        size = so.hi - so.lo
        so = dataclasses.replace(so, lo=rank * size, hi=(rank + 1) * size)
    r = _rank_heads(spec, so)
    g, hl, kvl = h // kv, r.h1 - r.h0, r.kv1 - r.kv0
    if not (kvl == 1 or (r.h0 % g == 0 and hl == kvl * g)):
        return tuple(q // g for q in range(r.h0, r.h1))
    return tuple(range(r.kv0, r.kv1))


def _take_cols(y: torch.Tensor, split, lo: int, hi: int) -> torch.Tensor:
    """Columns ``[lo, hi)`` of a projection's whole output, from this rank's
    output ``y`` (its columns under ``split``, or the whole), gathered over
    ``model`` where the rank does not hold them."""
    if split is not None and (split.lo, split.hi) == (lo, hi):
        return y
    if split is not None:
        y = gather_from_model(y, -1)
    return y[..., lo:hi]


def _local_qkv(params: dict, x: torch.Tensor, ctx: SpringContext, spec: AttnSpec):
    """q (B, S, H', D), k and v (B, S, KV', D) of this rank's heads, the
    ``wo`` split and the rank's :class:`_Heads` (None without a split):
    H' = H, KV' = KV unsplit; else the local heads, with H' a multiple of
    KV' in the standard grouping."""
    b, s, d_model = x.shape
    h, kv, d = spec.n_heads, spec.n_kv_heads, spec.head_dim
    sq = weight_split(("w_embed", "w_qkv"), (d_model, h * d))
    sk = weight_split(("w_embed", "w_qkv"), (d_model, kv * d))
    so = weight_split(("w_qkv", "w_embed"), (h * d, d_model))
    xin = column_input(x, sq, sk)
    wk, wv = params["wk"], params["wv"]
    if sq is not None and sk is None:
        # wk / wv whole on every rank, each rank reading only its kv heads'
        # columns: their gradient is summed over model
        wk, wv = ({n: copy_to_model(t) for n, t in w.items()} for w in (wk, wv))
    q = dense_apply(params["wq"], xin, ctx, sq)
    k = dense_apply(wk, xin, ctx, sk)
    v = dense_apply(wv, xin, ctx, sk)
    if sq is None and sk is None and so is None:
        return q.reshape(b, s, h, d), k.reshape(b, s, kv, d), v.reshape(b, s, kv, d), None, None
    r = _rank_heads(spec, so)
    q = _take_cols(q, sq, r.h0 * d, r.h1 * d).reshape(b, s, r.h1 - r.h0, d)
    k = _take_cols(k, sk, r.kv0 * d, r.kv1 * d).reshape(b, s, r.kv1 - r.kv0, d)
    v = _take_cols(v, sk, r.kv0 * d, r.kv1 * d).reshape(b, s, r.kv1 - r.kv0, d)
    g, hl, kvl = h // kv, r.h1 - r.h0, r.kv1 - r.kv0
    if not (kvl == 1 or (r.h0 % g == 0 and hl == kvl * g)):
        # the query heads straddle kv groups unevenly: one kv head each
        idx = torch.arange(r.h0, r.h1, device=x.device) // g - r.kv0
        k, v = k[:, :, idx], v[:, :, idx]
    return q, k, v, so, r


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
    d = spec.head_dim
    q, k, v, so, heads = _local_qkv(params, x, ctx, spec)
    h, kv = q.shape[2], k.shape[2]
    q = rope_apply(q, positions, spec.rope_theta)
    k = rope_apply(k, positions, spec.rope_theta)

    int8_cache = ctx.int8_cache and spec.window is None
    if cache is None:
        if ctx.attention == "chunked":
            out = _chunked_attention(q, k, v, causal=spec.causal, window=spec.window)
        else:
            # (B,S,H,D) -> (B,H,S,D) views; the output comes back in q's
            # layout, so the transpose back is contiguous again
            out = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  causal=spec.causal, window=spec.window).transpose(1, 2)
        new_cache = None
        if return_cache and int8_cache:
            (kq, ks), (vq, vs) = _q8(k), _q8(v)
            new_cache = {"k_q8": kq, "k_sc": ks, "v_q8": vq, "v_sc": vs}
        elif return_cache:
            kc, vc = k.to(torch.bfloat16), v.to(torch.bfloat16)
            if spec.window is None:
                new_cache = {"k": kc, "v": vc}
            else:
                new_cache = {"k_ring": _ring(kc, spec.window), "v_ring": _ring(vc, spec.window)}
    elif int8_cache:
        if s != 1:
            raise ValueError("decode processes one token per step")
        pos_v = _pos_vec(pos, b, x.device)
        new_cache = {}
        for name, t in (("k", k), ("v", v)):
            lines, scales = _q8(t)
            new_cache[f"{name}_q8"] = _row_update(cache[f"{name}_q8"], lines, pos_v)
            new_cache[f"{name}_sc"] = _row_update(cache[f"{name}_sc"], scales, pos_v)
        qh = q.reshape(b, kv, h // kv, d).to(torch.float32)
        # (B, S, KV) scales -> (B, KV, 1, S), beside the (B, KV, G, S) scores
        k_sc, v_sc = (new_cache[n].to(torch.float32).movedim(1, 2)[:, :, None, :]
                      for n in ("k_sc", "v_sc"))
        scores = fixed_rows(_scores, qh, new_cache["k_q8"].to(torch.float32))
        scores = scores * k_sc / (d**0.5)
        valid = _valid(pos_v, new_cache["k_q8"].shape[1], None)
        scores = torch.where(valid[:, None, None, :], scores,
                             torch.full((), -1e30, device=x.device))
        p = torch.softmax(scores, dim=-1) * v_sc
        out = fixed_rows(_values, p, new_cache["v_q8"].to(torch.float32))
        out = out.reshape(b, 1, h, d).to(x.dtype)
    else:
        if s != 1:
            raise ValueError("decode processes one token per step")
        pos_v = _pos_vec(pos, b, x.device)
        kn, vn = ("k", "v") if spec.window is None else ("k_ring", "v_ring")
        s_max = cache[kn].shape[1]
        slot_v = pos_v if spec.window is None else torch.remainder(pos_v, s_max)
        ck = _row_update(cache[kn], k, slot_v)
        cv = _row_update(cache[vn], v, slot_v)
        qh = q.reshape(b, kv, h // kv, d)
        out = _decode_attend(qh, ck, cv, _valid(pos_v, s_max, spec.window))
        out = out.reshape(b, 1, h, d).to(x.dtype)
        new_cache = {kn: ck, vn: cv}

    out = out.reshape(b, s, h * d)
    if heads is not None:  # the columns this rank's wo rows read
        out = out[..., heads.c0 - heads.h0 * d:heads.c1 - heads.h0 * d]
    out = dense_apply(params["wo"], out, ctx, so)
    return out, new_cache


def gqa_init_cache(batch: int, spec: AttnSpec, max_len: int, dtype=torch.bfloat16,
                   *, device=None, d_model: Optional[int] = None) -> dict:
    """Zero k/v caches of ``max_len`` rows, or for a window spec its
    ``window``-row rings.  ``dtype="int8"``: int8 lines and bf16 scales
    for full attention (rings stay bf16).  Given the layer's ``d_model``,
    under a mesh that splits the layer over ``model`` the cache holds the
    rank's kv heads alone (:func:`cache_heads`)."""
    heads = None if d_model is None else cache_heads(spec, d_model)
    if heads is not None:
        spec = dataclasses.replace(spec, n_kv_heads=len(heads))
    if dtype == "int8" and spec.window is None:
        lines = (batch, max_len, spec.n_kv_heads, spec.head_dim)
        return {"k_q8": torch.zeros(lines, dtype=torch.int8, device=device),
                "k_sc": torch.zeros(lines[:3], dtype=torch.bfloat16, device=device),
                "v_q8": torch.zeros(lines, dtype=torch.int8, device=device),
                "v_sc": torch.zeros(lines[:3], dtype=torch.bfloat16, device=device)}
    if dtype == "int8":
        dtype = torch.bfloat16
    if spec.window is None:
        names, rows = ("k", "v"), max_len
    else:
        names, rows = ("k_ring", "v_ring"), spec.window
    shape = (batch, rows, spec.n_kv_heads, spec.head_dim)
    return {n: torch.zeros(shape, dtype=dtype, device=device) for n in names}


# -- DeepSeek-V2 multi-head latent attention ----------------------------------------


@dataclasses.dataclass(frozen=True)
class MLASpec:
    n_heads: int
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    rope_theta: float = 10000.0


def mla_init(gen: torch.Generator, d: int, spec: MLASpec, *, device=None) -> dict:
    h, rank = spec.n_heads, spec.kv_lora_rank
    return {
        "wq": dense_init(gen, d, h * (spec.qk_nope_dim + spec.qk_rope_dim), device=device),
        "wdkv": dense_init(gen, d, rank, device=device),
        "wkr": dense_init(gen, d, spec.qk_rope_dim, device=device),
        "wuk": dense_init(gen, rank, h * spec.qk_nope_dim, device=device),
        "wuv": dense_init(gen, rank, h * spec.v_head_dim, device=device),
        "wo": dense_init(gen, h * spec.v_head_dim, d, device=device),
    }


def _mla_decode_attend(qn: torch.Tensor, qr: torch.Tensor, ck: torch.Tensor,
                       cr: torch.Tensor, wuk: torch.Tensor, wuv: torch.Tensor,
                       valid: torch.Tensor, scale: float) -> torch.Tensor:
    """The absorbed form: fp32 (B, H, dn) / (B, H, dr) queries against the
    (B, S, rank) latent and (B, S, dr) rope caches' ``valid`` slots, the
    scores and values in the latent space; returns (B, H, dv).  Every
    product runs in fixed row blocks (``fixed_rows``); the softmax runs
    batched."""
    ckf, crf = ck.to(torch.float32), cr.to(torch.float32)
    q_lat = fixed_rows(lambda q: torch.einsum("bhd,rhd->bhr", q, wuk), qn)
    s_lat = fixed_rows(lambda q, c: torch.einsum("bhr,bsr->bhs", q, c), q_lat, ckf)
    s_rope = fixed_rows(lambda q, c: torch.einsum("bhd,bsd->bhs", q, c), qr, crf)
    scores = (s_lat + s_rope) * scale
    scores = torch.where(valid[:, None, :], scores, torch.full((), -1e30, device=qn.device))
    p = torch.softmax(scores, dim=-1)
    ctx_lat = fixed_rows(lambda p, c: torch.einsum("bhs,bsr->bhr", p, c), p, ckf)
    return fixed_rows(lambda c: torch.einsum("bhr,rhd->bhd", c, wuv), ctx_lat)


def mla_apply(
    params: dict,
    x: torch.Tensor,
    ctx: SpringContext,
    spec: MLASpec,
    positions: torch.Tensor,
    cache: Optional[dict] = None,
    pos=None,
    return_cache: bool = False,
):
    """Full-sequence MLA (cache None) or one-token decode against the
    ``{"ckv": (B, S, rank), "krope": (B, S, dr)}`` cache.  Returns
    ``(out, new_cache)``."""
    b, s, d_model = x.shape
    h, dn, dr, dv = spec.n_heads, spec.qk_nope_dim, spec.qk_rope_dim, spec.v_head_dim
    rank = spec.kv_lora_rank
    scale = 1.0 / ((dn + dr) ** 0.5)
    sq, suk, suv, so = _mla_splits(spec, d_model)
    if sq is not None:
        h = (sq.hi - sq.lo) // (dn + dr)  # this rank's heads

    q = dense_apply(params["wq"], column_input(x, sq), ctx, sq).reshape(b, s, h, dn + dr)
    qn, qr = q[..., :dn], rope_apply(q[..., dn:], positions, spec.rope_theta)
    ckv = dense_apply(params["wdkv"], x, ctx)  # (B, S, rank)
    kr = dense_apply(params["wkr"], x, ctx)
    if sq is not None:
        # whole on every rank, read by the rank's heads alone: their
        # gradient is summed over model (here, not on x: wdkv / wkr's own
        # share of x's gradient is whole already)
        ckv, kr = copy_to_model(ckv), copy_to_model(kr)
    krope = rope_apply(kr[:, :, None, :], positions,
                       spec.rope_theta)[:, :, 0, :]  # (B, S, dr), shared across heads
    # the up-projections stay fp32 and unquantized in every mode, as in
    # the reference (raw kernels in einsums, never dense_apply); under a
    # head split, the rank's heads' columns
    wuk = params["wuk"]["kernel"].reshape(rank, h, dn)
    wuv = params["wuv"]["kernel"].reshape(rank, h, dv)

    if cache is None:
        # the standard form: the latent expanded to per-head keys and
        # values, through the chunked attention (q/k D dn + dr, v D dv)
        ckf = ckv.to(torch.float32)
        k_nope = torch.einsum("bsr,rhd->bshd", ckf, wuk).to(x.dtype)
        vh = torch.einsum("bsr,rhd->bshd", ckf, wuv).to(x.dtype)
        k_full = torch.cat([k_nope, krope[:, :, None, :].expand(b, s, h, dr).to(x.dtype)], -1)
        q_full = torch.cat([qn, qr], -1)
        out = _chunked_attention(q_full, k_full, vh, causal=True, window=None)
        out = out.reshape(b, s, h * dv)
        new_cache = None
        if return_cache:
            new_cache = {"ckv": ckv.to(torch.bfloat16), "krope": krope.to(torch.bfloat16)}
    else:
        if s != 1:
            raise ValueError("decode processes one token per step")
        pos_v = _pos_vec(pos, b, x.device)
        ck = _row_update(cache["ckv"], ckv, pos_v)
        cr = _row_update(cache["krope"], krope, pos_v)
        out = _mla_decode_attend(qn[:, 0].to(torch.float32), qr[:, 0].to(torch.float32), ck, cr,
                                 wuk, wuv, _valid(pos_v, ck.shape[1], None), scale)
        out = out.reshape(b, 1, h * dv).to(x.dtype)
        new_cache = {"ckv": ck, "krope": cr}

    out = dense_apply(params["wo"], out, ctx, so)
    return out, new_cache


def _mla_splits(spec: MLASpec, d_model: int) -> tuple:
    """The ``model`` splits of ``wq``, ``wuk``, ``wuv`` (columns) and ``wo``
    (rows) under the active mesh: all four, each by the same whole heads
    (``models.lm.tensor_parallel`` splits an MLA arch only where its heads
    divide), or none."""
    h = spec.n_heads
    splits = (weight_split(("w_embed", "w_qkv"), (d_model, h * (spec.qk_nope_dim
                                                                + spec.qk_rope_dim))),
              weight_split((None, "w_qkv"), (spec.kv_lora_rank, h * spec.qk_nope_dim)),
              weight_split((None, "w_qkv"), (spec.kv_lora_rank, h * spec.v_head_dim)),
              weight_split(("w_qkv", "w_embed"), (h * spec.v_head_dim, d_model)))
    if not any(splits):
        return splits
    sp = next(sp for sp in splits if sp is not None)
    m = sp.full[sp.dim] // (sp.hi - sp.lo)
    if not all(splits) or h % m:
        raise NotImplementedError(f"MLA's {h} heads split over model {m} but not by whole "
                                  "heads")
    return splits


def mla_init_cache(batch: int, spec: MLASpec, max_len: int, dtype=torch.bfloat16,
                   *, device=None) -> dict:
    """Zero latent and rope-key caches of ``max_len`` rows."""
    return {"ckv": torch.zeros((batch, max_len, spec.kv_lora_rank), dtype=dtype, device=device),
            "krope": torch.zeros((batch, max_len, spec.qk_rope_dim), dtype=dtype,
                                 device=device)}
