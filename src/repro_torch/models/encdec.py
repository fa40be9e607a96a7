"""Whisper-style encoder-decoder backbone (port of ``repro/models/encdec.py``;
whisper-medium, arXiv:2212.04356).  The conv / mel front end is a stub, as
in the reference: the encoder takes precomputed (B, S_enc, d) frame
embeddings.

Encoder: non-causal self-attention and a GELU MLP, pre-LayerNorm, a
sinusoidal position table (``[sin | cos]`` concatenated).  Decoder: causal
self-attention, cross-attention to the encoder states, a GELU MLP.  The
attention blocks are bias-free MHA whose projections run through
``dense_apply`` (``spring_matmul``); full-sequence attention is the port's
:func:`~repro_torch.models.attention._chunked_attention`, as the
reference's is, never ``flash_attention``.  The layers are stacked along a
leading axis, as the reference's ``lax.scan`` stacks them, so a JAX
parameter tree maps one to one (``convert.encdec_params_from_jax``).

Serving (the static path): :func:`encdec_init_cache` runs the encoder once
and projects every decoder layer's cross K/V (bf16); the self K/V start
empty at ``max_len`` rows.  :func:`encdec_decode_step` writes the new
token's self K/V at ``pos`` and attends in fp32 over all ``max_len`` rows
with the rows past ``pos`` masked to -1e30, then over the fixed cross
K/V; the logits are an fp32 product with the tied embedding, a plain
``torch.matmul`` as the reference's lies outside any kernel.

Training (:func:`encdec_loss`, which ``runtime.train.make_train_step``
calls with the batch's ``frames``): under ``EncDecConfig.remat`` each
encoder and decoder layer is recomputed in the backward pass
(``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` of
its scan body does.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

from repro_torch.models.attention import AttnSpec, _chunked_attention
from repro_torch.models.layers import (SpringContext, dense_apply, dense_init, embed_apply,
                                        embed_init, gelu_mlp_apply, gelu_mlp_init,
                                        layernorm_apply, layernorm_init)
from repro_torch.models.losses import chunked_softmax_xent
from repro_torch.optim.optimizers import tree_map


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    name: str
    d_model: int
    vocab: int
    n_enc_layers: int
    n_dec_layers: int
    n_heads: int
    d_ff: int
    enc_seq: int = 1500  # whisper's 30 s at 50 Hz after the conv stem
    remat: bool = True
    scan_unroll: bool = False
    supports_long_context: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def attn(self) -> AttnSpec:
        return AttnSpec(self.n_heads, self.n_heads, self.head_dim, causal=True)


def _sinusoid(seq: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


def _mha_init(gen: torch.Generator, d: int, *, device=None) -> dict:
    return {name: dense_init(gen, d, d, device=device) for name in ("wq", "wk", "wv", "wo")}


def _project_qkv(params: dict, xq: torch.Tensor, xkv: torch.Tensor, ctx: SpringContext,
                 n_heads: int) -> tuple:
    b, sq, d = xq.shape
    skv, hd = xkv.shape[1], d // n_heads
    q = dense_apply(params["wq"], xq, ctx).reshape(b, sq, n_heads, hd)
    k = dense_apply(params["wk"], xkv, ctx).reshape(b, skv, n_heads, hd)
    v = dense_apply(params["wv"], xkv, ctx).reshape(b, skv, n_heads, hd)
    return q, k, v


def _mha(params: dict, xq: torch.Tensor, xkv: torch.Tensor, ctx: SpringContext, n_heads: int,
         causal: bool) -> torch.Tensor:
    q, k, v = _project_qkv(params, xq, xkv, ctx, n_heads)
    out = _chunked_attention(q, k, v, causal=causal, window=None)
    b, sq, h, hd = out.shape
    return dense_apply(params["wo"], out.reshape(b, sq, h * hd), ctx)


def _stack(layers: list) -> dict:
    return tree_map(lambda *xs: torch.stack(xs), *layers)


def _layer(stacked: dict, i: int) -> dict:
    return tree_map(lambda t: t[i], stacked)


def _layers(cfg: EncDecConfig, body, x: torch.Tensor, stacked: dict, n: int) -> torch.Tensor:
    """``x = body(x, layer i)`` for each of the ``n`` stacked layers, each
    recomputed in the backward pass under ``cfg.remat``."""
    for i in range(n):
        lp = _layer(stacked, i)
        if cfg.remat and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(body, x, lp, use_reentrant=False)
        else:
            x = body(x, lp)
    return x


def encdec_init(cfg: EncDecConfig, seed: int = 0, *, device="cuda") -> dict:
    """Random parameters from ``seed`` on ``device`` (a ``torch.Generator``
    there; :func:`repro_torch.convert.encdec_params_from_jax` carries a JAX
    init across)."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    d = cfg.d_model

    def enc_layer():
        return {"ln1": layernorm_init(d, device=device),
                "attn": _mha_init(gen, d, device=device),
                "ln2": layernorm_init(d, device=device),
                "mlp": gelu_mlp_init(gen, d, cfg.d_ff, device=device)}

    def dec_layer():
        return {"ln1": layernorm_init(d, device=device),
                "self_attn": _mha_init(gen, d, device=device),
                "ln2": layernorm_init(d, device=device),
                "cross_attn": _mha_init(gen, d, device=device),
                "ln3": layernorm_init(d, device=device),
                "mlp": gelu_mlp_init(gen, d, cfg.d_ff, device=device)}

    return {
        "enc_in": dense_init(gen, d, d, device=device),  # the stub front end's adapter
        "enc_layers": _stack([enc_layer() for _ in range(cfg.n_enc_layers)]),
        "enc_ln": layernorm_init(d, device=device),
        "embed": embed_init(gen, cfg.vocab, d, device=device),
        "dec_layers": _stack([dec_layer() for _ in range(cfg.n_dec_layers)]),
        "dec_ln": layernorm_init(d, device=device),
    }


def encode(params: dict, cfg: EncDecConfig, frames: torch.Tensor,
           ctx: SpringContext) -> torch.Tensor:
    """(B, S_enc, d) stub frame embeddings -> the encoder states."""
    x = dense_apply(params["enc_in"], frames, ctx)
    x = x + _sinusoid(frames.shape[1], cfg.d_model, x.device).to(x.dtype)[None]

    def body(h, lp):
        hn = layernorm_apply(lp["ln1"], h)
        h = h + _mha(lp["attn"], hn, hn, ctx, cfg.n_heads, causal=False)
        return h + gelu_mlp_apply(lp["mlp"], layernorm_apply(lp["ln2"], h), ctx)

    x = _layers(cfg, body, x, params["enc_layers"], cfg.n_enc_layers)
    return layernorm_apply(params["enc_ln"], x)


def decode_hidden(params: dict, cfg: EncDecConfig, tokens: torch.Tensor,
                  enc_out: torch.Tensor, ctx: SpringContext) -> torch.Tensor:
    """The teacher-forced decoder pass (the loss, the prefill step)."""
    x = embed_apply(params["embed"], tokens, ctx)
    x = x + _sinusoid(tokens.shape[1], cfg.d_model, x.device).to(x.dtype)[None]

    def body(h, lp):
        hn = layernorm_apply(lp["ln1"], h)
        h = h + _mha(lp["self_attn"], hn, hn, ctx, cfg.n_heads, causal=True)
        h = h + _mha(lp["cross_attn"], layernorm_apply(lp["ln2"], h), enc_out, ctx,
                     cfg.n_heads, causal=False)
        return h + gelu_mlp_apply(lp["mlp"], layernorm_apply(lp["ln3"], h), ctx)

    x = _layers(cfg, body, x, params["dec_layers"], cfg.n_dec_layers)
    return layernorm_apply(params["dec_ln"], x)


def encdec_loss(params: dict, cfg: EncDecConfig, frames: torch.Tensor, tokens: torch.Tensor,
                ctx: SpringContext) -> tuple:
    """Next-token cross-entropy of the teacher-forced decoder; (ce, {"ce"})."""
    enc_out = encode(params, cfg, frames, ctx)
    h = decode_hidden(params, cfg, tokens, enc_out, ctx)
    b, s, _ = h.shape
    total = chunked_softmax_xent(h[:, :-1], tokens[:, 1:], params["embed"]["embedding"].t())
    ce = total / (b * (s - 1))
    return ce, {"ce": ce}


# -- serving ----------------------------------------------------------------------


def encdec_init_cache(params: dict, cfg: EncDecConfig, frames: torch.Tensor,
                      ctx: SpringContext, max_len: int, dtype=torch.bfloat16) -> dict:
    """Run the encoder once, project every decoder layer's cross K/V, and
    make empty self K/V of ``max_len`` rows: ``{"pos", "cross": {"k",
    "v"}, "self": {"k", "v"}}``, each leaf (L, B, S, H, hd)."""
    return cross_cache(params, cfg, encode(params, cfg, frames, ctx), ctx, max_len, dtype)


def cross_cache(params: dict, cfg: EncDecConfig, enc_out: torch.Tensor, ctx: SpringContext,
                max_len: int, dtype=torch.bfloat16) -> dict:
    """:func:`encdec_init_cache` from the encoder states ``enc_out``."""
    b, s = enc_out.shape[:2]
    h, hd, n = cfg.n_heads, cfg.head_dim, cfg.n_dec_layers
    cross = params["dec_layers"]["cross_attn"]
    kv = {name: torch.stack([
        dense_apply(_layer(cross[w], i), enc_out, ctx).reshape(b, s, h, hd).to(dtype)
        for i in range(n)]) for name, w in (("k", "wk"), ("v", "wv"))}
    zeros = torch.zeros((n, b, max_len, h, hd), dtype=dtype, device=enc_out.device)
    return {"pos": torch.zeros((), dtype=torch.int64, device=enc_out.device),
            "cross": kv, "self": {"k": zeros, "v": zeros.clone()}}


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid=None) -> torch.Tensor:
    """fp32 attention of (B, H, hd) queries over (B, S, H, hd) keys and
    values, the (S,) ``valid`` rows only (None: all)."""
    scores = torch.einsum("bhd,bshd->bhs", q.to(torch.float32),
                          k.to(torch.float32)) / q.shape[-1]**0.5
    if valid is not None:
        scores = torch.where(valid[None, None], scores, torch.full((), -1e30, device=q.device))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, v.to(torch.float32))


def encdec_decode_step(params: dict, cfg: EncDecConfig, tokens: torch.Tensor, cache: dict,
                       ctx: SpringContext) -> tuple:
    """One decode token per row against the self K/V and the fixed cross
    K/V; returns (logits (B, V) fp32, the new cache)."""
    pos = cache["pos"]
    b, h, hd, d = tokens.shape[0], cfg.n_heads, cfg.head_dim, cfg.d_model
    max_len = cache["self"]["k"].shape[2]
    x = embed_apply(params["embed"], tokens[:, None], ctx)
    x = x + _sinusoid(max_len, d, x.device)[pos].to(x.dtype)[None, None]
    valid = torch.arange(max_len, device=x.device) <= pos
    sks, svs = [], []
    for i in range(cfg.n_dec_layers):
        lp = _layer(params["dec_layers"], i)
        hq = layernorm_apply(lp["ln1"], x)
        q, k, v = _project_qkv(lp["self_attn"], hq, hq, ctx, h)
        sk, sv = cache["self"]["k"][i].clone(), cache["self"]["v"][i].clone()
        sk[:, pos] = k[:, 0].to(sk.dtype)
        sv[:, pos] = v[:, 0].to(sv.dtype)
        sa = _attend(q[:, 0], sk, sv, valid).reshape(b, 1, d).to(x.dtype)
        x = x + dense_apply(lp["self_attn"]["wo"], sa, ctx)
        hq = layernorm_apply(lp["ln2"], x)
        q = dense_apply(lp["cross_attn"]["wq"], hq, ctx).reshape(b, 1, h, hd)
        ca = _attend(q[:, 0], cache["cross"]["k"][i], cache["cross"]["v"][i])
        x = x + dense_apply(lp["cross_attn"]["wo"], ca.reshape(b, 1, d).to(x.dtype), ctx)
        x = x + gelu_mlp_apply(lp["mlp"], layernorm_apply(lp["ln3"], x), ctx)
        sks.append(sk)
        svs.append(sv)
    x = layernorm_apply(params["dec_ln"], x)
    logits = torch.matmul(x[:, 0].to(torch.float32),
                          params["embed"]["embedding"].t().to(torch.float32))
    new_cache = {"pos": pos + 1, "cross": cache["cross"],
                 "self": {"k": torch.stack(sks), "v": torch.stack(svs)}}
    return logits, new_cache
