"""RG-LRU recurrent block (Griffin / RecurrentGemma) [arXiv:2402.19427]
(port of ``repro/models/recurrent.py``).

recurrentgemma-9b's layers alternate 2 recurrent blocks to 1
local-attention block.  The recurrent temporal-mixing block is:

    x -> linear_x -> causal conv(4) -> RG-LRU ----\\
    x -> linear_y -> GeLU -----------------------(*)--> linear_out

RG-LRU: r_t = sigmoid(W_r u); i_t = sigmoid(W_i u);
        a_t = exp(-c * softplus(L) * r_t);
        h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

``wx``, ``wy`` and ``wo`` go through ``dense_apply`` (so ``masked_matmul``
on the card); ``w_r`` and ``w_i`` are plain fp32 products, as in the
reference.  Prefill runs the recurrence as :func:`_associative_scan`, the
reference's ``jax.lax.associative_scan`` (log depth, its combine order);
decode is the one-step recurrence on an O(1) state, the conv window of
the last ``CONV_K - 1`` raw inputs and ``h`` rounded to bf16 after every
step.  Decode's reductions (the conv sum, the ``w_r`` / ``w_i`` products)
run in fixed row blocks (``layers.fixed_rows``), so a row's state does
not depend on the batch's size.

Under a mesh that splits weights over ``model`` (``dist.tensor``), ``wx``
and ``wy`` are column shards: a rank holds ``d_rnn / m`` channels
(``[lo, hi)``) and runs the conv, the gates' elementwise work and the scan
on them, with its slices of the whole ``conv_w``, ``conv_b`` and ``lam``
(their gradients summed over ``model``).  ``w_r`` and ``w_i`` are column
shards that read the whole conv output, gathered over ``model``; ``wo`` is
a row shard, summed over ``model``.  The ``conv`` and ``h`` states hold
the rank's channels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist.tensor import column_input, copy_to_model, gather_from_model
from repro_torch.models.layers import SpringContext, dense_apply, dense_init, fixed_rows
from repro_torch.models.ssm import CONV_K, _causal_conv, _softplus
from repro_torch.runtime.sharding import weight_split

RGLRU_C = 8.0


@dataclasses.dataclass(frozen=True)
class RGLRUSpec:
    d_rnn: int  # lru width


def rglru_block_init(gen: torch.Generator, d: int, spec: RGLRUSpec, *, device=None) -> dict:
    dr = spec.d_rnn
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wx": dense_init(gen, d, dr, device=device),
        "wy": dense_init(gen, d, dr, device=device),
        "conv_w": torch.randn((CONV_K, dr), generator=gen, **f32).mul_(0.2),
        "conv_b": torch.zeros((dr,), **f32),
        "w_r": dense_init(gen, dr, dr, device=device),
        "w_i": dense_init(gen, dr, dr, device=device),
        # Lambda init so a^c in [0.9, 0.999] at r=1 (Griffin appendix)
        "lam": torch.log(torch.expm1(torch.linspace(0.9, 4.0, dr, **f32))),
        "wo": dense_init(gen, dr, d, device=device),
    }


def _combine(x: tuple, y: tuple) -> tuple:
    """(a2, b2) o (a1, b1) = (a1 a2, a2 b1 + b2): x earlier, y later."""
    a1, b1 = x
    a2, b2 = y
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    out = torch.empty((even.shape[0], even.shape[1] + odd.shape[1], *even.shape[2:]),
                      dtype=even.dtype, device=even.device)
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _associative_scan(elems: tuple) -> tuple:
    """Inclusive scan of :func:`_combine` over axis 1, the recursion of
    ``jax.lax.associative_scan``: combine adjacent pairs, scan the half
    recursively (the odd outputs), combine those with the even inputs, and
    interleave.  Depth log2(S); each level is a few elementwise passes."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    reduced = _combine(tuple(e[:, 0:n - 1:2] for e in elems), tuple(e[:, 1::2] for e in elems))
    odd = _associative_scan(reduced)
    if n % 2 == 0:
        even = _combine(tuple(e[:, :-1] for e in odd), tuple(e[:, 2::2] for e in elems))
    else:
        even = _combine(odd, tuple(e[:, 2::2] for e in elems))
    even = tuple(torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even))
    return tuple(_interleave(ev, od) for ev, od in zip(even, odd))


def _gates(lam: torch.Tensor, r: torch.Tensor) -> tuple:
    """(a, sqrt(1 - a^2)) for the recurrence gate ``r``."""
    log_a = -RGLRU_C * _softplus(lam) * r  # negative
    a = torch.exp(log_a)
    return a, torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 1e-12, 1.0))


def _rglru_scan(u: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
                lam: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t over the seq axis; u, r, i: (B, S, D) fp32."""
    a, norm = _gates(lam, r)
    b = norm * (i * u)
    return _associative_scan((a, b))[1]


def _conv_sum(state: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (state * w[None]).sum(dim=1)


def _splits(spec: RGLRUSpec, d_model: int) -> tuple:
    """``wx`` / ``wy``'s and ``wo``'s splits over ``model`` (or None);
    ``w_r`` / ``w_i`` split their columns with ``wx``'s."""
    dr = spec.d_rnn
    return (weight_split(("w_embed", "w_mlp"), (d_model, dr)),
            # the tree's rule for a "wo" leaf (the reference's layer names
            # w_mlp; both map onto model)
            weight_split(("w_qkv", "w_embed"), (dr, d_model)))


def rglru_block_apply(params: dict, x: torch.Tensor, ctx: SpringContext, spec: RGLRUSpec,
                      cache: Optional[dict] = None, return_cache: bool = False):
    """Prefill (cache None; with ``return_cache`` the last CONV_K - 1 raw
    conv inputs and the final state become the decode cache) or one-token
    decode (cache {"conv": (B, CONV_K-1, D), "h": (B, D)}, D the rank's
    channels of ``d_rnn``).  Returns ``(out, new_cache)``."""
    s = x.shape[1]
    sx, so = _splits(spec, x.shape[-1])
    xin = column_input(x, sx)
    u = dense_apply(params["wx"], xin, ctx, sx)
    y_gate = dense_apply(params["wy"], xin, ctx, sx)
    # jax.nn.gelu is the tanh approximation
    y_gate = F.gelu(y_gate.to(torch.float32), approximate="tanh").to(x.dtype)
    w_r, w_i = params["w_r"]["kernel"], params["w_i"]["kernel"]
    conv_w, conv_b, lam = params["conv_w"], params["conv_b"], params["lam"]
    if sx is not None:  # the rank's channels of the whole leaves
        conv_w, conv_b, lam = (copy_to_model(t).narrow(-1, sx.lo, sx.hi - sx.lo)
                               for t in (conv_w, conv_b, lam))

    def whole(t):  # w_r / w_i read every channel
        return t if sx is None else gather_from_model(t, -1)

    if cache is None:
        u_raw = u
        uf = _causal_conv(u, conv_w, conv_b).to(torch.float32)
        uw = whole(uf)
        r = torch.sigmoid(torch.matmul(uw, w_r))
        i = torch.sigmoid(torch.matmul(uw, w_i))
        h = _rglru_scan(uf, r, i, lam)
        new_cache = None
        if return_cache:
            new_cache = {"conv": u_raw[:, s - (CONV_K - 1):].to(torch.bfloat16),
                         "h": h[:, -1].to(torch.bfloat16)}
    else:
        if s != 1:
            raise ValueError("decode processes one token per step")
        conv_state = torch.cat([cache["conv"], u.to(cache["conv"].dtype)], dim=1)  # (B,K,D)
        uf = fixed_rows(lambda c: _conv_sum(c, conv_w),
                        conv_state.to(torch.float32)) + conv_b  # (B, D)
        uw = whole(uf)
        r = torch.sigmoid(fixed_rows(lambda t: torch.matmul(t, w_r), uw))
        i = torch.sigmoid(fixed_rows(lambda t: torch.matmul(t, w_i), uw))
        a, norm = _gates(lam, r)
        h1 = a * cache["h"].to(torch.float32) + norm * (i * uf)
        h = h1[:, None, :]
        new_cache = {"conv": conv_state[:, 1:], "h": h1.to(cache["h"].dtype)}

    out = dense_apply(params["wo"], h.to(x.dtype) * y_gate, ctx, so)
    return out, new_cache


def rglru_init_cache(batch: int, spec: RGLRUSpec, dtype=torch.bfloat16, *, device=None,
                     d_model: Optional[int] = None) -> dict:
    """Zero decode state.  Given the layer's ``d_model``, under a mesh that
    splits the layer over ``model`` it holds the rank's channels."""
    sx = None if d_model is None else _splits(spec, d_model)[0]
    dr = spec.d_rnn if sx is None else sx.hi - sx.lo
    return {
        "conv": torch.zeros((batch, CONV_K - 1, dr), dtype=dtype, device=device),
        "h": torch.zeros((batch, dr), dtype=dtype, device=device),
    }
