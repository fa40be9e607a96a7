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
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import SpringContext, dense_apply, dense_init, fixed_rows
from repro_torch.models.ssm import CONV_K, _causal_conv, _softplus

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


def rglru_block_apply(params: dict, x: torch.Tensor, ctx: SpringContext, spec: RGLRUSpec,
                      cache: Optional[dict] = None, return_cache: bool = False):
    """Prefill (cache None; with ``return_cache`` the last CONV_K - 1 raw
    conv inputs and the final state become the decode cache) or one-token
    decode (cache {"conv": (B, CONV_K-1, d_rnn), "h": (B, d_rnn)}).
    Returns ``(out, new_cache)``."""
    s = x.shape[1]
    u = dense_apply(params["wx"], x, ctx)
    y_gate = dense_apply(params["wy"], x, ctx)
    # jax.nn.gelu is the tanh approximation
    y_gate = F.gelu(y_gate.to(torch.float32), approximate="tanh").to(x.dtype)
    w_r, w_i = params["w_r"]["kernel"], params["w_i"]["kernel"]

    if cache is None:
        u_raw = u
        uf = _causal_conv(u, params["conv_w"], params["conv_b"]).to(torch.float32)
        r = torch.sigmoid(torch.matmul(uf, w_r))
        i = torch.sigmoid(torch.matmul(uf, w_i))
        h = _rglru_scan(uf, r, i, params["lam"])
        new_cache = None
        if return_cache:
            new_cache = {"conv": u_raw[:, s - (CONV_K - 1):].to(torch.bfloat16),
                         "h": h[:, -1].to(torch.bfloat16)}
    else:
        if s != 1:
            raise ValueError("decode processes one token per step")
        conv_state = torch.cat([cache["conv"], u.to(cache["conv"].dtype)], dim=1)  # (B,K,dr)
        uf = fixed_rows(lambda c: _conv_sum(c, params["conv_w"]),
                        conv_state.to(torch.float32)) + params["conv_b"]  # (B, dr)
        r = torch.sigmoid(fixed_rows(lambda t: torch.matmul(t, w_r), uf))
        i = torch.sigmoid(fixed_rows(lambda t: torch.matmul(t, w_i), uf))
        a, norm = _gates(params["lam"], r)
        h1 = a * cache["h"].to(torch.float32) + norm * (i * uf)
        h = h1[:, None, :]
        new_cache = {"conv": conv_state[:, 1:], "h": h1.to(cache["h"].dtype)}

    out = dense_apply(params["wo"], h.to(x.dtype) * y_gate, ctx)
    return out, new_cache


def rglru_init_cache(batch: int, spec: RGLRUSpec, dtype=torch.bfloat16, *, device=None) -> dict:
    return {
        "conv": torch.zeros((batch, CONV_K - 1, spec.d_rnn), dtype=dtype, device=device),
        "h": torch.zeros((batch, spec.d_rnn), dtype=dtype, device=device),
    }
