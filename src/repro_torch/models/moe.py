"""Mixture-of-Experts FFN with capacity-bounded top-k dispatch (port of
``repro/models/moe.py``).

olmoe-1b-7b (64 experts, top-8) and deepseek-v2-lite-16b (64 routed
experts, top-6, plus 2 shared).  As in the reference (GShard style), each
call routes its T tokens to a static capacity of

    C = max(int(T * top_k / E * capacity_factor + 0.999), 4)

rows per expert, computed with Python floats.  Priority is token-major
over the flattened (T * top_k) assignments (a cumulative count of
one-hots); an assignment past its expert's capacity is dropped: it is not
dispatched, and its combine weight is 0 (``moe.py:104-149``).

  * router: a plain fp32 product, outside any kernel, as in the reference
    (``moe.py:110-112``); ``jax.lax.top_k``'s order (descending, the
    lower index first on a tie) is a stable descending sort's first
    ``top_k`` entries;
  * dispatch: the kept assignments are scattered into an (E, C, d)
    buffer, the dropped ones into a spare expert row that is cut off (the
    reference's out-of-range expert with ``mode="drop"``);
  * experts: in the quantized modes, one ``spring_matmul`` per expert
    and matrix (the reference's ``lax.map``), so every expert product
    runs on the ``masked_matmul`` kernel on the card: the skinny kernel
    at decode (C = 4), the tile kernel at prefill.  An expert whose
    capacity no token reached has an all-zero operand, whose tiles the
    kernel skips.  The dense mode is the reference's batched bf16
    ``einsum`` (fp32 products and sums, one rounding to bf16);
  * combine: the gather reads ``out[where(keep, e, 0), safe_pos]`` with
    weight 0 for a dropped assignment, as the reference does, so a
    non-finite value propagates alike.

For one position per row (a decode step) the routing runs in fixed row
blocks (``layers.fixed_rows``) and the combine is elementwise, so a row's
result does not depend on how many rows the batch has.  The load-balancing aux loss is
the reference's ``E * sum_e mean(probs)_e * count_e / (T * top_k)``.
Token streams longer than :data:`MOE_TOKEN_CHUNK` are cut into chunks
along the sequence, each recomputed in the backward pass, and the aux
losses averaged (``moe.py:90-103``).

Training differentiates all of it, as the reference's ``jax.grad`` does:
the router through the gates and the aux loss, the experts through their
products' dX / dW kernels at the capacity's M; an expert that no token
reached runs on zero rows, so its weight gradients are exactly 0.

Expert parallelism: under a mesh that splits the expert leaves over
``model`` (the ``w_experts`` rule on dim 0), rank r holds experts ``[r
E/m, (r+1) E/m)``.  The routing, the positions, ``keep`` and the aux
loss run replicated, the same bits on every rank.  The tokens enter the
dispatch through ``dist.tensor.copy_to_model`` (its backward sums the
(T, d) gradient, not the (E, C, d) buffer's); a rank scatters only its
own experts' kept assignments into an (E/m + 1, C, d) buffer, the spare
row taking the rest, and runs its experts on the rows, and with the
weights, the unsharded run gives them, so every expert product gets the
same bits.  Its SR draws skip the other ranks' experts' sites
(``KeyGen.skip``), so every site draws what it draws unsharded.  The
outputs are gathered along the expert dim in rank order
(``dist.tensor.gather_whole``: every rank combines the whole buffer, so
its backward hands each rank its slice unsummed) and the combine runs
unchanged.  The shared experts split as a SwiGLU MLP does.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.core.spring_ops import DENSE_DTYPE, matmul_draws, spring_matmul
from repro_torch.dist.tensor import copy_to_model, gather_whole
from repro_torch.kernels.masked_matmul.ops import record_tile_skip
from repro_torch.models.layers import (SpringContext, dense_init, fixed_rows, randn,
                                       swiglu_apply, swiglu_init)
from repro_torch.runtime.sharding import in_context, weight_split


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden
    n_shared: int = 0  # shared (always-on) experts, deepseek-style
    shared_d_ff: int = 0
    capacity_factor: float = 1.25


def moe_init(gen: torch.Generator, d: int, spec: MoESpec, *, device=None) -> dict:
    e, f = spec.n_experts, spec.d_ff

    def normal(shape, scale):
        return randn(shape, gen, device).mul_(scale)

    p = {
        "router": dense_init(gen, d, e, device=device, scale=0.02),
        "w_gate": normal((e, d, f), 1.0 / d**0.5),
        "w_up": normal((e, d, f), 1.0 / d**0.5),
        "w_down": normal((e, f, d), 1.0 / f**0.5),
    }
    if spec.n_shared:
        p["shared"] = swiglu_init(gen, d, spec.shared_d_ff * spec.n_shared, device=device)
    return p


def _silu(g: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` in fp32, back in g's dtype."""
    gf = g.to(torch.float32)
    return (gf * torch.sigmoid(gf)).to(g.dtype)


def _dense_bmm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The reference's bf16 ``einsum`` on the CPU before its rounding:
    bf16 operands, fp32 products and sums."""
    return torch.bmm(a.to(DENSE_DTYPE).to(torch.float32), w.to(DENSE_DTYPE).to(torch.float32))


def _expert_ffn(buf: torch.Tensor, params: dict, ctx: SpringContext,
                skip: tuple = (0, 0)) -> torch.Tensor:
    """(E', C, d) -> (E', C, d): each expert's SwiGLU under the SPRING
    numerics (one ``spring_matmul`` per expert and matrix), over the E'
    experts this rank holds; ``skip`` counts the experts before and after
    them, whose SR draws are skipped."""
    w_gate, w_up, w_down = params["w_gate"], params["w_up"], params["w_down"]
    if ctx.cfg.mode == "dense":
        # the reference's jitted program feeds the gate product to silu
        # in fp32: XLA drops the bf16 round trip of ``g.astype(f32)``
        g = _dense_bmm(buf, w_gate)
        u = _dense_bmm(buf, w_up).to(DENSE_DTYPE)
        return _dense_bmm(_silu(g).to(DENSE_DTYPE) * u, w_down).to(DENSE_DTYPE)

    def one(b, wg, wu, wd):
        g = spring_matmul(b, wg, ctx.cfg, ctx.keys)
        u = spring_matmul(b, wu, ctx.cfg, ctx.keys)
        return spring_matmul(_silu(g) * u, wd, ctx.cfg, ctx.keys)

    draws = 3 * matmul_draws(ctx.cfg, ctx.keys)
    if draws:
        ctx.keys.skip(skip[0] * draws)
    out = torch.stack([one(buf[i], w_gate[i], w_up[i], w_down[i])
                       for i in range(buf.shape[0])])
    if draws:
        ctx.keys.skip(skip[1] * draws)
    return out


#: cap on the tokens of one dispatch (the reference's, ``moe.py:78``)
MOE_TOKEN_CHUNK = 32768

_ROUTING: Optional[list] = None


@contextlib.contextmanager
def record_routing():
    """Inside the block, every unchunked :func:`moe_apply` call appends
    ``{"tokens", "capacity", "gate_idx", "keep", "tile_steps"}`` to the
    yielded list: its token count T, its capacity, the (T, top_k) experts
    each token was routed to and whether each assignment was kept (on
    the device), and the expert products' ``[issued, total]`` tile steps
    at the kernel's tiles (``masked_matmul.record_tile_skip``; None in
    the dense mode; under expert parallelism this rank's experts' alone).
    The tile records cost a host sync a product, so this is off unless
    asked for."""
    global _ROUTING
    prev, _ROUTING = _ROUTING, []
    try:
        yield _ROUTING
    finally:
        _ROUTING = prev


def _route(flat: torch.Tensor, router: torch.Tensor, k: int) -> torch.Tensor:
    """(T, d) fp32 tokens -> (T, E + 2k): the softmax of the router
    logits, then the top-k gate values (renormalized) and expert ids
    (as floats), descending, the lower id first on a tie."""
    probs = torch.softmax(torch.matmul(flat, router), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    vals = vals / (vals.sum(-1, keepdim=True) + 1e-9)
    return torch.cat([probs, vals, idx.to(torch.float32)], dim=-1)


def _combine(gathered: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(T, k, d) expert outputs weighted by (T, k) gates, summed over k:
    the reference's ``einsum`` on the CPU, a chain of fused multiply-adds
    in slot order, each rounded once to fp32 (an fp32 product is exact in
    fp64).  Elementwise, so a row's sum reads no other row."""
    acc = gathered[:, 0] * w[:, :1]
    for j in range(1, gathered.shape[1]):
        acc = torch.addcmul(acc.double(), gathered[:, j].double(), w[:, j:j + 1].double()
                            ).float()
    return acc


def moe_apply(params: dict, x: torch.Tensor, ctx: SpringContext,
              spec: MoESpec) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> ((B, S, d), the aux load-balancing loss)."""
    b, s, d = x.shape
    if b * s > MOE_TOKEN_CHUNK and s % 2 == 0:
        nc, tc = 1, s
        while b * tc > MOE_TOKEN_CHUNK and tc % 2 == 0:
            tc //= 2
            nc *= 2
        grad = torch.is_grad_enabled()
        ys, auxs = [], []
        for i in range(nc):
            xc = x[:, i * tc:(i + 1) * tc]
            y_i, a_i = (torch.utils.checkpoint.checkpoint(in_context(moe_apply), params, xc,
                                                          ctx, spec, use_reentrant=False)
                        if grad else moe_apply(params, xc, ctx, spec))
            ys.append(y_i)
            auxs.append(a_i)
        return torch.cat(ys, dim=1), torch.stack(auxs).mean()
    t = b * s
    e, k = spec.n_experts, spec.top_k
    cap = max(int((t * k / e) * spec.capacity_factor + 0.999), 4)

    flat = x.reshape(t, d)
    router = params["router"]["kernel"]
    # one position per row (decode): the routing in fixed row blocks
    flat32 = flat.to(torch.float32)
    routed = (fixed_rows(lambda r: _route(r, router, k), flat32) if s == 1
              else _route(flat32, router, k))
    probs, gate_vals = routed[:, :e], routed[:, e:e + k]
    gate_idx = routed[:, e + k:].to(torch.int64)  # (T, k)

    # position of each (token, slot) within its expert: the assignments
    # before it in flattened token-major order
    flat_idx = gate_idx.reshape(-1)
    flat_oh = F.one_hot(flat_idx, e)  # (T*k, E)
    pos = (torch.cumsum(flat_oh, dim=0) - flat_oh).gather(1, flat_idx[:, None]).reshape(t, k)
    counts = flat_oh.sum(dim=0).to(torch.float32)
    aux = e * torch.sum(probs.mean(dim=0) * (counts / (t * k)))

    keep = pos < cap
    safe_pos = torch.where(keep, pos, cap - 1).reshape(-1)
    # this rank's experts [lo, hi) (all of them unsplit)
    split = weight_split(("w_experts", "w_embed", None), (e, d, spec.d_ff))
    lo, hi = (0, e) if split is None else (split.lo, split.hi)
    mine = keep & (gate_idx >= lo) & (gate_idx < hi)
    src = flat if split is None else copy_to_model(flat)
    # a dropped assignment, or another rank's, goes to the spare row, cut off below
    buf = torch.zeros((hi - lo + 1, cap, d), dtype=flat.dtype, device=x.device)
    buf[torch.where(mine, gate_idx - lo, hi - lo).reshape(-1), safe_pos] = \
        src.repeat_interleave(k, dim=0)
    if _ROUTING is None:
        out_buf = _expert_ffn(buf[:hi - lo], params, ctx, (lo, e - hi))
    else:
        with record_tile_skip() as steps:
            out_buf = _expert_ffn(buf[:hi - lo], params, ctx, (lo, e - hi))
        _ROUTING.append({"tokens": t, "capacity": cap, "gate_idx": gate_idx, "keep": keep,
                         "tile_steps": steps.get("masked_matmul")})
    if split is not None:
        out_buf = gather_whole(out_buf, 0)

    gathered = out_buf[torch.where(keep, gate_idx, 0).reshape(-1), safe_pos]
    gathered = gathered.reshape(t, k, d).to(torch.float32)
    w = torch.where(keep, gate_vals, torch.zeros((), device=x.device))
    y = _combine(gathered, w).reshape(b, s, d).to(x.dtype)
    if spec.n_shared:
        y = y + swiglu_apply(params["shared"], x, ctx, spec.shared_d_ff * spec.n_shared)
    return y, aux
