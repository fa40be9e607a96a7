"""The stash/restore autograd pair (port of ``repro/memstash/stash.py``).

``stash_apply`` runs a block ``f(x, aux)`` whose saved tensor for the
backward pass is the *compressed* input instead of the block's dense
intermediates:

  forward:  y = f(x, aux) without a graph;  saved = compress(x), aux
  backward: x = decompress(saved);  recompute f(x, aux) with a graph;
            gradients of that recompute against the cotangent

i.e. remat from the compressed input.  The restore is bit-exact, so dense-mode gradients are bit-identical to the unstashed
program.  Quantized modes draw fresh SR seeds in the recompute (the
block's ``KeyGen`` moves on), the same caveat the reference has with its
re-traced keys (``memstash/stash.py:17-20``).

``checkpoint_apply`` dispatches one stash point through the per-layer
policy: "none" (autograd keeps the dense residuals), "remat"
(``torch.utils.checkpoint``), or "stash" (this wrapper).
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.memstash.config import STASH_POLICIES, MemstashConfig
from repro_torch.memstash.format import StashedActivation, compress, decompress
from repro_torch.memstash.instrument import maybe_record


class _StashedCall(torch.autograd.Function):
    @staticmethod
    def forward(ctx, f, scfg, x, *aux):
        y = f(x, aux)  # autograd records no graph inside forward
        sv = compress(x)
        ctx.f, ctx.meta = f, (sv.shape, sv.dtype)
        ctx.save_for_backward(sv.values, sv.mask, sv.nnz, *aux)
        return y

    @staticmethod
    def backward(ctx, g):
        values, mask, nnz, *aux = ctx.saved_tensors
        x = decompress(StashedActivation(values, mask, nnz, *ctx.meta))
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            x = x.detach().requires_grad_(need[0])
            aux = tuple(a.detach().requires_grad_(n) for a, n in zip(aux, need[1:]))
            y = ctx.f(x, aux)
            inputs = [t for t, n in zip((x, *aux), need) if n]
            grads = iter(torch.autograd.grad(y, inputs, g, allow_unused=True))
        return (None, None, *(next(grads) if n else None for n in need))


def stash_apply(f, scfg: MemstashConfig, name: str, x: torch.Tensor, aux=()):
    """Run ``f(x, aux)`` keeping ``x`` compressed for the backward pass.

    ``x`` is the (sparse) activation worth compressing; ``aux`` is a tuple
    of other differentiable tensors (weights, biases) kept dense."""
    maybe_record(name, x, scfg)
    return _StashedCall.apply(f, scfg, x, *aux)


def checkpoint_apply(f, policy: str, scfg, name: str, x: torch.Tensor, aux=()):
    """Apply one stash point under the selected checkpoint policy."""
    if policy == "none":
        return f(x, aux)
    if policy == "remat":
        return torch.utils.checkpoint.checkpoint(lambda x_, *a: f(x_, a), x, *aux,
                                                 use_reentrant=False)
    if policy == "stash":
        return stash_apply(f, scfg if scfg is not None else MemstashConfig(policy="stash"),
                           name, x, aux)
    raise ValueError(f"policy {policy!r} not in {STASH_POLICIES}")
