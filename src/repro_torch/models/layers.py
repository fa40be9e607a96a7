"""Foundational layers (port of ``repro/models/layers.py``).

Functional style on plain parameter dicts, as in the reference: dense
kernels are ``(d_in, d_out)`` tensors under ``{"kernel": ...}``, so the
JAX parameter tree maps one to one (``repro_torch.convert``).  Every
projection funnels through :func:`~repro_torch.core.spring_ops.spring_matmul`.

Under a mesh whose rules split weights over ``model`` a rank holds the
shards ``runtime.tree_sharding.shard_tree`` cut, and the layers ask
``runtime.sharding.weight_split`` (from the reference's logical axes and
the whole weight's shape) which way each is split: :func:`dense_apply`
takes the answer, :func:`embed_apply` looks the tokens up in its
vocabulary rows, :func:`swiglu_apply` keeps ``mlp_act`` on the rank's
columns; the collectives are ``dist.tensor``'s.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
import weakref
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.spring_ops import DENSE, DENSE_DTYPE, KeyGen, SpringConfig, spring_matmul
from repro_torch.dist.tensor import column_input, copy_to_model, model_sum, reduce_from_model
from repro_torch.memstash.config import MemstashConfig
from repro_torch.runtime.sharding import weight_split


@dataclasses.dataclass
class SpringContext:
    """Per-call numerics context threaded through every layer.

    ``keys`` is the SR generator stream (a :class:`KeyGen`; None rounds to
    nearest); ``memstash`` the compressed-activation-stash policy of the
    named stash points (None: every point resolves to "none");
    ``attention`` the full-sequence attention route, ``"flash"`` (the
    ``flash_attention`` wrapper: serving's prefill) or ``"chunked"`` (the
    reference's differentiable chunked attention: training, unless
    ``flash_attention`` is pinned); ``int8_cache`` makes full-attention
    layers keep their serving cache as int8 lines with bf16 scales
    (``attention._q8``); ``prune_ratio`` magnitude-prunes every dense
    projection's weight as it is used (:meth:`maybe_prune`; the paper's
    §2.2 cites 20-80% weight sparsity): the mask is derived inline from a
    Gaussian-calibrated threshold, no mask tensor is stored.
    """

    cfg: SpringConfig = DENSE
    keys: Optional[KeyGen] = None
    prune_ratio: float = 0.0
    int8_cache: bool = False
    memstash: Optional[MemstashConfig] = None
    attention: str = "flash"
    #: a served shard's threshold, once a version (:meth:`prune_cut`):
    #: id -> (weakref, version, threshold)
    _cuts: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                    compare=False)

    def __post_init__(self):
        if self.attention not in ("flash", "chunked"):
            raise ValueError(f"attention {self.attention!r} not in ('flash', 'chunked')")

    def stash_policy(self, name: str, elems: Optional[int] = None) -> str:
        """Resolve the checkpoint policy for one named stash point."""
        if self.memstash is None:
            return "none"
        return self.memstash.policy_for(name, elems)

    def maybe_prune(self, w: torch.Tensor, split=None) -> torch.Tensor:
        """Zero the weights under ``t * std(w)``, where for w ~ N(0, s)
        P(|w| < t s) = erf(t / sqrt(2)) = ``prune_ratio``.  The pruned
        entries get a zero gradient (the optimizer still moves them; the
        next forward prunes them again), as in the reference.  ``split``
        (a ``runtime.sharding.Split``) says ``w`` is a shard of a weight
        split over ``model``: the threshold is the whole weight's
        (:meth:`prune_cut`)."""
        if self.prune_ratio <= 0.0:
            return w
        return torch.where(w.abs() >= self.prune_cut(w, split), w, 0.0).to(w.dtype)

    def prune_cut(self, w: torch.Tensor, split=None) -> torch.Tensor:
        """The fp32 threshold ``t * std`` of the whole weight.  A shard
        (``split`` set) adds its share of the whole weight's sum and sum of
        squares, in float64, over ``model`` in rank order (one hop a
        weight, ``dist.tensor.model_sum``), so every rank gets the same
        bits; the std then follows from the whole count.  That is not
        ``torch.std``'s reduction order, so the threshold may differ from
        the unsharded run's in its last bits.  A shard that takes no
        gradient (a served weight) keeps its threshold while its version
        holds, so a serving step pays the hop once, not at every call (the
        same value: the weight has not changed)."""
        t = prune_threshold(self.prune_ratio)
        if split is None:
            return t * (torch.std(w.to(torch.float32), correction=0) + 1e-12)
        hit = None if w.requires_grad else self._cuts.get(id(w))
        if hit is not None and hit[0]() is w and hit[1] == w._version:
            return hit[2]
        x = w.detach().to(torch.float64)
        s = model_sum(torch.stack([x.sum(), (x * x).sum()]))
        n = math.prod(split.full)
        mean = s[0] / n
        var = torch.clamp(s[1] / n - mean * mean, min=0.0)
        cut = t * (torch.sqrt(var).to(torch.float32) + 1e-12)
        if not w.requires_grad:
            self._cuts[id(w)] = (weakref.ref(w), w._version, cut)
        return cut


# XLA's fp32 erfinv (M. Giles, "Approximating the erfinv function",
# single-precision form): coefficients for w < 5 and w >= 5
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


@functools.lru_cache(maxsize=64)
def prune_threshold(ratio: float) -> float:
    """``erfinv(float32(ratio)) * sqrt(2)`` as the fp32 value the
    reference's ``maybe_prune`` computes.  ``torch.erfinv`` takes another
    algorithm and differs in the last bit at some ratios (0.2, 0.8), so
    the polynomial is evaluated here in fp32 with fused multiply-adds
    (each Horner step rounded once, through float64), as jax's CPU
    program does; it agrees with jax at every ratio k/100."""
    f32, f64 = np.float32, np.float64
    x = f32(ratio)
    w = -f32(np.log1p(f64(-x * x)))
    if w < f32(5.0):
        w, coeffs = w - f32(2.5), _ERFINV_SMALL
    else:
        w, coeffs = f32(np.sqrt(w)) - f32(3.0), _ERFINV_LARGE
    p = f32(coeffs[0])
    for c in coeffs[1:]:
        p = f32(f64(f32(c)) + f64(p) * f64(w))
    return float(p * x * f32(math.sqrt(2.0)))


class _Draws(threading.local):
    hook = None


_DRAWS = _Draws()


@contextlib.contextmanager
def draw_hook(hook):
    """Inside the block, every :func:`randn` leaf is handed to ``hook``
    as soon as it is drawn, and the init keeps what ``hook`` returns (a
    rank's slice of it: ``models.lm.lm_init``'s shards, drawn leaf by
    leaf)."""
    prev, _DRAWS.hook = _DRAWS.hook, hook
    try:
        yield
    finally:
        _DRAWS.hook = prev


def randn(shape, gen: Optional[torch.Generator], device=None) -> torch.Tensor:
    """An fp32 standard-normal parameter leaf from ``gen``, through the
    active :func:`draw_hook`."""
    t = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return t if _DRAWS.hook is None else _DRAWS.hook(t)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *, device=None,
               scale: float | None = None, bias: bool = False) -> dict:
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    w = randn((d_in, d_out), gen, device)
    p = {"kernel": w.mul_(scale)}
    if bias:
        p["bias"] = torch.zeros((d_out,), dtype=torch.float32, device=device)
    return p


def dense_apply(params: dict, x: torch.Tensor, ctx: SpringContext, split=None) -> torch.Tensor:
    """``x @ kernel (+ bias)``.  ``split`` is the kernel's
    ``runtime.sharding.Split`` over ``model``: a column split reads the
    whole ``x`` (entered through ``dist.tensor.column_input``) and yields
    this rank's columns, with its columns of the replicated bias (whose
    gradient is summed over ``model``); a row split reads this rank's
    columns of ``x`` and yields the whole output, summed over ``model``."""
    w = ctx.maybe_prune(params["kernel"], split)
    shape = x.shape
    y = spring_matmul(x.reshape(-1, shape[-1]), w, ctx.cfg, ctx.keys, split=split)
    y = y.reshape(*shape[:-1], w.shape[-1])
    if "bias" in params:
        b = params["bias"]
        if split is not None and split.kind == "col":
            b = split.take(copy_to_model(b), 0)
        y = (y + b.to(y.dtype)).to(y.dtype)
    return y


def embed_init(gen: torch.Generator, vocab: int, d: int, *, device=None) -> dict:
    emb = randn((vocab, d), gen, device)
    return {"embedding": emb.mul_(0.02)}


def embed_apply(params: dict, tokens: torch.Tensor, ctx: SpringContext,
                vocab: int | None = None) -> torch.Tensor:
    """The tokens' embedding rows.  Given the whole ``vocab``, a table split
    over ``model`` by its vocabulary rows is looked up on each rank's rows
    (zero where a token lies on another rank's) and summed over ``model``:
    exact, as one addend is the row and the others are zero."""
    # quantized modes carry fp32 activations (the Q4.16 grid does not fit
    # in bf16); dense mode computes in bf16
    act_dtype = torch.float32 if ctx.cfg.is_quantized else DENSE_DTYPE
    emb = params["embedding"]
    split = weight_split(("w_vocab", "w_embed"), (vocab, emb.shape[1])) if vocab else None
    if split is None:
        return emb[tokens].to(act_dtype)
    local = tokens - split.lo
    inside = (local >= 0) & (local < split.hi - split.lo)
    rows = emb[local.clamp(0, split.hi - split.lo - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                            device=rows.device))
    return reduce_from_model(rows).to(act_dtype)


def rmsnorm_init(d: int, *, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


#: rows (dim 0) of every call that :func:`fixed_rows` makes
ROW_BLOCK = 8


def fixed_rows(fn, *xs: torch.Tensor) -> torch.Tensor:
    """``fn`` over ``xs`` in blocks of exactly ``ROW_BLOCK`` rows (dim 0),
    the last block zero-padded, the results concatenated without the
    padding.  cuBLAS and torch's reduction kernels choose their algorithm,
    and so their summation order, by the operands' shapes: on the card a
    row reduced in a batch of 4 and in a batch of 2 can differ in its last
    bits.  Here every call has the same shape whatever the batch's size,
    and each row's result reads only that row, so serving's decode is
    batch-invariant (the same tokens after a rescale, or a resume into
    another slot) on every device."""
    b, out = xs[0].shape[0], []
    for start in range(0, b, ROW_BLOCK):
        n = min(ROW_BLOCK, b - start)
        block = [x[start:start + n] for x in xs]
        if n < ROW_BLOCK:
            block = [F.pad(x, (0, 0) * (x.ndim - 1) + (0, ROW_BLOCK - n)) for x in block]
        out.append(fn(*block)[:n])
    return out[0] if len(out) == 1 else torch.cat(out)


def _mean_square(x: torch.Tensor) -> torch.Tensor:
    return torch.mean(x * x, dim=-1, keepdim=True)


def rmsnorm_apply(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm.  For one position per row (a decode step) the mean of
    squares is reduced in fixed row blocks (:func:`fixed_rows`)."""
    xf = x.to(torch.float32)
    var = fixed_rows(_mean_square, xf) if xf.ndim == 3 and xf.shape[1] == 1 \
        else _mean_square(xf)
    y = xf * torch.rsqrt(var + eps) * params["scale"]
    return y.to(x.dtype)


def layernorm_init(d: int, *, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm_apply(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32 over the population variance (``jnp.var``)."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * params["scale"] + params["bias"]
    return y.to(x.dtype)


def rope_apply(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, D) with D even; positions: (B, S) integer."""
    d = x.shape[-1]
    exponent = torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions[..., None].to(torch.float32) * inv_freq  # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu_init(gen: torch.Generator, d: int, d_ff: int, *, device=None) -> dict:
    return {
        "gate": dense_init(gen, d, d_ff, device=device),
        "up": dense_init(gen, d, d_ff, device=device),
        "down": dense_init(gen, d_ff, d, device=device),
    }


def swiglu_apply(params: dict, x: torch.Tensor, ctx: SpringContext,
                 d_ff: int | None = None) -> torch.Tensor:
    """SwiGLU.  Given the whole ``d_ff``, gate / up split over ``model`` by
    columns and down by rows (the one ``w_mlp`` rule splits all three or
    none) keep the hidden ``mlp_act`` on the rank's columns; the one sum
    over ``model`` is down's."""
    d = x.shape[-1]
    s_in = weight_split(("w_embed", "w_mlp"), (d, d_ff)) if d_ff else None
    s_out = weight_split(("w_mlp", "w_embed"), (d_ff, d)) if d_ff else None
    x = column_input(x, s_in)
    g = dense_apply(params["gate"], x, ctx, s_in)
    u = dense_apply(params["up"], x, ctx, s_in)
    gf = g.to(torch.float32)
    h = (gf * torch.sigmoid(gf)).to(g.dtype) * u  # jax.nn.silu = x * sigmoid(x)
    return dense_apply(params["down"], h, ctx, s_out)


def gelu_mlp_init(gen: torch.Generator, d: int, d_ff: int, *, device=None,
                  bias: bool = True) -> dict:
    return {"fc1": dense_init(gen, d, d_ff, device=device, bias=bias),
            "fc2": dense_init(gen, d_ff, d, device=device, bias=bias)}


def gelu_mlp_apply(params: dict, x: torch.Tensor, ctx: SpringContext) -> torch.Tensor:
    """fc1, GELU in fp32 (``jax.nn.gelu``'s default, the tanh form), fc2."""
    h = dense_apply(params["fc1"], x, ctx)
    h = F.gelu(h.to(torch.float32), approximate="tanh").to(h.dtype)
    return dense_apply(params["fc2"], h, ctx)
