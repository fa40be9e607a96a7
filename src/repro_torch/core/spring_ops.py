"""SPRING compute ops (port of ``repro/core/spring_ops.py``).

Three modes, as in the reference:

  dense        — bf16 baseline (products taken in fp32, rounded to bf16
                 once, the reference's CPU numerics).
  quant        — Q(IL,FL) operands, fp32 accumulate, rounding of the output
                 back to the grid.
  quant_sparse — quant, with the product on the tile-skipping
                 ``masked_matmul`` kernel (CUDA on the card, the plain
                 version on the CPU) and, in training, the sparse backward.

Rounding follows the reference's CPU contract, which its tests seal: the
kernel runs with the SR epilogue off and the outer ``_q`` rounds, to
nearest or, when ``cfg.stochastic`` and a :class:`KeyGen` is given,
stochastically through the ``stochastic_round`` kernel.  The reference's
TPU path runs the Pallas kernel with SR on (``spring_ops.py:180``); that
difference is the reference's, see ROADMAP §3.  The reference draws its
SR from ``jax.random`` (threefry); the port draws from ``torch.Generator``
seeds and is held to it statistically.

A weight split over the ``model`` axis (``split``, a
``runtime.sharding.Split``) rounds each shard with the whole tensor's SR
counters, so a sharded product draws the unsharded one's uniforms; a
row-split product's partial sums are summed over ``model``
(``dist.tensor.reduce_from_model``) before its output is rounded, as the
reference's partitioned program rounds the whole sum.

Convolutions keep the reference's NHWC activations and HWIO weights at the
API and its SAME padding (``lax.padtype_to_pads``, asymmetric at stride
2), applied explicitly.  The forward conv is a PyTorch conv in full fp32
(cuDNN's TF32 is turned off: Q4.16 needs 21 significant bits), as the
reference leaves its forward conv to XLA.  With the sparse backward, both
backward GEMMs of a conv run on ``masked_matmul_dx`` / ``_dw``: dW on
im2col patches in (Cin, R, S) order, dX on stride-dilated cotangent
patches against the rot180 weights.  Grouped convs keep dense autograd.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.fixedpoint import (
    SPRING_FORMAT,
    FixedPointFormat,
    ste_quantize_nearest,
    ste_quantize_stochastic,
)
from repro_torch.kernels.masked_matmul.backward import masked_matmul_dw, masked_matmul_dx
from repro_torch.kernels.masked_matmul.ops import masked_matmul
from repro_torch.kernels.prng import fold_in

SpringMode = Literal["dense", "quant", "quant_sparse"]

#: compute dtype of the dense baseline
DENSE_DTYPE = torch.bfloat16

#: "none" differentiates through the forward (dense autograd); "auto"
#: routes dL/dX and dL/dW through masked_matmul_dx / _dw.  The reference's
#: impl names (ref, jnp, interpret, pallas) have no counterpart here.
BACKWARD_SPARSITY_CHOICES = ("none", "auto")


@dataclasses.dataclass(frozen=True)
class SpringConfig:
    """Numerics configuration threaded through every model layer."""

    mode: SpringMode = "dense"
    fmt: FixedPointFormat = SPRING_FORMAT
    # stochastic rounding of operands and outputs; serving turns it off
    stochastic: bool = True
    # sparsity-aware backward (quant_sparse only); forward numerics unchanged
    backward_sparsity: str = "auto"
    # weights already on the grid (the SR fixed-point optimizer keeps them
    # there): skip their rounding at every product
    weights_pre_quantized: bool = False
    # operands may round to nearest; SR stays on the product's output
    operand_rounding: str = "stochastic"  # "stochastic" | "nearest"

    def __post_init__(self):
        if self.backward_sparsity not in BACKWARD_SPARSITY_CHOICES:
            raise ValueError(f"unknown backward_sparsity {self.backward_sparsity!r}; "
                             f"choose from {BACKWARD_SPARSITY_CHOICES}")
        if self.operand_rounding not in ("stochastic", "nearest"):
            raise ValueError(f"unknown operand_rounding {self.operand_rounding!r}; "
                             "choose from ('stochastic', 'nearest')")

    @property
    def is_quantized(self) -> bool:
        return self.mode != "dense"

    @property
    def is_sparse(self) -> bool:
        return self.mode == "quant_sparse"

    @property
    def sparse_backward(self) -> bool:
        """True when the sparsity-aware backward is in force."""
        return self.is_sparse and self.backward_sparsity != "none"


DENSE = SpringConfig(mode="dense")
QUANT = SpringConfig(mode="quant")
QUANT_SPARSE = SpringConfig(mode="quant_sparse")

MODES = {"dense": DENSE, "quant": QUANT, "quant_sparse": QUANT_SPARSE}


class KeyGen:
    """Deterministic stream of generators for SR sites.

    Each :meth:`next` folds an incrementing counter into the base seed and
    returns a fresh ``torch.Generator`` on it, so a model with N rounding
    sites draws N distinct, reproducible streams per step without
    threading generators through every layer (the reference folds into a
    ``jax.random`` key the same way).  ``key`` is a 32-bit seed or a
    ``torch.Generator`` to draw one from."""

    def __init__(self, key: int | torch.Generator):
        if isinstance(key, torch.Generator):
            key = int(torch.randint(0, 2**32, (1,), generator=key, dtype=torch.int64))
        self._seed = int(key) & 0xFFFFFFFF
        self._counter = 0

    def next(self) -> torch.Generator:
        gen = torch.Generator().manual_seed(fold_in(self._seed, self._counter))
        self._counter += 1
        return gen

    def skip(self, n: int) -> None:
        """Move past ``n`` draws unused (the rounding sites another rank
        runs), so the sites after them draw what they would have."""
        self._counter += int(n)


def _stochastic(role: str, cfg: SpringConfig, keys: Optional[KeyGen]) -> Optional[bool]:
    """How :func:`_q` rounds a tensor of ``role`` ("act", "weight" or
    "out"): None when it passes through (a weight under
    ``cfg.weights_pre_quantized``), True when it rounds stochastically
    (``cfg.stochastic`` with ``keys``; the operands round to nearest under
    ``operand_rounding="nearest"``), False when it rounds to nearest."""
    if role == "weight" and cfg.weights_pre_quantized:
        return None
    if role in ("act", "weight") and cfg.operand_rounding == "nearest":
        return False
    return bool(cfg.stochastic and keys is not None)


def matmul_draws(cfg: "SpringConfig", keys: Optional[KeyGen]) -> int:
    """The :meth:`KeyGen.next` draws one :func:`spring_matmul` call makes:
    one for each operand and the output that it rounds stochastically."""
    if cfg.mode == "dense":
        return 0
    return sum(bool(_stochastic(role, cfg, keys)) for role in ("act", "weight", "out"))


def _q(x: torch.Tensor, cfg: SpringConfig, keys: Optional[KeyGen],
       role: str = "out", counter: Optional[tuple] = None) -> torch.Tensor:
    """Round one tensor onto the grid, with the straight-through gradient:
    stochastically when ``cfg.stochastic`` and ``keys`` is given, else to
    nearest.  ``role`` is "act", "weight" or "out", as in the reference:
    a weight is passed through when ``cfg.weights_pre_quantized``, and the
    operands ("act", "weight") round to nearest under
    ``operand_rounding="nearest"``.  ``counter`` is a shard's SR counter
    geometry."""
    stochastic = _stochastic(role, cfg, keys)
    if stochastic is None:
        return x
    if stochastic:
        if not isinstance(keys, KeyGen):
            raise TypeError("model-level SR needs a KeyGen over torch.Generator seeds "
                            f"(the reference's threefry keys are not ported), got {keys!r}")
        return ste_quantize_stochastic(keys.next(), x, cfg.fmt, counter)
    return ste_quantize_nearest(x, cfg.fmt)


def spring_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    cfg: SpringConfig = DENSE,
    keys: Optional[KeyGen] = None,
    w_mask: Optional[torch.Tensor] = None,
    split=None,
) -> torch.Tensor:
    """``x @ w`` under the configured SPRING numerics.

    x: (..., K); w: (K, N) in the reference's layout; w_mask: optional
    (K, N) {0,1} pruning mask; split: ``w``'s ``runtime.sharding.Split``
    over ``model`` (None: whole).  A column split yields this rank's
    output columns; a row split reads this rank's input columns and
    yields the whole output, summed over ``model``.
    """
    row = split is not None and split.kind == "row"
    if cfg.mode == "dense":
        if w_mask is not None:
            w = w * w_mask.to(w.dtype)
        # the reference's CPU numerics: bf16 operands, fp32 products and
        # sums, one rounding of the result to bf16
        xd = x.to(DENSE_DTYPE).to(torch.float32)
        wd = w.to(DENSE_DTYPE).to(torch.float32)
        y = torch.matmul(xd, wd)
        return (_reduce(y) if row else y).to(DENSE_DTYPE)

    x_ctr = w_ctr = y_ctr = None
    if split is not None:
        from repro_torch.kernels.stochastic_round.ops import shard_counter

        w_ctr = split.counter()
        if row:  # x holds columns [lo, hi) of the whole input
            x_ctr = shard_counter((split.full[0],), 0, split.lo)
        else:  # y holds columns [lo, hi) of the whole output
            y_ctr = shard_counter((split.full[1],), 0, split.lo)
    xq = _q(x, cfg, keys, role="act", counter=x_ctr)
    if w_mask is not None:
        w = w * w_mask.to(w.dtype)
    wq = _q(w, cfg, keys, role="weight", counter=w_ctr)
    if cfg.is_sparse and xq.ndim == 2:
        # the kernel with its SR epilogue off, the outer _q rounds (the
        # reference's CPU contract); dx/dw through the backward kernels
        # when the sparse backward is in force
        y = masked_matmul(xq, wq, 0, il=cfg.fmt.il, fl=cfg.fmt.fl, apply_sr=False,
                          backward="auto" if cfg.sparse_backward else None)
    else:
        # fp32 accumulate on the fixed-point grid (DESIGN.md deviation 2)
        y = torch.matmul(xq.to(torch.float32), wq.to(torch.float32))
    return _q(_reduce(y) if row else y, cfg, keys, counter=y_ctr)


def _reduce(y: torch.Tensor) -> torch.Tensor:
    from repro_torch.dist.tensor import reduce_from_model

    return reduce_from_model(y)


def spring_einsum(
    spec: str,
    a: torch.Tensor,
    b: torch.Tensor,
    cfg: SpringConfig = DENSE,
    keys: Optional[KeyGen] = None,
) -> torch.Tensor:
    """Einsum under SPRING numerics (attention logits / combines, routing).
    Dense mode takes the reference's CPU numerics, as :func:`spring_matmul`
    does: bf16 operands, fp32 products and sums, the result rounded to
    bf16 once.  Else both operands round as activations, the einsum runs
    in fp32 and its output rounds."""
    if cfg.mode == "dense":
        ad = a.to(DENSE_DTYPE).to(torch.float32)
        bd = b.to(DENSE_DTYPE).to(torch.float32)
        return torch.einsum(spec, ad, bd).to(DENSE_DTYPE)
    aq = _q(a, cfg, keys, role="act")
    bq = _q(b, cfg, keys, role="act")
    y = torch.einsum(spec, aq.to(torch.float32), bq.to(torch.float32))
    return _q(y, cfg, keys)


# -- convolutions (NHWC / HWIO at the API) --------------------------------------


def conv_pads(size: tuple, window: tuple, stride: tuple, padding: str) -> list:
    """``[(lo, hi), ...]`` per spatial dim, as ``lax.padtype_to_pads``:
    SAME gives ceil(size / stride) outputs with the odd pad at the end."""
    if padding == "VALID":
        return [(0, 0)] * len(size)
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    pads = []
    for n, k, s in zip(size, window, stride):
        out = -(-n // s)
        total = max((out - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def pad_nhwc(x: torch.Tensor, pads: list, value: float = 0.0) -> torch.Tensor:
    """Pad (negative: crop) the H and W axes of an NHWC tensor."""
    (hlo, hhi), (wlo, whi) = pads
    if hlo == hhi == wlo == whi == 0:
        return x
    return F.pad(x, (0, 0, wlo, whi, hlo, hhi), value=value)


def im2col(x: torch.Tensor, window: tuple, stride: tuple) -> torch.Tensor:
    """Patches of an (already padded) NHWC tensor as an (N*OH*OW, C*R*S)
    matrix, features in (C, R, S) order (``conv_general_dilated_patches``'
    order).  Materialized once: the GEMMs read it in place."""
    n, h, w, c = x.shape
    (r, s), (sh, sw) = window, stride
    oh, ow = (h - r) // sh + 1, (w - s) // sw + 1
    bn, bh, bw, bc = x.stride()
    v = x.as_strided((n, oh, ow, c, r, s), (bn, bh * sh, bw * sw, bc, bh, bw),
                     x.storage_offset())
    return v.reshape(n * oh * ow, c * r * s)


def conv_nhwc(x: torch.Tensor, w: torch.Tensor, stride: tuple, padding: str,
              groups: int = 1) -> torch.Tensor:
    """The forward conv: NHWC x, HWIO w, the reference's explicit pads.
    On the card the entry points turn cuDNN's TF32 off (Q4.16 values carry
    21 significant bits; TF32 keeps 11)."""
    pads = conv_pads(x.shape[1:3], w.shape[:2], stride, padding)
    y = F.conv2d(pad_nhwc(x, pads).permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


class _ConvSparseBackward(torch.autograd.Function):
    """Dense conv forward; dW and dX on ``masked_matmul_dw`` / ``_dx``
    (port of the reference's ``_conv_with_sparse_bwd``).  The residual is
    the operands only."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        return conv_nhwc(x, w, stride, padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride = ctx.stride
        n, h, wd, cin = x.shape
        r, s, _, cout = w.shape
        oh, ow = g.shape[1], g.shape[2]
        g2 = g.reshape(-1, cout)
        pads = conv_pads((h, wd), (r, s), stride, ctx.padding)
        dx = dw = None
        if ctx.needs_input_grad[1]:
            # dW: im2col patches of the (stashed, ReLU-sparse) input x the cotangent
            p = im2col(pad_nhwc(x, pads), (r, s), stride)
            dw = masked_matmul_dw(p, g2).reshape(cin, r, s, cout).permute(1, 2, 0, 3)
            del p
        if ctx.needs_input_grad[0]:
            # dX: the transposed conv as stride-dilated cotangent patches
            # against the spatially flipped weights
            if stride == (1, 1):
                gd = g
            else:
                gd = g.new_zeros((n, (oh - 1) * stride[0] + 1, (ow - 1) * stride[1] + 1, cout))
                gd[:, ::stride[0], ::stride[1]] = g
            bwd_pads = [(k - 1 - plo, dim - (odim - 1) * st + plo - 1)
                        for (plo, _), k, dim, odim, st in zip(pads, (r, s), (h, wd), (oh, ow),
                                                              stride)]
            pg = im2col(pad_nhwc(gd, bwd_pads), (r, s), (1, 1))
            wt = w.flip(0, 1).permute(3, 0, 1, 2).reshape(cout * r * s, cin)
            dx = masked_matmul_dx(pg, wt.T).reshape(n, h, wd, cin)
        return dx, (None if dw is None else dw.contiguous()), None, None


def spring_conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    cfg: SpringConfig = DENSE,
    keys: Optional[KeyGen] = None,
    stride: tuple = (1, 1),
    padding: str = "SAME",
    feature_group_count: int = 1,
) -> torch.Tensor:
    """NHWC conv under SPRING numerics.  w: (R, S, Cin/groups, Cout)."""
    stride = tuple(stride)
    if cfg.mode == "dense":
        xd = x.to(DENSE_DTYPE).to(torch.float32)
        wd = w.to(DENSE_DTYPE).to(torch.float32)
        return conv_nhwc(xd, wd, stride, padding, feature_group_count).to(DENSE_DTYPE)

    xq = _q(x, cfg, keys, role="act").to(torch.float32)
    wq = _q(w, cfg, keys, role="weight").to(torch.float32)
    if cfg.sparse_backward and feature_group_count == 1:
        y = _ConvSparseBackward.apply(xq, wq, stride, padding)
    else:
        # grouped convs: their patch matrices interleave groups, dense autograd
        y = conv_nhwc(xq, wq, stride, padding, feature_group_count)
    return _q(y, cfg, keys)
