"""SPRING compute ops, forward only (port of ``repro/core/spring_ops.py``).

Three modes, as in the reference:

  dense        — bf16 baseline (products taken in fp32, rounded to bf16
                 once, the reference's CPU numerics).
  quant        — Q(IL,FL) operands, fp32 accumulate, rounding of the output
                 back to the grid.
  quant_sparse — quant, with the product on the tile-skipping
                 ``masked_matmul`` kernel (CUDA on the card, the plain
                 version on the CPU).

Rounding follows the reference's CPU contract, which its tests seal: the
kernel runs with ``apply_sr=cfg.stochastic`` (False when serving) and the
outer ``_q`` rounds to nearest.  The reference's TPU path always runs the
Pallas kernel with SR on (``spring_ops.py:180``); that difference is the
reference's, see ROADMAP §3.  Model-level stochastic rounding draws from
``jax.random`` (threefry), which this port does not reproduce: ``_q``
raises when asked for it.  The sparse backward and ``spring_conv2d`` /
``spring_einsum`` belong to training and are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

import torch

from repro_torch.core.fixedpoint import SPRING_FORMAT, FixedPointFormat, quantize_nearest
from repro_torch.kernels.masked_matmul.ops import masked_matmul

SpringMode = Literal["dense", "quant", "quant_sparse"]

#: compute dtype of the dense baseline
DENSE_DTYPE = torch.bfloat16


@dataclasses.dataclass(frozen=True)
class SpringConfig:
    """Numerics configuration threaded through every model layer."""

    mode: SpringMode = "dense"
    fmt: FixedPointFormat = SPRING_FORMAT
    # stochastic rounding of layer outputs; serving turns it off
    stochastic: bool = True

    @property
    def is_quantized(self) -> bool:
        return self.mode != "dense"

    @property
    def is_sparse(self) -> bool:
        return self.mode == "quant_sparse"


DENSE = SpringConfig(mode="dense")
QUANT = SpringConfig(mode="quant")
QUANT_SPARSE = SpringConfig(mode="quant_sparse")

MODES = {"dense": DENSE, "quant": QUANT, "quant_sparse": QUANT_SPARSE}


def _q(x: torch.Tensor, cfg: SpringConfig, keys) -> torch.Tensor:
    """Round one tensor (operand or output) to nearest on the grid."""
    if cfg.stochastic and keys is not None:
        raise NotImplementedError(
            "model-level stochastic rounding (jax.random threefry) is not ported; "
            "serve with stochastic=False")
    return quantize_nearest(x, cfg.fmt)


def spring_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    cfg: SpringConfig = DENSE,
    keys=None,
    w_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``x @ w`` under the configured SPRING numerics.

    x: (..., K); w: (K, N) in the reference's layout; w_mask: optional
    (K, N) {0,1} pruning mask.
    """
    if cfg.mode == "dense":
        if w_mask is not None:
            w = w * w_mask.to(w.dtype)
        # the reference's CPU numerics: bf16 operands, fp32 products and
        # sums, one rounding of the result to bf16
        xd = x.to(DENSE_DTYPE).to(torch.float32)
        wd = w.to(DENSE_DTYPE).to(torch.float32)
        return torch.matmul(xd, wd).to(DENSE_DTYPE)

    xq = _q(x, cfg, keys)
    if w_mask is not None:
        w = w * w_mask.to(w.dtype)
    wq = _q(w, cfg, keys)
    if cfg.is_sparse and xq.ndim == 2:
        y = masked_matmul(xq, wq, 0, il=cfg.fmt.il, fl=cfg.fmt.fl,
                          apply_sr=cfg.stochastic)
    else:
        # fp32 accumulate on the fixed-point grid (DESIGN.md deviation 2)
        y = torch.matmul(xq.to(torch.float32), wq.to(torch.float32))
    return _q(y, cfg, keys)
