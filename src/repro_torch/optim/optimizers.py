"""SGD-momentum and AdamW with SPRING's reduced-precision weight update
(port of ``repro/optim/optimizers.py``).

Parameters, gradients and moments are dicts of tensors (the reference's
pytrees).  With ``weight_format`` set, the updated weights are
stochastically rounded onto the Q(IL,FL) grid (paper §3.2), each leaf with
its own generator seed, through ``quantize_stochastic`` (the
``stochastic_round`` kernel on the card).  ``weight_format=None`` gives
standard fp32 training.  Updates are functional: new tensors, as in the
reference.  The learning rate is constant: the reference's warmup has no
caller in the port.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core.fixedpoint import FixedPointFormat, quantize_stochastic
from repro_torch.kernels.prng import fold_in


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    kind: str = "adamw"  # "adamw" | "sgdm"
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    momentum: float = 0.9
    grad_clip: float = 1.0
    # SPRING reduced-precision master weights (None -> fp32 baseline)
    weight_format: Optional[FixedPointFormat] = None


class OptState(NamedTuple):
    step: int
    m: dict  # first moment / momentum
    v: dict  # second moment (adamw) or zero scalars (sgdm)


def clip_by_global_norm(grads: dict, max_norm: float):
    """Scale every gradient by min(1, max_norm / (global norm + 1e-9));
    returns (clipped, global norm as a 0-d tensor)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in grads.values()))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return {k: g * scale for k, g in grads.items()}, gn


def _finalize_weights(new_p: dict, cfg: OptimizerConfig, seed: Optional[int]) -> dict:
    """SR-quantize updated weights onto the Q(IL,FL) grid when configured:
    leaf i draws from a generator on ``fold_in(seed, i)``."""
    if cfg.weight_format is None:
        return new_p
    assert seed is not None, "fixed-point weight update needs a seed"
    out = {}
    for i, (k, p) in enumerate(new_p.items()):
        gen = torch.Generator().manual_seed(fold_in(seed, i))
        out[k] = quantize_stochastic(gen, p, cfg.weight_format)
    return out


# -- AdamW -------------------------------------------------------------------


def adamw_init(params: dict) -> OptState:
    return OptState(0, {k: torch.zeros_like(p) for k, p in params.items()},
                    {k: torch.zeros_like(p) for k, p in params.items()})


def adamw_update(cfg: OptimizerConfig, grads: dict, state: OptState, params: dict,
                 seed: Optional[int] = None):
    grads, gn = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = cfg.lr
    b1, b2 = cfg.beta1, cfg.beta2
    bc1, bc2 = 1.0 - b1**step, 1.0 - b2**step
    new_m = {k: b1 * state.m[k] + (1 - b1) * g.to(torch.float32) for k, g in grads.items()}
    new_v = {k: b2 * state.v[k] + (1 - b2) * torch.square(g.to(torch.float32))
             for k, g in grads.items()}
    new_p = {}
    for k, p in params.items():
        pf = p.to(torch.float32)
        update = (new_m[k] / bc1) / (torch.sqrt(new_v[k] / bc2) + cfg.eps)
        new_p[k] = (pf - lr * (update + cfg.weight_decay * pf)).to(p.dtype)
    new_p = _finalize_weights(new_p, cfg, seed)
    return new_p, OptState(step, new_m, new_v), {"grad_norm": gn, "lr": lr}


# -- SGD momentum ------------------------------------------------------------


def sgdm_init(params: dict) -> OptState:
    return OptState(0, {k: torch.zeros_like(p) for k, p in params.items()},
                    {k: torch.zeros((), device=p.device) for k, p in params.items()})


def sgdm_update(cfg: OptimizerConfig, grads: dict, state: OptState, params: dict,
                seed: Optional[int] = None):
    grads, gn = clip_by_global_norm(grads, cfg.grad_clip)
    lr = cfg.lr
    new_m = {k: cfg.momentum * state.m[k] + g.to(torch.float32) for k, g in grads.items()}
    new_p = {}
    for k, p in params.items():
        pf = p.to(torch.float32)
        new_p[k] = (pf - lr * (new_m[k] + cfg.weight_decay * pf)).to(p.dtype)
    new_p = _finalize_weights(new_p, cfg, seed)
    return new_p, OptState(state.step + 1, new_m, state.v), {"grad_norm": gn, "lr": lr}


def make_optimizer(cfg: OptimizerConfig):
    if cfg.kind == "adamw":
        return adamw_init, lambda g, s, p, seed=None: adamw_update(cfg, g, s, p, seed)
    if cfg.kind == "sgdm":
        return sgdm_init, lambda g, s, p, seed=None: sgdm_update(cfg, g, s, p, seed)
    raise ValueError(cfg.kind)
