"""SGD-momentum and AdamW with SPRING's reduced-precision weight update
(port of ``repro/optim/optimizers.py``).

Parameters, gradients and moments are trees of tensors: nested dicts,
lists and tuples, walked in insertion order (a CNN's flat name -> tensor
dict, or an LM's ``{"embed", "final_norm", "layers": [...]}``); the
moments have the parameters' structure.  With ``weight_format`` set, the
updated weights are stochastically rounded onto the Q(IL,FL) grid (paper
§3.2), leaf ``i`` of the walk under a generator on ``fold_in(seed, i)``,
through ``quantize_stochastic`` (the ``stochastic_round`` kernel on the
card).  ``weight_format=None`` gives standard fp32 training.  The
learning rate warms up linearly over ``warmup_steps``, computed in
float32 as the reference's ``_schedule``.  Updates are functional: new
tensors, as in the reference.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, NamedTuple, Optional

import numpy as np
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
    warmup_steps: int = 0


class OptState(NamedTuple):
    step: int
    m: Any  # first moment / momentum, shaped like the parameters
    v: Any  # second moment (adamw) or zero scalars (sgdm)


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts, lists,
    tuples of tensors), in insertion order."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of a tree, in :func:`tree_map`'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by min(1, max_norm / (global norm + 1e-9));
    returns (clipped, global norm as a 0-d tensor)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), gn


def _schedule(cfg: OptimizerConfig, step: int) -> float:
    """The learning rate at optimizer step ``step`` (counted from 0),
    float32 arithmetic as in the reference."""
    lr = np.float32(cfg.lr)
    if cfg.warmup_steps > 0:
        lr = lr * np.minimum(np.float32(1.0), np.float32(step + 1) / np.float32(cfg.warmup_steps))
    return float(lr)


def _finalize_weights(new_p, cfg: OptimizerConfig, seed: Optional[int]):
    """SR-quantize updated weights onto the Q(IL,FL) grid when configured:
    leaf i draws from a generator on ``fold_in(seed, i)``."""
    if cfg.weight_format is None:
        return new_p
    assert seed is not None, "fixed-point weight update needs a seed"
    index = itertools.count()
    return tree_map(lambda p: quantize_stochastic(
        torch.Generator().manual_seed(fold_in(seed, next(index))), p, cfg.weight_format), new_p)


# -- AdamW -------------------------------------------------------------------


def adamw_init(params) -> OptState:
    return OptState(0, tree_map(torch.zeros_like, params), tree_map(torch.zeros_like, params))


def adamw_update(cfg: OptimizerConfig, grads, state: OptState, params,
                 seed: Optional[int] = None):
    grads, gn = clip_by_global_norm(grads, cfg.grad_clip)
    step = state.step + 1
    lr = _schedule(cfg, state.step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1, bc2 = 1.0 - b1**step, 1.0 - b2**step
    new_m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32), state.m, grads)
    new_v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(torch.float32)),
                     state.v, grads)
    del grads

    def upd(p, m, v):
        pf = p.to(torch.float32)
        update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        return (pf - lr * (update + cfg.weight_decay * pf)).to(p.dtype)

    new_p = _finalize_weights(tree_map(upd, params, new_m, new_v), cfg, seed)
    return new_p, OptState(step, new_m, new_v), {"grad_norm": gn, "lr": lr}


# -- SGD momentum ------------------------------------------------------------


def sgdm_init(params) -> OptState:
    return OptState(0, tree_map(torch.zeros_like, params),
                    tree_map(lambda p: torch.zeros((), device=p.device), params))


def sgdm_update(cfg: OptimizerConfig, grads, state: OptState, params,
                seed: Optional[int] = None):
    grads, gn = clip_by_global_norm(grads, cfg.grad_clip)
    lr = _schedule(cfg, state.step)
    new_m = tree_map(lambda m, g: cfg.momentum * m + g.to(torch.float32), state.m, grads)
    del grads

    def upd(p, m):
        pf = p.to(torch.float32)
        return (pf - lr * (m + cfg.weight_decay * pf)).to(p.dtype)

    new_p = _finalize_weights(tree_map(upd, params, new_m), cfg, seed)
    return new_p, OptState(state.step + 1, new_m, state.v), {"grad_norm": gn, "lr": lr}


def make_optimizer(cfg: OptimizerConfig):
    if cfg.kind == "adamw":
        return adamw_init, lambda g, s, p, seed=None: adamw_update(cfg, g, s, p, seed)
    if cfg.kind == "sgdm":
        return sgdm_init, lambda g, s, p, seed=None: sgdm_update(cfg, g, s, p, seed)
    raise ValueError(cfg.kind)
