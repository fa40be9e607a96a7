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
float32 as the reference's ``_schedule``.  :func:`make_optimizer`'s
updates are functional (new tensors, as in the reference);
:func:`update_in_place` writes the same step into the state it is given,
leaf by leaf (the LM train step, whose state is donated).

Under tensor parallelism a rank holds shards of some leaves (``splits``,
one ``runtime.sharding.Split`` or None per leaf): the global norm sums the
shards' squares over ``model`` and counts every replicated leaf once, and
a shard is SR-rounded with the whole leaf's element counters, so it
takes the bits the unsharded update gives those elements.
"""

from __future__ import annotations

import dataclasses
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


def _clip_scale(grads, max_norm: float, splits=None, mesh=None) -> tuple:
    """(min(1, max_norm / (global norm + 1e-9)), the global norm), 0-d.
    With ``splits`` the sharded leaves' squares are summed over ``mesh``'s
    ``model`` axis and the replicated leaves' added once."""
    leaves = tree_leaves(grads)

    def sq(g):
        return torch.sum(torch.square(g.to(torch.float32)))

    if splits is None:
        return _scale_of(torch.sqrt(sum(sq(g) for g in leaves)), max_norm)
    sharded = [sq(g) for g, s in zip(leaves, splits) if s is not None]
    whole = [sq(g) for g, s in zip(leaves, splits) if s is None]
    total = mesh.all_reduce(sum(sharded) if sharded
                            else torch.zeros((), device=leaves[0].device), "model")
    return _scale_of(torch.sqrt(sum(whole, total)), max_norm)


def _scale_of(gn: torch.Tensor, max_norm: float) -> tuple:
    return torch.clamp(max_norm / (gn + 1e-9), max=1.0), gn


def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient by min(1, max_norm / (global norm + 1e-9));
    returns (clipped, global norm as a 0-d tensor)."""
    scale, gn = _clip_scale(grads, max_norm)
    return tree_map(lambda g: g * scale, grads), gn


def _schedule(cfg: OptimizerConfig, step: int) -> float:
    """The learning rate at optimizer step ``step`` (counted from 0),
    float32 arithmetic as in the reference."""
    lr = np.float32(cfg.lr)
    if cfg.warmup_steps > 0:
        lr = lr * np.minimum(np.float32(1.0), np.float32(step + 1) / np.float32(cfg.warmup_steps))
    return float(lr)


# -- the update, leaf by leaf ------------------------------------------------

#: elements of one piece of a leaf's elementwise update: the update's
#: temporaries are a few pieces, not a few copies of the largest leaf
UPDATE_PIECE = 1 << 24


def _pieces(*ts):
    """Flat views of ``ts`` cut into matching pieces of UPDATE_PIECE
    elements (the whole tensors where one of them is not contiguous)."""
    if not all(t.is_contiguous() for t in ts):
        return [ts]
    return list(zip(*(t.view(-1).split(UPDATE_PIECE) for t in ts)))


def _adamw_leaf(cfg: OptimizerConfig, p, m, v, g, scale, lr: float, bc1: float, bc2: float):
    """One leaf's AdamW step, written into ``p``, ``m`` and ``v``: the
    reference's ``b1 m + (1 - b1) g``, ``b2 v + (1 - b2) g**2`` and ``p - lr
    (m / bc1 / (sqrt(v / bc2) + eps) + wd p)`` of the clipped ``g * scale``,
    each operation rounded as the functional form rounds it."""
    b1, b2 = cfg.beta1, cfg.beta2
    for p_, m_, v_, g_ in _pieces(p, m, v, g):
        gc = g_.to(torch.float32) * scale
        v_.mul_(b2).add_(torch.square(gc).mul_(1 - b2))
        m_.mul_(b1).add_(gc.mul_(1 - b1))
        del gc
        d = torch.sqrt(v_ / bc2).add_(cfg.eps)
        u = (m_ / bc1).div_(d)
        del d
        u.add_(p_.to(torch.float32) * cfg.weight_decay).mul_(lr)
        p_.copy_(p_.to(torch.float32) - u)


def _sgdm_leaf(cfg: OptimizerConfig, p, m, g, scale, lr: float):
    """One leaf's SGD-momentum step, written into ``p`` and ``m``:
    ``mu m + g`` and ``p - lr (m + wd p)`` of the clipped ``g * scale``."""
    for p_, m_, g_ in _pieces(p, m, g):
        m_.mul_(cfg.momentum).add_(g_.to(torch.float32) * scale)
        u = (p_.to(torch.float32) * cfg.weight_decay).add_(m_).mul_(lr)
        p_.copy_(p_.to(torch.float32) - u)


def update_in_place(cfg: OptimizerConfig, grads, state: OptState, params,
                    seed: Optional[int] = None, splits=None, mesh=None):
    """The optimizer step of :func:`make_optimizer` computed leaf by leaf
    into ``params`` and ``state``'s moments, which it overwrites (the LM
    train step donates its state, as the reference's jitted step does):
    the gradients are clipped by their global norm, each leaf is updated
    piece by piece, then SR-rounded whole onto ``weight_format``'s grid
    (leaf i under ``fold_in(seed, i)``).  The same arithmetic as the
    functional updates, so the same bits; its extra memory is a few pieces
    and one rounded leaf.  ``splits`` (a list in leaf order) and ``mesh``:
    the leaves' splits over ``model`` (the module docstring).  Returns
    (params, the new OptState, metrics)."""
    if cfg.kind not in ("adamw", "sgdm"):
        raise ValueError(cfg.kind)
    if cfg.weight_format is not None and seed is None:
        raise ValueError("the fixed-point weight update needs a seed")
    scale, gn = _clip_scale(grads, cfg.grad_clip, splits, mesh)
    step = state.step + 1
    lr = _schedule(cfg, state.step)
    bc1, bc2 = 1.0 - cfg.beta1**step, 1.0 - cfg.beta2**step
    moments = zip(tree_leaves(state.m), tree_leaves(state.v))
    leaves = tree_leaves(params)
    splits = [None] * len(leaves) if splits is None else splits
    for i, (p, (m, v), g) in enumerate(zip(leaves, moments, tree_leaves(grads))):
        if cfg.kind == "adamw":
            _adamw_leaf(cfg, p, m, v, g, scale, lr, bc1, bc2)
        else:
            _sgdm_leaf(cfg, p, m, g, scale, lr)
        if cfg.weight_format is not None:
            gen = torch.Generator().manual_seed(fold_in(seed, i))
            counter = None if splits[i] is None else splits[i].counter()
            p.copy_(quantize_stochastic(gen, p, cfg.weight_format, counter))
    return params, OptState(step, state.m, state.v), {"grad_norm": gn, "lr": lr}


def _copy(tree):
    return tree_map(torch.clone, tree)


# -- AdamW -------------------------------------------------------------------


def adamw_init(params) -> OptState:
    return OptState(0, tree_map(torch.zeros_like, params), tree_map(torch.zeros_like, params))


def adamw_update(cfg: OptimizerConfig, grads, state: OptState, params,
                 seed: Optional[int] = None):
    """The AdamW step on new tensors (:func:`update_in_place` on copies)."""
    return update_in_place(cfg, grads, OptState(state.step, _copy(state.m), _copy(state.v)),
                           _copy(params), seed)


# -- SGD momentum ------------------------------------------------------------


def sgdm_init(params) -> OptState:
    return OptState(0, tree_map(torch.zeros_like, params),
                    tree_map(lambda p: torch.zeros((), device=p.device), params))


def sgdm_update(cfg: OptimizerConfig, grads, state: OptState, params,
                seed: Optional[int] = None):
    """The SGD-momentum step on new tensors (:func:`update_in_place` on
    copies; the zero ``v`` scalars are kept)."""
    return update_in_place(cfg, grads, OptState(state.step, _copy(state.m), state.v),
                           _copy(params), seed)


def make_optimizer(cfg: OptimizerConfig):
    if cfg.kind == "adamw":
        return adamw_init, lambda g, s, p, seed=None: adamw_update(cfg, g, s, p, seed)
    if cfg.kind == "sgdm":
        return sgdm_init, lambda g, s, p, seed=None: sgdm_update(cfg, g, s, p, seed)
    raise ValueError(cfg.kind)
