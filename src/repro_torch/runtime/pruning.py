"""Eager-Pruning-style progressive weight sparsification (port of
``repro/runtime/pruning.py``; paper §6).

Weight-magnitude rankings stabilize early in training, so insignificant
weights can be pruned DURING training and the binary-mask machinery turns
the zeros into skipped work at once (the tile skip of ``masked_matmul``,
compressed traffic).  A target sparsity ramps from 0 to its final value
over the ramp steps (cubic), and each boundary hard-prunes the master
weights by magnitude, with the masks re-derived, not stored: pruned
coordinates stay prunable.

Every number is the reference's fp32 one.  ``sparsity_at`` takes an int
step through fp32 arithmetic, as jax divides an int32 step.  The
threshold is ``jnp.quantile``'s linear method as jax computes it: the
index ``q * (n - 1)`` in fp32 (past 2**24 elements it rounds), floor and
ceil of it, the two sorted magnitudes there weighted in fp32.
``torch.quantile`` refuses inputs over 2**24 elements and interpolates in
float64, so the port sorts the flat magnitudes itself.

The reference prunes each leaf of its parameter tree, and its LM keeps
the layers at one unit position stacked in one leaf.  The port keeps one
dict per layer; given the ``LMConfig``, :func:`apply_pruning` and
:func:`measured_sparsity` treat the layers of one stack as that one leaf
(one threshold over their joint magnitudes, the size test on the stacked
shape).  Leaves are visited in the reference's order (dict keys sorted).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class PruneSchedule:
    final_sparsity: float = 0.5
    start_step: int = 20
    ramp_steps: int = 100
    min_dim: int = 64  # leave small tensors (norms, biases) dense

    def sparsity_at(self, step) -> torch.Tensor:
        """The target sparsity at ``step``, a 0-d fp32 tensor."""
        f32 = np.float32
        frac = np.clip(f32(int(step) - self.start_step) / f32(max(1, self.ramp_steps)),
                       f32(0.0), f32(1.0))
        # cubic ramp (Zhu & Gupta '17): gentle early, aggressive late
        x = f32(1.0) - frac
        return torch.tensor(f32(self.final_sparsity) * (f32(1.0) - x * x * x))


def _leaves(tree, path=()):
    """``(path, container, key)`` of every tensor leaf, dict keys sorted."""
    items = sorted(tree.items()) if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list, tuple)):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), tree, k


def _copy(tree):
    """The tree's containers anew (lists for tuples), its tensors shared."""
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy(v) for v in tree]
    return tree


def _groups(params: dict, cfg) -> list:
    """``(shape, [(container, key), ...])`` of every leaf of the reference's
    layout, in its order: a unit position's layers form one group, whose
    shape is the stacked one."""
    groups: dict = {}
    stacked = cfg is not None and "layers" in params
    for path, c, k in _leaves(params):
        if not (stacked and path[0] == "layers"):
            groups[path] = (tuple(c[k].shape), [(c, k)])
    if stacked:
        for (key, i, _), layer in zip(cfg.layer_plan, params["layers"]):
            for path, c, k in _leaves(layer):
                _, refs = groups.setdefault((key,) + path, (None, []))
                refs.append((c, k))
                shape = tuple(c[k].shape) if i is None else (len(refs),) + tuple(c[k].shape)
                groups[(key,) + path] = (shape, refs)
    return [groups[p] for p in sorted(groups, key=lambda p: tuple(map(str, p)))]


def quantile_f32(x: torch.Tensor, q) -> torch.Tensor:
    """``jnp.quantile(x, q)`` (linear) over all of ``x``, with jax's fp32
    index arithmetic; a NaN anywhere gives NaN.  ``x`` may be a list of
    tensors, taken together."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in xs])
    a = torch.sort(flat).values  # NaNs sort last
    del flat
    f32 = np.float32
    n = f32(a.numel())
    qn = f32(q) * (n - f32(1.0))
    low, high = np.floor(qn), np.ceil(qn)
    hw = qn - low
    lw = f32(1.0) - hw
    # the clamp runs in fp32 and the gather clamps again (n - 1 may round up)
    last = a.numel() - 1
    lo = min(int(np.clip(low, f32(0.0), n - f32(1.0))), last)
    hi = min(int(np.clip(high, f32(0.0), n - f32(1.0))), last)
    out = a[lo] * float(lw) + a[hi] * float(hw)
    return torch.where(torch.isnan(a[last]), a[last], out)


def _prune_group(ws: list, shape: tuple, sparsity, min_dim: int) -> Optional[list]:
    # judge size on the matmul dims of the reference's (stacked) leaf
    if len(shape) < 2 or min(shape[-2:]) < min_dim:
        return None
    thresh = quantile_f32([w.abs() for w in ws], sparsity)  # the s-quantile of |w|
    return [torch.where(w.abs() > thresh, w, 0.0).to(w.dtype) for w in ws]


def _prune_leaf(w: torch.Tensor, sparsity, min_dim: int) -> torch.Tensor:
    out = _prune_group([w], tuple(w.shape), sparsity, min_dim)
    return w if out is None else out[0]


def apply_pruning(params: dict, step, schedule: PruneSchedule, cfg=None) -> dict:
    """Magnitude-prune every large weight to the scheduled sparsity; a new
    tree (unpruned leaves shared).  ``cfg``: an LM's config, whose stacked
    layers share their thresholds as in the reference."""
    s = float(schedule.sparsity_at(step))
    out = _copy(params)
    for shape, refs in _groups(out, cfg):
        pruned = _prune_group([c[k] for c, k in refs], shape, s, schedule.min_dim)
        for (c, k), w in zip(refs, pruned or ()):
            c[k] = w
    return out


def measured_sparsity(params: dict, cfg=None) -> torch.Tensor:
    """Fraction of exactly-zero weight entries (the masked-matmul input)
    over the leaves of two or more dims, a 0-d fp32 tensor."""
    zeros, total = None, 0.0
    for shape, refs in _groups(params, cfg):
        if len(shape) >= 2:
            count = sum(int(torch.sum(c[k] == 0.0)) for c, k in refs)
            z = torch.tensor(np.float32(count))
            zeros = z if zeros is None else zeros + z
            total += float(np.prod(shape))
    if zeros is None:
        zeros = torch.tensor(np.float32(0.0))
    return zeros / torch.tensor(np.float32(max(total, 1.0)))
