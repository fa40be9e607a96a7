"""GPipe-style pipeline parallelism over a mesh axis (port of
``repro/runtime/pipeline.py``).

Layers split into S stages, one per rank along ``axis``; M microbatches
stream through them over ``M + S - 1`` ticks (fill-drain), stage s working
on microbatch ``t - s`` at tick t.  The transfer to the next stage is a
ring: every rank's tick output crosses the axis in one all-gather and
each stage keeps its predecessor's (gloo moves no card tensor point to
point, and the all-gather stages through host memory where it must, see
:mod:`repro_torch.dist.mesh`).  At the end the last stage's outputs go to
every rank, as the reference's closing ``all_gather`` does.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.optim.optimizers import tree_map


def pipeline_apply(stage_fn: Callable[[torch.Tensor, Any], torch.Tensor], stage_params: Any,
                   x_microbatches: torch.Tensor, *, mesh, axis: str = "pod") -> torch.Tensor:
    """Run M microbatches ``(M, mb, ...)`` through the S stages on mesh axis
    ``axis`` (``stage_params``: a tree with a leading S dim; each rank uses
    its stage's slice).  Returns the last stage's outputs as ``(M, mb,
    ...)`` on every rank.  Contract: equals applying the S stages to each
    microbatch in sequence."""
    n_stages = mesh.axis_size(axis)
    sidx = mesh.axis_index(axis)
    m = x_microbatches.shape[0]
    assert m >= 1
    params_one = tree_map(lambda a: a[sidx], stage_params)
    acc = torch.zeros_like(x_microbatches)
    live = torch.zeros_like(x_microbatches[0])
    for t in range(m + n_stages - 1):
        my_mb = t - sidx
        if 0 <= my_mb < m:
            out = stage_fn(x_microbatches[my_mb] if sidx == 0 else live, params_one)
            if sidx == n_stages - 1:
                acc[my_mb] = out
        else:  # a bubble: this stage has no microbatch at this tick
            out = torch.zeros_like(live)
        live = mesh.all_gather(out, axis)[(sidx - 1) % n_stages]
    return mesh.all_gather(acc, axis)[n_stages - 1]


def stack_stage_params(per_stage_params: list) -> Any:
    """[S] list of per-stage param trees -> stacked tree (leading S)."""
    return tree_map(lambda *xs: torch.stack(xs), *per_stage_params)
