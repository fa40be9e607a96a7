"""Sharded train step: replicated compute + packed gradient exchange (port
of ``repro/dist/train.py``).

Every rank of the ``data`` axis holds the parameters, the optimizer state
and the whole batch, and runs the identical forward and backward; the
``grad_sync`` seam of ``make_train_step`` then sends the gradients across
the wire through a real packed reduce-scatter / all-gather round trip.
Because the per-rank addends are identical and the world is a power of
two (RunSpec validates), the tree sum is exactly ``world·g`` and the
``/world`` rescale is an exponent shift, so the synced gradients — and the
losses — are bit-identical to the unsharded run while the gradients
genuinely cross the wire binary-mask compressed.

The reference concatenates every leaf into one flat vector for one wire
transaction; here each leaf crosses in fixed chunks of :data:`GRAD_CHUNK`
elements, since at full width the flat copy, the gathered rows and the
collapse's int64 cumsum would each take gigabytes.  Every step of the
exchange acts element by element (pack, gather, unpack, tree sum,
``/world``, the ``-0.0`` canonicalisation), so the synced bits are the
reference's; only the word alignment of the wire differs.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.dist.collectives import packed_all_reduce_mean
from repro_torch.dist.mesh import data_axis_size
from repro_torch.optim.optimizers import tree_map
from repro_torch.runtime.train import make_train_step

#: elements of a gradient leaf exchanged at once (a multiple of 32 * world
#: for every power-of-two world up to 2**21)
GRAD_CHUNK = 1 << 26


def make_sharded_train_step(arch, step_cfg, mesh, reduced: bool = False,
                            impl: Optional[str] = None):
    """The train step of one rank of an explicit data mesh."""
    if step_cfg.compress_pod_grads:
        raise ValueError(
            "compress_pod_grads drives the int8+EF pod link; the packed "
            "data-axis exchange is a separate link — use shape.mesh.pod "
            "for pods or drop shape.mesh.data")
    world = data_axis_size(mesh)

    def sync_leaf(g: torch.Tensor) -> torch.Tensor:
        flat = g.reshape(-1).to(torch.float32)
        out = flat if flat.data_ptr() == g.data_ptr() else torch.empty_like(flat)
        for start in range(0, flat.numel(), GRAD_CHUNK):
            piece = flat[start:start + GRAD_CHUNK]
            out[start:start + GRAD_CHUNK] = packed_all_reduce_mean(
                piece, axis_name="data", world=world, impl=impl)
        return out.reshape(g.shape).to(g.dtype)

    def grad_sync(grads):
        # the gradients are the step's own tensors: each fp32 leaf is
        # overwritten with its synced values, chunk by chunk
        return tree_map(sync_leaf, grads)

    return make_train_step(arch, step_cfg, mesh=mesh, reduced=reduced, grad_sync=grad_sync)
