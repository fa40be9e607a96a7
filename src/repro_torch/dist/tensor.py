"""Tensor parallelism over the ``model`` axis (the port's counterpart of
GSPMD partitioning the reference's annotated layers).

The port has no SPMD compiler, so the collectives are placed by hand,
Megatron style, around the weights :func:`repro_torch.runtime.sharding.weight_split`
reports split:

  * a column-split projection (its outputs over ``model``) reads the whole
    input and yields the rank's columns; its input enters through
    :func:`copy_to_model`, whose backward sums the ranks' partial input
    gradients;
  * a row-split projection (its inputs over ``model``) reads the rank's
    columns and yields a partial sum, which :func:`reduce_from_model`
    sums over the ranks (its backward hands the gradient on unchanged);
  * :func:`gather_from_model` concatenates the ranks' parts along a dim in
    rank order; its backward sums every rank's gradient of the whole and
    hands each rank its own part, so a rank may read any heads of the
    gathered tensor;
  * :func:`gather_whole` concatenates the ranks' parts the same way, where
    every rank then runs the same computation on the whole (the experts'
    outputs, which every rank combines alike): each rank already holds the
    whole gradient, so its backward hands each rank its own part unsummed
    (a sum would multiply it by the axis's extent).

Every sum is :meth:`Mesh.all_reduce`: an all-gather and a sum in rank
order, the same bits on every rank; :func:`model_sum` is that sum for a
few host-side figures (a pruning threshold's moments, the pool's wire
counts), so that every rank takes the same decision from them.  Every rank runs the same collectives
in the same order, the recomputations under ``torch.utils.checkpoint``
included (a recompute replays its forward, collectives and all).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.runtime.sharding import Split, active_mesh


def model_mesh():
    """The active mesh when its ``model`` axis has extent > 1, else None."""
    mesh = active_mesh()
    if mesh is None or int(dict(mesh.shape).get("model", 1)) == 1:
        return None
    return mesh


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous(), "model"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce(x, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.size = mesh, dim, x.shape[dim]
        parts = mesh.all_gather(x, "model")
        return torch.cat(list(parts.unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        whole = ctx.mesh.all_reduce(g.contiguous(), "model")
        r = ctx.mesh.axis_index("model")
        return whole.narrow(ctx.dim, r * ctx.size, ctx.size).contiguous(), None, None


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.size = mesh, dim, x.shape[dim]
        parts = mesh.all_gather(x, "model")
        return torch.cat(list(parts.unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        r = ctx.mesh.axis_index("model")
        return g.narrow(ctx.dim, r * ctx.size, ctx.size).contiguous(), None, None


def model_sum(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """``x`` summed over ``model`` in rank order (:meth:`Mesh.all_reduce`),
    the same bits on every rank, on ``x``'s device (the hop crosses on
    the mesh's device, so a host tensor also crosses an nccl group);
    ``x`` itself without a ``model`` axis.  ``mesh`` defaults to the
    active one."""
    mesh = model_mesh() if mesh is None else mesh
    if mesh is None or int(dict(mesh.shape).get("model", 1)) == 1:
        return x
    return mesh.all_reduce(x.to(mesh.device), "model").to(x.device)


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """Forward: ``x``.  Backward: the gradient summed over ``model``."""
    mesh = model_mesh()
    return x if mesh is None else _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """Forward: ``x`` summed over ``model``.  Backward: the gradient as it is."""
    mesh = model_mesh()
    return x if mesh is None else _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Forward: every rank's ``x`` concatenated along ``dim`` in rank order.
    Backward: the gradients of the whole summed over ``model``, and this
    rank's part of the sum."""
    mesh = model_mesh()
    return x if mesh is None else _GatherFromModel.apply(x, mesh, dim % x.ndim)


def gather_whole(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Forward: every rank's ``x`` concatenated along ``dim`` in rank order.
    Backward: this rank's part of the gradient of the whole, unsummed: every
    rank computes the same whole gradient from the gathered tensor."""
    mesh = model_mesh()
    return x if mesh is None else _GatherWhole.apply(x, mesh, dim % x.ndim)


def column_input(x: torch.Tensor, *splits: Optional[Split]) -> torch.Tensor:
    """The input of column-split projections: :func:`copy_to_model` once
    if any of ``splits`` is a column split (the projections sharing one
    input share one backward sum)."""
    if any(s is not None and s.kind == "col" for s in splits):
        return copy_to_model(x)
    return x
