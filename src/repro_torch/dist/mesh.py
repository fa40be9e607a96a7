"""Explicit ``(pod, data, model)`` meshes over ``torch.distributed`` ranks
(port of ``repro/dist/mesh.py``).

JAX shards one program over the devices of one process; PyTorch has no
SPMD compiler, so a mesh here is one process per device slot, a *rank*,
joined in a process group.  Ranks are numbered row-major over ``(pod,
data, model)`` — the device order ``jax.make_mesh`` uses — and every axis
of extent > 1 gets one subgroup per line of ranks along it.  The body of
each reference ``shard_map`` becomes code every rank runs, with its
collectives over the axis groups (:meth:`Mesh.all_gather`).

The backend follows the device: ``gloo`` for CPU tensors, ``nccl`` only
where every rank has a card of its own, ``gloo`` where ranks share a card
(NCCL refuses two ranks on one device).  gloo moves host buffers, so a
card tensor crossing a gloo group is staged through host memory
explicitly — one copy off the card before the hop and one back after it,
counted in :attr:`Mesh.staged_hops` — which is the real wire between two
ranks on one card.  :meth:`Mesh.all_reduce` (tensor parallelism's sum
over ``model``) is an all-gather followed by a sum in rank order, so every
rank holds the same bits whatever the backend's own reduction order.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

AXES = ("pod", "data", "model")

#: how long a rank waits for its peers in one collective before it fails
COLLECTIVE_TIMEOUT_S = 600


def backend_for(device, ranks_here: int) -> str:
    """``gloo`` for the CPU and for ranks sharing a card; ``nccl`` where
    each of the ``ranks_here`` ranks on this host has a card of its own."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= ranks_here:
        return "nccl"
    return "gloo"


def rank_device(device, local_rank: int) -> torch.device:
    """This rank's device: its own card where there are enough, else the
    card it shares (local rank modulo the cards); the CPU for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", local_rank % torch.cuda.device_count())


class Mesh:
    """The ``(pod, data, model)`` extents over the default process group,
    with one subgroup per axis this rank lies on (axes of extent 1 need
    none).  ``shape`` maps axis name -> extent, as a jax mesh's does."""

    def __init__(self, pod: int, data: int, model: int, *, device="cpu"):
        self.shape = {"pod": pod, "data": data, "model": model}
        self.size = pod * data * model
        self.rank = dist.get_rank() if self.size > 1 else 0
        if self.size > 1 and dist.get_world_size() != self.size:
            raise RuntimeError(f"mesh {self.label()} needs {self.size} ranks, the process "
                               f"group has {dist.get_world_size()}")
        self.backend = dist.get_backend() if self.size > 1 else None
        self.device = torch.device(device)
        rest, coords = self.rank, {}
        for axis in reversed(AXES):
            coords[axis] = rest % self.shape[axis]
            rest //= self.shape[axis]
        self.coords = {a: coords[a] for a in AXES}
        #: card tensors staged through host memory for a gloo hop
        self.staged_hops = 0
        #: collectives this rank joined, by axis (every hop, on any device)
        self.hops: dict[str, int] = {}
        self._groups: dict[str, object] = {}
        strides = {"pod": data * model, "data": model, "model": 1}
        for axis in AXES:
            n = self.shape[axis]
            if n == 1:
                continue
            others = [a for a in AXES if a != axis]
            # every rank creates every group, in the same order
            for i in range(self.size // n):
                base, rem = 0, i
                for a in reversed(others):
                    base += (rem % self.shape[a]) * strides[a]
                    rem //= self.shape[a]
                ranks = [base + j * strides[axis] for j in range(n)]
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[axis] = group

    def label(self) -> str:
        return "pod{pod}.data{data}.model{model}".format(**self.shape)

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[axis]

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """``(n_axis, *x.shape)``: every rank's ``x`` along ``axis``, in axis
        order, on ``x``'s device (``jax.lax.all_gather``).  The hop moves
        raw bytes, so any dtype crosses."""
        n = self.shape[axis]
        if n == 1:
            return x[None]
        self.hops[axis] = self.hops.get(axis, 0) + 1
        flat = x.contiguous().reshape(-1).view(torch.uint8)
        staged = self.backend == "gloo" and flat.is_cuda
        if staged:  # pinned host buffers: the copies off and onto the card run at full rate
            flat = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True).copy_(flat)
            self.staged_hops += 1
        out = torch.empty((n, flat.numel()), dtype=torch.uint8, device=flat.device,
                          pin_memory=staged)
        dist.all_gather(list(out.unbind(0)), flat, group=self._groups[axis])
        if staged:
            out = out.to(x.device, non_blocking=True)
        return out.view(x.dtype).reshape(n, *x.shape)

    def all_reduce(self, x: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        """The sum (or ``op="max"``, the maximum) of every rank's ``x`` along
        ``axis`` (``jax.lax.psum`` / ``pmax``), on every rank the same bits:
        an :meth:`all_gather` (one counted hop, staged like any other)
        followed by the reduction in rank order, ((x0 + x1) + x2) + ....
        gloo's own ring sum adds each chunk in another order on each rank,
        and replicated activations that differ in one ulp between ranks
        would send their greedy tokens apart."""
        if op not in ("sum", "max"):
            raise ValueError(f"all_reduce op {op!r} is not 'sum' or 'max'")
        if self.shape[axis] == 1:
            return x
        parts = self.all_gather(x, axis)
        out = parts[0].clone()
        for part in parts[1:]:
            if op == "sum":
                out += part
            else:
                torch.maximum(out, part, out=out)
        return out


def make_explicit_mesh(pod: int, data: int, model: int, *, device="cpu") -> Mesh:
    """A ``(pod, data, model)`` mesh over the default process group, which
    must hold exactly ``pod*data*model`` ranks.  Under ``torchrun`` the
    group is initialised here from its environment (``gloo`` or ``nccl``,
    :func:`backend_for`); a process that is no rank of a group raises, as
    the reference raises for a short device pool."""
    need = pod * data * model
    if need > 1 and not dist.is_initialized():
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise RuntimeError(
                f"shape.mesh pod{pod}.data{data}.model{model} needs {need} ranks, one "
                "process each, but this process is not a rank of a process group; "
                f"launch it as torchrun --nproc-per-node {need} -m "
                "repro_torch.launch.train ... (or repro_torch.launch.serve)")
        ranks_here = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
        dist.init_process_group(backend_for(device, ranks_here), init_method="env://",
                                timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    if need > 1 and dist.get_world_size() != need:
        raise RuntimeError(
            f"shape.mesh pod{pod}.data{data}.model{model} needs {need} ranks but the "
            f"process group has {dist.get_world_size()}; launch it as torchrun "
            f"--nproc-per-node {need} ...")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if need > 1 else 0))
    return Mesh(pod, data, model, device=rank_device(device, local))


def data_axis_size(mesh: Optional[Mesh]) -> int:
    """Extent of the ``data`` axis (1 when the mesh doesn't have one)."""
    return int(dict(mesh.shape).get("data", 1)) if mesh is not None else 1


def is_rank0() -> bool:
    """Does this process print a run's result (rank 0, or no group)?"""
    return not dist.is_initialized() or dist.get_rank() == 0
