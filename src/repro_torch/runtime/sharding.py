"""Logical-axis sharding rules (port of ``repro/runtime/sharding.py``).

Tensors are annotated with *logical* axis names; a rules table maps each
logical axis to mesh axes.  :func:`logical_to_spec` drops a mesh axis
whenever the dimension is not divisible by the axis's extent — the tensor
is replicated along that axis instead — and counts the fallback in
``spring_mesh_fallback_total{logical=...}``.

A spec is a tuple of the reference's ``PartitionSpec`` entries, one per
dimension: ``None`` (replicated), a mesh axis name, or a tuple of names
sharded jointly.  The port has no SPMD compiler, so nothing lays a tensor
out by these specs on its own: :mod:`repro_torch.dist` slices its rows by
them, :func:`repro_torch.runtime.tree_sharding.shard_tree` slices each
weight leaf over ``model`` by them, and the layers ask
:func:`weight_split` which way a weight of the active mesh is split and
place their collectives themselves (:mod:`repro_torch.dist.tensor`,
Megatron style).  :func:`constrain` is the identity (the reference's
``with_sharding_constraint`` never changes a value either).  Tensor
parallelism runs where the active rules map a weight's logical axis onto
a ``model`` axis of extent > 1; :data:`DATA_ONLY_RULES` keep ``model``
replicated (the data-parallel steps, and the engines outside the dense
family's tensor parallelism).  FSDP over ``data`` (the ``w_embed`` rule) is not ported: a
``data`` entry of a weight's spec leaves the weight whole.

Mesh axes:
  pod    — inter-pod data parallelism
  data   — intra-pod data parallelism for activations, FSDP for weights
  model  — tensor parallelism (heads / ffn / vocab / experts)

A mesh here is anything with a ``shape`` mapping of axis name -> extent
(:class:`repro_torch.dist.mesh.Mesh`, or a stub in a test).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Sequence, Union

Axis = Union[str, None, tuple]

# logical axis -> mesh axes (order matters: first existing wins; tuples
# shard over multiple mesh axes jointly).
DEFAULT_RULES: dict[str, tuple] = {
    # activations
    "batch": (("pod", "data"), ("data",)),
    "seq": (None,),
    "embed": (None,),
    "heads": (("model",),),
    "kv_heads": (("model",),),
    "head_dim": (None,),
    "mlp_act": (("model",),),
    "experts_act": (("model",),),
    "capacity": (None,),
    "vocab_act": (("model",),),
    # weights
    "w_embed": (("data",),),          # FSDP axis
    "w_qkv": (("model",),),           # TP axis (flattened heads*head_dim)
    "w_mlp": (("model",),),
    "w_vocab": (("model",),),
    "w_experts": (("model",),),       # expert parallelism
    "w_state": (None,),
    # kv-cache
    "cache_batch": (("pod", "data"), ("data",)),
    "cache_heads": (("model",),),
    # decode caches: the seq dim shards over model (flash-decoding-style
    # split-K); first-listed rule that divides wins.
    "cache_seq": (("model",), None),
}


#: rules for the data-parallel steps and the replicated engines: only the data axis
#: participates (pod and model axes stay replicated); unknown logical axes
#: replicate
DATA_ONLY_RULES: dict[str, tuple] = {
    "batch": (("data",),),
    "cache_batch": (("data",),),
}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: dict[str, tuple] = dict(DEFAULT_RULES)


_CTX = _Ctx()


@contextlib.contextmanager
def sharding_context(mesh, rules: Optional[dict] = None):
    """Install a mesh + logical rules for the specs computed in scope."""
    prev_mesh, prev_rules = _CTX.mesh, _CTX.rules
    _CTX.mesh = mesh
    _CTX.rules = dict(DEFAULT_RULES if rules is None else rules)
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev_mesh, prev_rules


def in_context(fn):
    """``fn`` run under the mesh and rules active now, wherever it is called
    from.  A checkpointed function's recompute runs inside the backward
    pass, on the card in autograd's device thread, where this thread-local
    context is not installed: without it a recomputed layer would forget
    its weights' splits and skip its collectives."""
    mesh, rules = _CTX.mesh, dict(_CTX.rules)

    def run(*args, **kw):
        with sharding_context(mesh, rules):
            return fn(*args, **kw)
    return run


def override_rules(**updates):
    """Update rules inside the active context."""
    _CTX.rules.update(updates)


def note_mesh_fallback(logical: str):
    """Count one replicate-instead-of-shard fallback
    (``spring_mesh_fallback_total``, labeled by logical axis)."""
    from repro_torch.telemetry.metrics import default_registry

    default_registry().inc(
        "spring_mesh_fallback_total", 1.0, logical=logical,
        help="tensors replicated because no rule candidate divided")


def mesh_fallback_counts() -> dict:
    """{logical axis: fallback count} from the process metrics registry."""
    from repro_torch.telemetry.metrics import default_registry

    snap = default_registry().snapshot()
    fam = snap.get("spring_mesh_fallback_total", {})
    return {cell["labels"].get("logical", "?"): int(cell["value"])
            for cell in fam.get("cells", [])}


def _mesh_axes_for(logical: Optional[str], dim: int, mesh, count: bool = True) -> Optional[tuple]:
    """Resolve one logical axis to mesh axes, honoring divisibility."""
    if logical is None:
        return None
    candidates = _CTX.rules.get(logical, (None,))
    had_candidate = False
    for cand in candidates:
        if cand is None:
            return None
        axes = tuple(a for a in cand if a in mesh.shape)
        if not axes:
            continue
        extent = 1
        for a in axes:
            extent *= mesh.shape[a]
        if extent > 1:
            had_candidate = True
        if dim % extent == 0:
            return axes
    if had_candidate and count:
        # a rule wanted to shard this tensor but no candidate divided:
        # replicate, and make the fallback visible
        note_mesh_fallback(logical)
    return None


def logical_to_spec(logical_axes: Sequence[Optional[str]], shape: Sequence[int], mesh,
                    count: bool = True) -> tuple:
    """The spec (a tuple of ``PartitionSpec`` entries) for ``shape`` from
    logical axis names; ``count=False`` leaves the fallback counter alone
    (a layer asking again at every call)."""
    used: set[str] = set()
    parts = []
    for name, dim in zip(logical_axes, shape):
        axes = _mesh_axes_for(name, dim, mesh, count)
        if axes is None or any(a in used for a in axes):
            parts.append(None)
        else:
            used.update(axes)
            parts.append(axes if len(axes) > 1 else axes[0])
    return tuple(parts)


@dataclasses.dataclass(frozen=True)
class Split:
    """How a weight of ``full`` shape is split over the ``model`` axis:
    along ``dim`` into equal parts, this rank holding indices ``[lo,
    hi)``.  ``kind`` is ``"col"`` for the last dim (a dense kernel's
    outputs: the rank computes its own columns) and ``"row"`` for another
    (a kernel's inputs: the rank's product is a partial sum; an embedding's
    vocabulary rows)."""

    kind: str
    dim: int
    full: tuple
    lo: int
    hi: int

    def take(self, x, dim: Optional[int] = None):
        """This rank's part of a whole tensor along ``dim`` (the split's)."""
        return x.narrow(self.dim if dim is None else dim, self.lo, self.hi - self.lo)

    def counter(self) -> tuple[int, int]:
        """The shard's SR counter geometry ``(base, row_stride)``."""
        from repro_torch.kernels.stochastic_round.ops import shard_counter

        return shard_counter(self.full, self.dim, self.lo)


def split_of(spec: tuple, full_shape: Sequence[int], mesh) -> Optional[Split]:
    """The :class:`Split` a spec names over ``model`` on ``mesh`` (None:
    the tensor is whole on every rank of the model axis)."""
    n = int(dict(mesh.shape).get("model", 1)) if mesh is not None else 1
    if n == 1:
        return None
    for dim, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        if "model" not in axes:
            continue
        if len(axes) > 1:
            raise NotImplementedError(f"a dim split jointly over {axes} is not ported")
        size, r = full_shape[dim] // n, mesh.axis_index("model")
        kind = "col" if dim == len(full_shape) - 1 else "row"
        return Split(kind, dim, tuple(full_shape), r * size, (r + 1) * size)
    return None


def weight_split(logical_axes: Sequence[Optional[str]], full_shape: Sequence[int]) -> Optional[Split]:
    """Which way the active mesh splits a weight of ``full_shape`` whose
    dims carry ``logical_axes``: its :class:`Split` over ``model``, or None
    (replicated: no mesh, a ``model`` extent of 1, rules that keep
    ``model`` out, or the divisibility fallback)."""
    mesh = _CTX.mesh
    if mesh is None or int(dict(mesh.shape).get("model", 1)) == 1:
        return None
    return split_of(logical_to_spec(logical_axes, full_shape, mesh, count=False),
                    full_shape, mesh)


def constrain(x, logical_axes: Sequence[Optional[str]]):
    """The reference's sharding constraint: the identity here, as no
    compiler lays tensors out (ranks run their shard's work themselves)."""
    return x


def named_sharding(logical_axes: Sequence[Optional[str]], shape: Sequence[int], mesh) -> tuple:
    """``(mesh, spec)``: the port's stand-in for a ``NamedSharding``."""
    return mesh, logical_to_spec(logical_axes, shape, mesh)


def active_mesh():
    return _CTX.mesh
