"""Logical-axis sharding rules (port of ``repro/runtime/sharding.py``).

Tensors are annotated with *logical* axis names; a rules table maps each
logical axis to mesh axes.  :func:`logical_to_spec` drops a mesh axis
whenever the dimension is not divisible by the axis's extent — the tensor
is replicated along that axis instead — and counts the fallback in
``spring_mesh_fallback_total{logical=...}``.

A spec is a tuple of the reference's ``PartitionSpec`` entries, one per
dimension: ``None`` (replicated), a mesh axis name, or a tuple of names
sharded jointly.  The port has no SPMD compiler, so nothing lays a tensor
out by these specs: :mod:`repro_torch.dist` slices its rows by them, and
:func:`constrain` is the identity (the reference's
``with_sharding_constraint`` never changes a value either).  Partitioning
tensors over the ``model`` axis and FSDP over ``data`` (the ``w_*`` rules)
are not ported: a ``model > 1`` mesh runs each rank's work replicated.

Mesh axes:
  pod    — inter-pod data parallelism
  data   — intra-pod data parallelism for activations, FSDP for weights
  model  — tensor parallelism (heads / ffn / vocab / experts)

A mesh here is anything with a ``shape`` mapping of axis name -> extent
(:class:`repro_torch.dist.mesh.Mesh`, or a stub in a test).
"""

from __future__ import annotations

import contextlib
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


def _mesh_axes_for(logical: Optional[str], dim: int, mesh) -> Optional[tuple]:
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
    if had_candidate:
        # a rule wanted to shard this tensor but no candidate divided:
        # replicate, and make the fallback visible
        note_mesh_fallback(logical)
    return None


def logical_to_spec(logical_axes: Sequence[Optional[str]], shape: Sequence[int], mesh) -> tuple:
    """The spec (a tuple of ``PartitionSpec`` entries) for ``shape`` from
    logical axis names."""
    used: set[str] = set()
    parts = []
    for name, dim in zip(logical_axes, shape):
        axes = _mesh_axes_for(name, dim, mesh)
        if axes is None or any(a in used for a in axes):
            parts.append(None)
        else:
            used.update(axes)
            parts.append(axes if len(axes) > 1 else axes[0])
    return tuple(parts)


def constrain(x, logical_axes: Sequence[Optional[str]]):
    """The reference's sharding constraint: the identity here, as no
    compiler lays tensors out (ranks run their shard's work themselves)."""
    return x


def named_sharding(logical_axes: Sequence[Optional[str]], shape: Sequence[int], mesh) -> tuple:
    """``(mesh, spec)``: the port's stand-in for a ``NamedSharding``."""
    return mesh, logical_to_spec(logical_axes, shape, mesh)


def active_mesh():
    return _CTX.mesh
