"""Packed collectives: ``packed_all_gather`` / ``packed_reduce_scatter``
(port of ``repro/dist/collectives.py``).

SPRING's binary-mask format on the *wire*: a collective payload travels
as its non-zeros collapsed to the front at the 20-bit SPRING value width
plus 1-bit-per-element packed occupancy words, so the link moves
``20·density + 1`` bits/elem at word alignment instead of a dense fp32's
32.  Protocol per rank: pack the local shard -> all-gather the (values,
mask-words) pair -> unpack every row -> concatenate (all-gather) or
pairwise-tree-sum and keep the own shard (reduce-scatter).

Both ops have two modes:

  simulation   ``axis_name=None``; the input is the stacked per-rank
               payload ``(D, n)`` and the collective is replayed locally.
  collective   ``axis_name="data"`` (or any axis of the mesh that
               ``sharding_context`` installed); the input is this rank's
               ``(n,)`` shard and the hop is :meth:`Mesh.all_gather` over
               the axis's process group.

Bit-exactness: the reduction is a fixed pairwise tree (power-of-two
worlds only), so summing D identical addends yields exactly ``D·x`` and
the later ``/D`` rescale is an exact exponent shift.  The only value
canonicalization is ``-0.0 -> +0.0`` (occupancy bit 0).

The pack: on a card tensor the mask words come from the ``mask_pack``
kernel (one counted launch), as the reference's Pallas route takes them
from ``mask_pack_pallas``; on a CPU tensor from the plain word pack.  The
collapse is ``core.masking.collapse_to_front`` on both.  ``impl`` keeps
the reference's signature: ``None`` / ``"auto"``, or a name the tensor's
device runs (``"pallas"`` on the card, ``"ref"`` / ``"jnp"`` on the CPU).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.api import threefry
from repro_torch.core.masking import (
    MASK_WORD_BITS,
    _n_words,
    collapse_to_front,
    expand_from_mask,
    pack_mask_bits,
    unpack_mask_bits,
)
from repro_torch.kernels import registry
from repro_torch.kernels.mask_compress.ops import pack_words

#: SPRING wire width of one live value (IL4 + FL16 fixed point)
COLLECTIVE_VALUE_BITS = 20


# -- pack / unpack -------------------------------------------------------------


def _pack_device(flat: torch.Tensor) -> tuple:
    """(values collapsed to the front, mask words): the words from the
    ``mask_pack`` kernel on a card tensor, the plain pack on a CPU one."""
    return collapse_to_front(flat, flat != 0, flat.shape[0]), pack_words(flat)


def _pack_plain(flat: torch.Tensor) -> tuple:
    bits = flat != 0
    return collapse_to_front(flat, bits, flat.shape[0]), pack_mask_bits(bits)


def _unpack(values: torch.Tensor, words: torch.Tensor, length: int) -> torch.Tensor:
    return expand_from_mask(values, unpack_mask_bits(words, length))


def _tree_sum(rows: torch.Tensor) -> torch.Tensor:
    """Fixed pairwise reduction over axis 0 — the bit-exactness seal.
    Requires a power-of-two row count (RunSpec validates mesh.data)."""
    d = rows.shape[0]
    if d & (d - 1):
        raise ValueError(f"packed reduce: world size must be a power of two, got {d}")
    while rows.shape[0] > 1:
        rows = rows[0::2] + rows[1::2]
    return rows[0]


def _axis_mesh(axis_name: str):
    from repro_torch.runtime.sharding import active_mesh

    mesh = active_mesh()
    if mesh is None or axis_name not in mesh.shape:
        raise ValueError(f"axis_name={axis_name!r}: no mesh with that axis is installed "
                         "(run inside sharding_context(mesh))")
    return mesh


def _gather_rows(x: torch.Tensor, axis_name: str, pack) -> tuple:
    """Pack this rank's ``(n,)`` shard, all-gather the pair over the axis
    and unpack every row: ``((D, n) rows, mesh)``."""
    (n,) = x.shape
    mesh = _axis_mesh(axis_name)
    v, w = pack(x)
    vg, wg = mesh.all_gather(v, axis_name), mesh.all_gather(w, axis_name)
    del v, w
    return torch.stack([_unpack(vg[i], wg[i], n) for i in range(vg.shape[0])]), mesh


def _make_all_gather(pack):
    def fn(x: torch.Tensor, *, axis_name: Optional[str] = None) -> torch.Tensor:
        if axis_name is None:
            d, n = x.shape
            return torch.cat([_unpack(*pack(x[i]), n) for i in range(d)])
        rows, _ = _gather_rows(x, axis_name, pack)
        return rows.reshape(-1)

    return fn


def _make_reduce_scatter(pack):
    def fn(x: torch.Tensor, *, axis_name: Optional[str] = None) -> torch.Tensor:
        if axis_name is None:
            d, n = x.shape
            if n % d:
                raise ValueError(f"payload length {n} not divisible by world {d}")
            rows = torch.stack([_unpack(*pack(x[i]), n) for i in range(d)])
            return _tree_sum(rows).reshape(d, n // d)
        (n,) = x.shape
        mesh = _axis_mesh(axis_name)
        d = mesh.axis_size(axis_name)
        if n % d:
            raise ValueError(f"payload length {n} not divisible by world {d}")
        rows, _ = _gather_rows(x, axis_name, pack)
        shard = n // d
        i = mesh.axis_index(axis_name)
        return _tree_sum(rows)[i * shard:(i + 1) * shard]

    return fn


#: the ops on the device's pack (the kernel's words on a card tensor)
all_gather_device = _make_all_gather(_pack_device)
reduce_scatter_device = _make_reduce_scatter(_pack_device)
#: their plain versions (the plain word pack on any device)
all_gather_plain = _make_all_gather(_pack_plain)
reduce_scatter_plain = _make_reduce_scatter(_pack_plain)


# -- dense references (same tree order => per-shard bit-identity) ------------


def dense_all_gather(x: torch.Tensor, *, axis_name: Optional[str] = None) -> torch.Tensor:
    """Uncompressed reference with the packed op's exact semantics."""
    if axis_name is None:
        return x.reshape(-1)
    return _axis_mesh(axis_name).all_gather(x, axis_name).reshape(-1)


def dense_reduce_scatter(x: torch.Tensor, *, axis_name: Optional[str] = None) -> torch.Tensor:
    """Uncompressed reference using the same pairwise tree reduction."""
    if axis_name is None:
        d, n = x.shape
        return _tree_sum(x).reshape(d, n // d)
    (n,) = x.shape
    mesh = _axis_mesh(axis_name)
    rows = mesh.all_gather(x, axis_name)
    shard = n // rows.shape[0]
    i = mesh.axis_index(axis_name)
    return _tree_sum(rows)[i * shard:(i + 1) * shard]


# -- registry examples --------------------------------------------------------


def _shard_block(seed: int, d: int, n: int, density: float,
                 dtype=torch.float32) -> torch.Tensor:
    """Stacked per-rank payload with elementwise density (sim mode).  The
    zero pattern is the reference's (``uniform(fold_in(PRNGKey(seed), 1),
    (d, n)) < density`` by the threefry stream); the live values are
    numpy normals, non-zero."""
    keep = threefry.uniform(threefry.fold_in(threefry.prng_key(seed), 1), (d, n)) < density
    x = np.random.default_rng(seed).standard_normal((d, n)).astype(np.float32)
    return torch.from_numpy(np.where(keep, x, np.float32(0.0))).to(dtype)


def collective_examples() -> list:
    """The reference's four cases: dense fp32, quant (bf16 at ReLU-ish
    density), quant_sparse (pruned, word-unaligned), empty."""
    return [
        ((_shard_block(0, 2, 1024, 1.0),), {}),
        ((_shard_block(1, 4, 512, 0.5, torch.bfloat16),), {}),
        ((_shard_block(2, 4, 500, 0.1),), {}),
        ((torch.zeros((2, 64), dtype=torch.float32),), {}),
    ]


# -- public wrappers ----------------------------------------------------------


def _check_impl(impl: Optional[str], x: torch.Tensor) -> None:
    honours = ("pallas",) if x.is_cuda else ("ref", "jnp")
    if impl not in (None, "auto") + honours:
        raise ValueError(f"impl={impl!r} cannot run on a {x.device.type} tensor, which "
                         f"honours {('auto',) + honours}")


def collective_wire_bits(nnz, length: int, world: int,
                         value_bits: int = COLLECTIVE_VALUE_BITS):
    """Bits the link moves for one collective: every rank contributes its
    live values at the SPRING width plus its packed mask words.  At word
    alignment this is ``world * length * (value_bits*density + 1)``."""
    return nnz * value_bits + world * _n_words(length) * MASK_WORD_BITS


def _note(op: str, x: torch.Tensor, axis_name: Optional[str]) -> None:
    # host-side wire accounting: simulation mode only, as in the reference
    if axis_name is not None:
        return
    d, n = x.shape
    nnz = float(torch.count_nonzero(x))
    wire = float(collective_wire_bits(nnz, n, d)) / 8.0
    density = nnz / float(d * n) if d * n else 0.0
    from repro_torch.telemetry.metrics import default_registry

    reg = default_registry()
    reg.inc("spring_mesh_collective_bytes_total", wire, kind=op,
            help="packed-collective wire bytes (formula accounting)")
    reg.observe("spring_mesh_collective_density", density, kind=op,
                help="elementwise density of collective payloads")
    if registry.metrics_active():
        registry.note_metric(op, wire_bytes=wire, density=density)


def packed_all_gather(x: torch.Tensor, *, axis_name: Optional[str] = None,
                      impl: Optional[str] = None) -> torch.Tensor:
    """All-gather through the packed wire format.

    Simulation mode (``axis_name=None``): ``x`` is ``(D, n)`` stacked
    payloads; returns the ``(D*n,)`` rank-order concatenation every rank
    would hold.  Collective mode: ``x`` is the local ``(n,)`` shard;
    returns ``(D*n,)`` on every rank of the axis.
    """
    _check_impl(impl, x)
    out = all_gather_device(x, axis_name=axis_name)
    _note("packed_all_gather", x, axis_name)
    return out


def packed_reduce_scatter(x: torch.Tensor, *, axis_name: Optional[str] = None,
                          impl: Optional[str] = None) -> torch.Tensor:
    """Reduce-scatter (pairwise-tree sum) through the packed wire format.

    Simulation mode: ``x`` is ``(D, n)``; returns the ``(D, n//D)``
    stacked shards.  Collective mode: local ``(n,)`` in, own ``(n//D,)``
    shard out.
    """
    _check_impl(impl, x)
    out = reduce_scatter_device(x, axis_name=axis_name)
    _note("packed_reduce_scatter", x, axis_name)
    return out


def packed_all_reduce_mean(flat: torch.Tensor, *, axis_name: str, world: int,
                           impl: Optional[str] = None) -> torch.Tensor:
    """Mean-all-reduce as RS -> /world -> AG (both hops packed).

    Exact when the per-rank inputs are identical and ``world`` is a power
    of two: the tree sum yields exactly ``world*x`` and the rescale is an
    exponent shift.
    """
    n = flat.shape[0]
    pad = (-n) % world
    if pad:
        flat = torch.cat([flat, torch.zeros((pad,), dtype=flat.dtype, device=flat.device)])
    shard = packed_reduce_scatter(flat, axis_name=axis_name, impl=impl)
    shard = shard / world
    full = packed_all_gather(shard, axis_name=axis_name, impl=impl)
    return full[:n]


def collective_probe(density: float = 0.5, world: int = 2, length: int = 1 << 14,
                     impl: Optional[str] = None, device="cpu") -> dict:
    """Eager packed-collective probe: one all-gather in simulation mode at
    the given payload density on ``device``, with its wire accounting:
    bytes moved, the reduction vs a dense fp32 collective, the
    measured-over-formula ratio (1.0 at word alignment) and whether the
    round trip reproduced the payload bit-exactly.  ``impl`` names what ran
    in the reference's terms (``pallas`` on the card, ``jnp`` on the CPU
    under ``auto``)."""
    from repro_torch.memstash.format import formula_bits_per_elem

    x = _shard_block(0, world, length, density).to(device)
    out = packed_all_gather(x, impl=impl)
    nnz = int(torch.count_nonzero(x))
    wire = float(collective_wire_bits(nnz, length, world)) / 8.0
    dense_bytes = world * length * 4.0
    formula = world * length * formula_bits_per_elem(
        nnz / (world * length), COLLECTIVE_VALUE_BITS) / 8.0
    return {
        "world": world,
        "density": nnz / (world * length),
        "wire_bytes": wire,
        "dense_bytes": dense_bytes,
        "compression_vs_fp32": dense_bytes / wire,
        "wire_vs_formula": wire / formula,
        "exact": bool(torch.equal(out, x.reshape(-1))),
        "impl": impl if impl not in (None, "auto") else ("pallas" if x.is_cuda else "jnp"),
    }
