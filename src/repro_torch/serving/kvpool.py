"""Slot-indexed persistent KV cache, stored binary-mask compressed (port of
``repro/serving/kvpool.py``).

The pool mirrors the ``lm_init_cache`` tree — ``{"pos": (S,) per-slot
positions, "unit_u": {"k", "v"}}`` with ``(n_units, S, max_len, KV, D)``
leaves — with every k/v leaf replaced by a :class:`PackedKV`: per
(layer, slot) block, the non-zeros collapsed to the front of a
dense-length value buffer plus one occupancy bit per element.  Packing a
leaf is one ``kv_pack`` call over all its blocks, so on the card its mask
words come from one ``mask_pack`` kernel launch.  Unpack and pack
round-trip bit-exactly, so decoding against the unpacked pool is
numerically identical to decoding against the dense cache.

The O(1) SSM state leaves (``conv``, ``ssm``) and the per-slot position
vector pass through dense, as in the reference (``kvpool.py:1-18``):
installed per slot, merged per active row, never packed.  Every cache leaf
sits under a ``unit_*`` key with the layers stacked in front, so its slot
axis is axis 1.

Slot surgery (install, release, restore) writes the pool in place; the
reference's versions are pure functions inside jitted programs.  So what
must outlive the next surgery is copied out: a spilled slot's payload
(:func:`extract_slot_packed`) and a snapshot's leaves
(:func:`pool_leaves`) are host copies, never views of the pool.  Mask
words move through an int32 view (torch has few uint32 kernels).
Sliding-window rings and MLA latents are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.masking import MASK_WORD_BITS, _n_words
from repro_torch.kernels.kv_cache.ops import KV_VALUE_BITS, kv_pack, kv_unpack

#: seq axis (negative, from the end) of each packable cache leaf; the slot
#: axis is the one just before it
PACKED_SEQ_AXIS = {"k": -3, "v": -3}


@dataclasses.dataclass
class PackedKV:
    """One cache leaf in packed form."""

    values: torch.Tensor  # (*lead, block_len) leaf dtype
    mask: torch.Tensor    # (*lead, ceil(block_len/32)) uint32
    nnz: torch.Tensor     # (*lead,) int32
    shape: tuple          # original dense leaf shape
    dtype: torch.dtype

    @property
    def block_len(self) -> int:
        return int(self.values.shape[-1])

    @property
    def n_blocks(self) -> int:
        return int(math.prod(self.values.shape[:-1]))


def _units(tree: dict) -> list:
    return [name for name in tree if name.startswith("unit_")]


def pack_leaf(leaf: torch.Tensor, name: str) -> PackedKV:
    ax = leaf.ndim + PACKED_SEQ_AXIS[name]  # first block dim (seq)
    lead = leaf.shape[:ax]
    block = int(math.prod(leaf.shape[ax:]))
    packed = kv_pack(leaf.reshape(*lead, block))
    return PackedKV(values=packed["values"], mask=packed["mask"], nnz=packed["nnz"],
                    shape=tuple(leaf.shape), dtype=leaf.dtype)


def pack_cache(cache: dict) -> dict:
    """Dense cache tree (with (S,) ``pos``) -> pool tree: k/v leaves become
    PackedKV, state leaves pass through."""
    pool = {"pos": cache["pos"]}
    for unit in _units(cache):
        pool[unit] = {name: pack_leaf(leaf, name) if name in PACKED_SEQ_AXIS else leaf
                      for name, leaf in cache[unit].items()}
    return pool


def unpack_cache(pool: dict) -> dict:
    """Pool tree -> dense cache tree (``pack_cache`` inverse, bit-exact)."""
    cache = {"pos": pool["pos"]}
    for unit in _units(pool):
        cache[unit] = {
            name: (kv_unpack(leaf.values, leaf.mask, leaf.block_len)
                   .reshape(leaf.shape).to(leaf.dtype)
                   if isinstance(leaf, PackedKV) else leaf)
            for name, leaf in pool[unit].items()}
    return cache


def init_pool(cfg, n_slots: int, max_len: int, dtype=torch.bfloat16, *,
              device=None) -> dict:
    """Empty packed pool: ``lm_init_cache`` over the slot dimension with a
    per-slot position vector (zeros; slots are installed mid-flight)."""
    from repro_torch.models.lm import lm_init_cache

    cache = lm_init_cache(cfg, n_slots, max_len, dtype, device=device)
    cache["pos"] = torch.zeros((n_slots,), dtype=torch.int64, device=device)
    return pack_cache(cache)


# -- mid-flight slot surgery (in place) ---------------------------------------


def install_packed(pool: dict, prefill_cache: dict, slot: int, prompt_len: int) -> dict:
    """Write one prefilled request (batch-1 cache) into ``slot`` of the
    packed pool: only the new slot's blocks are packed (one ``kv_pack`` per
    leaf) and written; the other slots' packed state is untouched.  The
    whole slot row is overwritten (seq tail zero-padded), so a reused slot
    keeps nothing of its previous tenant.  State leaves are copied in."""
    pool["pos"][slot] = prompt_len
    for unit in _units(pool):
        for name, leaf in pool[unit].items():
            if not isinstance(leaf, PackedKV):
                leaf[:, slot] = prefill_cache[unit][name][:, 0].to(leaf.dtype)
                continue
            row = prefill_cache[unit][name].to(leaf.dtype)
            ax_seq = row.ndim + PACKED_SEQ_AXIS[name]
            extra = leaf.shape[ax_seq] - row.shape[ax_seq]
            if extra < 0:
                raise ValueError(f"{name}: prefill length {row.shape[ax_seq]} exceeds "
                                 f"pool max_len {leaf.shape[ax_seq]}")
            if extra:
                pad = [0, 0] * (row.ndim - ax_seq - 1) + [0, extra]
                row = torch.nn.functional.pad(row, pad)
            packed = pack_leaf(row, name)  # lead (n_units, 1)
            leaf.values[:, slot] = packed.values[:, 0]
            leaf.mask.view(torch.int32)[:, slot] = packed.mask.view(torch.int32)[:, 0]
            leaf.nnz[:, slot] = packed.nnz[:, 0]
    return pool


def release_packed(pool: dict, slot: int) -> dict:
    """Zero one slot's blocks (position, occupancy, values) so a retired
    request stops counting toward density and wire accounting."""
    pool["pos"][slot] = 0
    for unit in _units(pool):
        for leaf in pool[unit].values():
            if not isinstance(leaf, PackedKV):
                leaf[:, slot] = 0
                continue
            leaf.values[:, slot] = 0
            leaf.mask.view(torch.int32)[:, slot] = 0
            leaf.nnz[:, slot] = 0
    return pool


def merge_active(new_cache: dict, old_cache: dict, active: torch.Tensor) -> dict:
    """Keep the decode step's updates only for active slots (idle slots must
    not advance position or accrete garbage KV)."""
    out = {"pos": torch.where(active, new_cache["pos"], old_cache["pos"])}
    for unit in _units(new_cache):
        out[unit] = {}
        for name, new in new_cache[unit].items():
            shape = [1] * new.ndim
            shape[1] = active.shape[0]  # the slot axis
            out[unit][name] = torch.where(active.reshape(shape), new, old_cache[unit][name])
    return out


# -- spill / resume: one slot's exact packed bits -------------------------------


def slot_axis(path: tuple) -> int:
    """Slot (batch) axis of the cache leaf at ``path`` (its keys from the
    root): leaves under a ``unit_*`` key stack the layers in front of it."""
    return 1 if path and str(path[0]).startswith("unit_") else 0


def word_view(t: torch.Tensor) -> torch.Tensor:
    """``t`` with uint32 words seen as int32 (the same bits), for copies."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def host_copy(t: torch.Tensor) -> torch.Tensor:
    """A contiguous CPU copy of ``t`` (a copy on the CPU too: the pool is
    written in place afterwards), dtype and bits kept."""
    out = torch.empty(t.shape, dtype=word_view(t).dtype)
    out.copy_(word_view(t))
    return out.view(t.dtype)


def extract_slot_packed(pool: dict, slot: int) -> dict:
    """One slot's row of the packed pool, bit-exact, as host copies:
    PackedKV leaves become ``{"values", "mask", "nnz"}`` dicts of the
    slot's packed blocks (copied, never repacked), dense state leaves and
    ``pos`` give their slot rows (the slot axis kept, of size 1).  The
    spill and rescale payload; :func:`restore_slot_packed` writes it back,
    possibly into another slot or another pool of the same shape."""
    out = {"pos": host_copy(pool["pos"].narrow(0, slot, 1))}
    for unit in _units(pool):
        out[unit] = {}
        for name, leaf in pool[unit].items():
            if not isinstance(leaf, PackedKV):
                out[unit][name] = host_copy(leaf.narrow(slot_axis((unit, name)), slot, 1))
                continue
            ax = len(leaf.shape) + PACKED_SEQ_AXIS[name] - 1  # the slot axis
            out[unit][name] = {part: host_copy(getattr(leaf, part).narrow(ax, slot, 1))
                               for part in ("values", "mask", "nnz")}
    return out


def as_tensor(x) -> torch.Tensor:
    """``x`` as a tensor; a numpy array is copied (bfloat16, which torch
    takes from no numpy array, through its uint16 bits)."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.array(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(x)


def _splice(dst: torch.Tensor, src, ax: int, slot: int) -> None:
    word_view(dst).narrow(ax, slot, 1).copy_(word_view(as_tensor(src)))


def restore_slot_packed(pool: dict, payload: dict, slot: int) -> dict:
    """Inverse of :func:`extract_slot_packed`: write a slot payload's exact
    packed bits into ``slot`` of the pool, in place, each leaf keeping its
    dtype (``pos`` is converted by value)."""
    _splice(pool["pos"], payload["pos"], 0, slot)
    for unit in _units(pool):
        for name, leaf in pool[unit].items():
            p = payload[unit][name]
            if not isinstance(leaf, PackedKV):
                _splice(leaf, p, slot_axis((unit, name)), slot)
                continue
            ax = len(leaf.shape) + PACKED_SEQ_AXIS[name] - 1
            for part in ("values", "mask", "nnz"):
                _splice(getattr(leaf, part), p[part], ax, slot)
    return pool


def pool_leaves(tree) -> list:
    """The leaves of a pool (or any dict/list tree of tensors and PackedKV)
    in the reference's order, ``jax.tree_util.tree_leaves``: dict keys
    sorted, a PackedKV as its values, mask, nnz."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in pool_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in pool_leaves(x)]
    if isinstance(tree, PackedKV):
        return [tree.values, tree.mask, tree.nnz]
    return [tree]


def pool_shapes(pool: dict, n_slots: int) -> list:
    """The shapes of :func:`pool_leaves` for this pool rebuilt at
    ``n_slots`` (every leaf's slot axis resized)."""
    shapes = []
    for key in sorted(pool):
        for leaf in pool_leaves(pool[key]):
            shape = list(leaf.shape)
            shape[slot_axis((key,))] = n_slots
            shapes.append(tuple(shape))
    return shapes


# -- host-side slot accounting ------------------------------------------------


class SlotLedger:
    """Host-side occupancy ledger guarding install/release pairing: double
    release (and double install) raise :class:`ValueError` at the call site
    instead of corrupting pool accounting downstream."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        self._occupied: set = set()

    @property
    def occupied(self) -> list:
        return sorted(self._occupied)

    def _check(self, slot: int) -> int:
        slot = int(slot)
        if not 0 <= slot < self.n_slots:
            raise ValueError(f"slot {slot} out of range [0, {self.n_slots})")
        return slot

    def install(self, slot: int) -> None:
        slot = self._check(slot)
        if slot in self._occupied:
            raise ValueError(f"slot {slot} is already installed (released nowhere?)")
        self._occupied.add(slot)

    def release(self, slot: int) -> None:
        slot = self._check(slot)
        if slot not in self._occupied:
            raise ValueError(f"double release: slot {slot} is not installed (released "
                             f"twice, or never installed)")
        self._occupied.discard(slot)


# -- wire accounting ----------------------------------------------------------


def pool_wire_stats(pool: dict, value_bits: int = KV_VALUE_BITS) -> dict:
    """Measured SPRING-interface traffic of the packed pool vs its dense
    footprints: live values at the 20-bit storage width + the mask words
    actually stored, against the full dense fp32 allocation."""
    mask_bits = 0.0
    elems = 0
    logical_bytes = 0.0
    nnz_parts = []
    for unit in _units(pool):
        for leaf in pool[unit].values():
            if not isinstance(leaf, PackedKV):
                continue
            n = leaf.n_blocks * leaf.block_len
            nnz_parts.append(leaf.nnz.sum(dtype=torch.int64))
            mask_bits += leaf.n_blocks * _n_words(leaf.block_len) * MASK_WORD_BITS
            elems += n
            logical_bytes += n * leaf.values.element_size()
    nnz_total = float(torch.stack(nnz_parts).sum()) if nnz_parts else 0.0  # one sync
    wire_bytes = (nnz_total * value_bits + mask_bits) / 8.0
    dense_fp32 = elems * 4.0
    return {
        "kv_elems": float(elems),
        "kv_nnz": nnz_total,
        "kv_density": nnz_total / elems if elems else 0.0,
        "kv_wire_bytes": wire_bytes,
        "kv_logical_bytes": logical_bytes,
        "kv_dense_fp32_bytes": dense_fp32,
        "kv_compression_vs_fp32": dense_fp32 / wire_bytes if wire_bytes else 0.0,
    }
