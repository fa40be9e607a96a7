"""Slot-indexed persistent KV cache, stored binary-mask compressed (port of
``repro/serving/kvpool.py``).

The pool mirrors the ``lm_init_cache`` tree — ``{"pos": (S,) per-slot
positions, "unit_u": {"k", "v"}}`` with ``(n_units, S, max_len, KV, D)``
leaves, plus ``"suffix_i"`` / ``"prefix_i"`` subtrees of unrolled layers
— with every seq-bearing leaf (full-attention ``k`` / ``v``, MLA's
``ckv`` / ``krope`` with the seq axis at -2, window rings ``k_ring`` /
``v_ring``) replaced by a :class:`PackedKV`: per
(layer, slot) block, the non-zeros collapsed to the front of a
dense-length value buffer plus one occupancy bit per element.  Packing a
leaf is one ``kv_pack`` call over all its blocks, so on the card its mask
words come from one ``mask_pack`` kernel launch.  Unpack and pack
round-trip bit-exactly, so decoding against the unpacked pool is
numerically identical to decoding against the dense cache.

The O(1) state leaves (SSM ``conv`` / ``ssm``, RG-LRU ``conv`` / ``h``)
and the per-slot position vector pass through dense, as in the reference
(``kvpool.py:1-18``): installed per slot, merged per active row, never
packed.  Rings are packed like any block and never padded (they are
``window`` rows from the prefill on).  A leaf under a ``unit_*`` key has
the layers stacked in front, so its slot axis is axis 1; under a
``prefix_*`` / ``suffix_*`` key it is axis 0 (:func:`slot_axis`).

Slot surgery (install, release, restore) writes the pool in place; the
reference's versions are pure functions inside jitted programs.  So what
must outlive the next surgery is copied out: a spilled slot's payload
(:func:`extract_slot_packed`) and a snapshot's leaves
(:func:`pool_leaves`) are host copies, never views of the pool.  Mask
words move through an int32 view (torch has few uint32 kernels).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.masking import MASK_WORD_BITS, _n_words
from repro_torch.kernels.kv_cache.ops import KV_VALUE_BITS, kv_pack, kv_unpack
from repro_torch.runtime.tree_sharding import HEAD_LEAVES

#: seq axis (negative, from the end) of each packable cache leaf; the slot
#: axis is the one just before it
PACKED_SEQ_AXIS = {"k": -3, "v": -3, "ckv": -2, "krope": -2, "k_ring": -3, "v_ring": -3}


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
    """The layer subtrees of a cache or pool tree (``unit_*``, ``prefix_*``,
    ``suffix_*``): every key but ``pos``."""
    return [name for name in tree if name != "pos"]


def _at(t: torch.Tensor, ax: int, slot: int) -> torch.Tensor:
    """The view of ``t`` at index ``slot`` of axis ``ax`` (int32 words for
    uint32)."""
    return word_view(t).select(ax, slot)


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
        ax = slot_axis((unit,))
        for name, leaf in pool[unit].items():
            if not isinstance(leaf, PackedKV):
                _at(leaf, ax, slot).copy_(prefill_cache[unit][name].select(ax, 0))
                continue
            row = _pad_seq(prefill_cache[unit][name].to(leaf.dtype), name,
                           leaf.shape[len(leaf.shape) + PACKED_SEQ_AXIS[name]])
            packed = pack_leaf(row, name)  # lead (n_units, 1) or (1,)
            for part in ("values", "mask", "nnz"):
                _at(getattr(leaf, part), ax, slot).copy_(_at(getattr(packed, part), ax, 0))
    return pool


def release_packed(pool: dict, slot: int) -> dict:
    """Zero one slot's blocks (position, occupancy, values) so a retired
    request stops counting toward density and wire accounting."""
    pool["pos"][slot] = 0
    for unit in _units(pool):
        ax = slot_axis((unit,))
        for leaf in pool[unit].values():
            parts = ([getattr(leaf, p) for p in ("values", "mask", "nnz")]
                     if isinstance(leaf, PackedKV) else [leaf])
            for t in parts:
                _at(t, ax, slot).zero_()
    return pool


def _pad_seq(row: torch.Tensor, name: str, length: int) -> torch.Tensor:
    """A batch-1 prefill leaf zero-padded along its seq axis to ``length``."""
    ax_seq = row.ndim + PACKED_SEQ_AXIS[name]
    extra = length - row.shape[ax_seq]
    if extra < 0:
        raise ValueError(f"{name}: prefill length {row.shape[ax_seq]} exceeds "
                         f"pool max_len {length}")
    if extra:
        pad = [0, 0] * (row.ndim - ax_seq - 1) + [0, extra]
        row = torch.nn.functional.pad(row, pad)
    return row


def install_prefill(dense_pool: dict, prefill_cache: dict, slot: int, prompt_len: int) -> dict:
    """Write one prefilled request (batch-1 cache) into ``slot`` of a dense
    pool tree, in place: every leaf's whole slot row is overwritten (seq
    tails zero-padded), so a reused slot keeps nothing of its previous
    tenant.  ``None`` holes (the paged store's stripped leaves) are
    skipped."""
    dense_pool["pos"][slot] = prompt_len
    for unit in _units(dense_pool):
        ax = slot_axis((unit,))
        for name, leaf in dense_pool[unit].items():
            if leaf is None:
                continue
            row = lookup(prefill_cache, (unit, name)).to(leaf.dtype)
            if name in PACKED_SEQ_AXIS:
                row = _pad_seq(row, name, leaf.shape[leaf.ndim + PACKED_SEQ_AXIS[name]])
            leaf.select(ax, slot).copy_(row.select(ax, 0))
    return dense_pool


def lookup(tree: dict, path: tuple):
    """The node of ``tree`` at ``path`` (its keys from the root)."""
    node = tree
    for key in path:
        node = node[key]
    return node


def merge_active(new_cache: dict, old_cache: dict, active: torch.Tensor) -> dict:
    """Keep the decode step's updates only for active slots (idle slots must
    not advance position or accrete garbage KV)."""
    out = {"pos": torch.where(active, new_cache["pos"], old_cache["pos"])}
    for unit in _units(new_cache):
        out[unit] = {}
        for name, new in new_cache[unit].items():
            shape = [1] * new.ndim
            shape[slot_axis((unit,))] = active.shape[0]
            out[unit][name] = torch.where(active.reshape(shape), new, old_cache[unit][name])
    return out


# -- spill / resume: one slot's exact packed bits -------------------------------


def slot_axis(path: tuple) -> int:
    """Slot (batch) axis of the cache leaf at ``path`` (its keys from the
    root): leaves under a ``unit_*`` key stack the layers in front of it;
    ``prefix_*`` / ``suffix_*`` leaves (one layer each) and ``pos`` have it
    first."""
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
    sorted, a PackedKV as its values, mask, nnz, a ``None`` hole as no
    leaf."""
    if tree is None:
        return []
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


def pool_wire_stats(pool: dict, value_bits: int = KV_VALUE_BITS, heads=None) -> dict:
    """Measured SPRING-interface traffic of the packed pool vs its dense
    footprints: live values at the 20-bit storage width + the mask words
    actually stored, against the full dense fp32 allocation.  Under a
    ``heads`` split (``runtime.tree_sharding.KVHeadSplit``) ``pool`` is
    this rank's and the figures are the whole pool's, its counts summed
    over ``model`` (:meth:`KVHeadSplit.total`): every rank reports, and
    decides from, the same numbers."""
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
    if heads is not None:
        nnz_total, mask_bits, elems, logical_bytes = heads.total(
            [nnz_total, mask_bits, elems, logical_bytes])
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


#: the recurrent state leaves of a cache (the SSM's, the RG-LRU's)
STATE_LEAVES = ("conv", "ssm", "h")


def state_bytes(tree) -> int:
    """The bytes of a cache's (or pool's, or slot state's) recurrent state
    leaves."""
    from repro_torch.runtime.tree_sharding import map_with_path

    sizes: list = []
    map_with_path(lambda path, leaf: sizes.append(leaf.numel() * leaf.element_size())
                  if path[-1] in STATE_LEAVES else None, tree)
    return sum(sizes)


# -- tensor parallelism: the pool's leaves by kv head, head and channel --------


def repack(values: torch.Tensor, mask: torch.Tensor, shape: tuple, fn) -> dict:
    """Packed blocks (``values`` (*lead, block) and their ``mask``) of a
    dense leaf of ``shape`` unpacked, mapped by ``fn`` (kv heads at dim -2)
    and packed again by one ``kv_pack`` a leaf: ``{"values", "mask",
    "nnz", "shape"}``, on ``values``' device."""
    lead = tuple(values.shape[:-1])
    dense = kv_unpack(values, mask, values.shape[-1]).reshape(shape).to(values.dtype)
    out = fn(dense)
    return dict(kv_pack(out.reshape(*lead, -1)), shape=tuple(out.shape))


def _dense_shape(leaf: PackedKV, name: str, values: torch.Tensor) -> tuple:
    """The dense shape of ``values``' blocks, packed from a leaf of
    ``leaf``'s layout with its lead dims and head count those ``values``
    carry (the heads follow from the block length)."""
    ax = len(leaf.shape) + PACKED_SEQ_AXIS[name]
    rows, d = leaf.shape[ax], leaf.shape[-1]
    return (*values.shape[:-1], rows, values.shape[-1] // (rows * d), d)


def map_heads(pool: dict, fn) -> dict:
    """``pool`` with every leaf's dense form mapped by ``fn(key, name,
    leaf)`` (``key`` the cache subtree, ``name`` the leaf): a
    ``runtime.tree_sharding.PoolSplit``'s ``whole`` (every rank's heads
    and state parts gathered: the whole pool's layout, a collective per
    split leaf) or ``local`` (this rank's part of a whole pool).  A
    PackedKV leaf that ``fn`` splits is unpacked, mapped and packed again;
    ``pos`` passes through."""
    out = {"pos": pool["pos"]}
    for unit in _units(pool):
        out[unit] = {}
        for name, leaf in pool[unit].items():
            if isinstance(leaf, PackedKV):
                if name in HEAD_LEAVES:
                    r = repack(leaf.values, leaf.mask, _dense_shape(leaf, name, leaf.values),
                               lambda x: fn(unit, name, x))
                    leaf = PackedKV(values=r["values"], mask=r["mask"], nnz=r["nnz"],
                                    shape=r["shape"], dtype=leaf.dtype)
            else:
                leaf = fn(unit, name, leaf)
            out[unit][name] = leaf
    return out


def map_slot_heads(payload: dict, pool: dict, fn) -> dict:
    """A slot payload (:func:`extract_slot_packed`) of a pool laid out as
    ``pool``, in another layout (:func:`map_heads`'s ``fn``), as host
    copies."""
    out = {"pos": payload["pos"]}
    for unit in _units(pool):
        out[unit] = {}
        for name, leaf in pool[unit].items():
            p = payload[unit][name]
            if isinstance(leaf, PackedKV):
                if name in HEAD_LEAVES:
                    values = as_tensor(p["values"])
                    r = repack(values, as_tensor(p["mask"]), _dense_shape(leaf, name, values),
                               lambda x: fn(unit, name, x))
                    p = {part: host_copy(r[part]) for part in ("values", "mask", "nnz")}
            else:
                p = host_copy(fn(unit, name, as_tensor(p)))
            out[unit][name] = p
    return out


def map_dense_heads(tree, fn):
    """A tree of dense cache leaves (the paged engine's slot state) with its
    attention leaves (:data:`HEAD_LEAVES`) mapped by ``fn``; ``None``
    holes and the rest as they are."""
    if not isinstance(tree, dict):
        return tree
    return {k: (fn(as_tensor(v)) if k in HEAD_LEAVES and v is not None
                else map_dense_heads(v, fn)) for k, v in tree.items()}
