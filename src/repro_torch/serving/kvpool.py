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

Slot surgery (install, release) writes the pool in place; the reference's
versions are pure functions inside jitted programs.  Sliding-window rings,
MLA latents and O(1) state leaves are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

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
    """Dense cache tree (with (S,) ``pos``) -> pool tree of PackedKV leaves."""
    pool = {"pos": cache["pos"]}
    for unit in _units(cache):
        pool[unit] = {name: pack_leaf(leaf, name) for name, leaf in cache[unit].items()}
    return pool


def unpack_cache(pool: dict) -> dict:
    """Pool tree -> dense cache tree (``pack_cache`` inverse, bit-exact)."""
    cache = {"pos": pool["pos"]}
    for unit in _units(pool):
        cache[unit] = {
            name: kv_unpack(leaf.values, leaf.mask, leaf.block_len)
            .reshape(leaf.shape).to(leaf.dtype)
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


def _slot_index(name: str, leaf: PackedKV) -> tuple:
    slot_ax = len(leaf.shape) + PACKED_SEQ_AXIS[name] - 1
    return (slice(None),) * slot_ax


def install_packed(pool: dict, prefill_cache: dict, slot: int, prompt_len: int) -> dict:
    """Write one prefilled request (batch-1 cache) into ``slot`` of the
    packed pool: only the new slot's blocks are packed (one ``kv_pack`` per
    leaf) and written; the other slots' packed state is untouched.  The
    whole slot row is overwritten (seq tail zero-padded), so a reused slot
    keeps nothing of its previous tenant."""
    pool["pos"][slot] = prompt_len
    for unit in _units(pool):
        for name, leaf in pool[unit].items():
            row = prefill_cache[unit][name].to(leaf.dtype)
            ax_seq = row.ndim + PACKED_SEQ_AXIS[name]
            extra = leaf.shape[ax_seq] - row.shape[ax_seq]
            if extra < 0:
                raise ValueError(f"{name}: prefill length {row.shape[ax_seq]} exceeds "
                                 f"pool max_len {leaf.shape[ax_seq]}")
            if extra:
                pad = [0, 0] * (row.ndim - ax_seq - 1) + [0, extra]
                row = torch.nn.functional.pad(row, pad)
            packed = pack_leaf(row, name)  # lead (..., 1) with the slot axis last
            idx = _slot_index(name, leaf) + (slot,)
            leaf.values[idx] = packed.values[..., 0, :]
            leaf.mask.view(torch.int32)[idx] = packed.mask.view(torch.int32)[..., 0, :]
            leaf.nnz[idx] = packed.nnz[..., 0]
    return pool


def release_packed(pool: dict, slot: int) -> dict:
    """Zero one slot's blocks (position, occupancy, values) so a retired
    request stops counting toward density and wire accounting."""
    pool["pos"][slot] = 0
    for unit in _units(pool):
        for name, leaf in pool[unit].items():
            idx = _slot_index(name, leaf) + (slot,)
            leaf.values[idx] = 0
            leaf.mask.view(torch.int32)[idx] = 0
            leaf.nnz[idx] = 0
    return pool


def merge_active(new_cache: dict, old_cache: dict, active: torch.Tensor) -> dict:
    """Keep the decode step's updates only for active slots (idle slots must
    not advance position or accrete garbage KV)."""
    out = {"pos": torch.where(active, new_cache["pos"], old_cache["pos"])}
    for unit in _units(new_cache):
        out[unit] = {}
        for name, new in new_cache[unit].items():
            shape = [1] * new.ndim
            shape[new.ndim + PACKED_SEQ_AXIS[name] - 1] = active.shape[0]
            out[unit][name] = torch.where(active.reshape(shape), new, old_cache[unit][name])
    return out


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
