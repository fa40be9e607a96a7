"""Packed page store: the device-side half of spring-pages (port of
``repro/serving/paging/store.py``).

Every *pageable* cache leaf (the attention ``k``/``v``: token-indexed
content whose row ``i`` depends only on tokens ``<= i``) is stored as
fixed-size pages of ``page_tokens`` consecutive cache rows, each page
binary-mask packed on its own with ``kv_pack``:

  values  (*lead, n_frames, elems)   leaf dtype, nonzeros front-packed
  mask    (*lead, n_frames, words)   uint32 occupancy bits
  nnz     (*lead, n_frames)          int32

One logical frame id addresses the same page slot across all leaves and
layers, so the whole mapping is one ``(n_slots, max_blocks)`` frame
table.  Everything else (SSM and RG-LRU state, window rings, the
per-slot ``pos`` vector) is *slot state*: a dense slot-indexed tree in which the
paged leaves are ``None`` holes (``strip``; ``assemble`` fills them back
in).  MLA's ``ckv`` / ``krope`` (seq axis -2) are paged like k/v, under
``unit_*`` (layers stacked in front) and under deepseek's ``prefix_0``.

The decode tick is gather -> compute -> scatter, without the
reference's per-slot ``vmap``:

  * ``assemble``: one ``index_select`` of every leaf's frames by the
    flattened frame table and one ``kv_unpack`` of the result, cut to
    the working length the engine asks for (its ``max_len``: the rows a
    request can reach, so the decode's reductions have the monolithic
    pool's shape; the rows past it are zero in every page);
  * ``writeback``: the one page each slot's decode can touch, gathered
    from every slot into rows, packed by one ``kv_pack`` call per leaf
    (each row packs alone, so the bits are the reference's per-slot
    pack's), then ``index_copy_`` into the slots' frames.

Frame 0 (the null page) supplies the zero tail.  Writes go in place; what
must outlive the next write (a spilled frame) is copied to the host.
Mask words move through their int32 view (``kvpool.word_view``): torch
gathers and copies no uint32 tensor.
"""

from __future__ import annotations

import dataclasses
import math
import torch

from repro_torch.core.masking import MASK_WORD_BITS, _n_words
from repro_torch.kernels.kv_cache.ops import KV_VALUE_BITS, kv_pack, kv_unpack
from repro_torch.serving.kvpool import (PACKED_SEQ_AXIS, as_tensor, host_copy, lookup,
                                        pool_leaves, repack, word_view)

#: cache leaf kinds stored paged: token-indexed content (attention k/v and
#: MLA's latent and rope key).  Window rings are
#: fixed-size per-slot windows and stay slot state, like the O(1)
#: SSM / RG-LRU leaves (the reference's ``store.py:44-47``)
PAGED_LEAVES = ("k", "v", "ckv", "krope")

_PARTS = ("values", "mask", "nnz")


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Static layout of one paged cache leaf."""

    key: str          # stable id, path keys joined with "/"
    keys: tuple       # raw path keys into the cache tree
    dtype: torch.dtype
    lead: tuple       # dims before the slot axis (the stacked layers)
    tail: tuple       # dims after the seq axis (heads, head_dim)
    elems: int        # page_tokens * prod(tail): packed block length
    words: int        # mask words per page

    @property
    def lead_n(self) -> int:
        return len(self.lead)

    @property
    def lead_prod(self) -> int:
        return int(math.prod(self.lead)) if self.lead else 1


def _set(tree, keys, value) -> None:
    node = tree
    for k in keys[:-1]:
        node = node[k]
    node[keys[-1]] = value


def _clone(tree):
    """Structure-deep copy (dicts), leaves by reference, so ``_set`` on
    the clone never alters the input tree."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree


def _leaf_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def prompt_rows(cfg, prompt_len: int) -> int:
    """Cache rows a prefill fills: the prompt plus any VLM image prefix."""
    return prompt_len + (getattr(cfg, "vlm_prefix_len", 0) or 0)


class PagedKVStore:
    """Layout and in-place programs over the packed page arrays.

    ``rows`` is the working cache's length: the engine's ``max_len``,
    which no request's rows exceed (at most ``max_blocks * page_tokens``).
    Under a ``heads`` split (``runtime.tree_sharding.KVHeadSplit``, built
    in the engine's tensor-parallel context) every frame holds this rank's
    kv heads, and the page unit, the live nonzeros and so the wire figures
    are the whole pool's, summed over ``model``: the admission, spill and
    resume decisions read them, and every rank must take the same ones."""

    def __init__(self, cfg, n_slots: int, page_tokens: int, max_blocks: int,
                 n_frames: int, dtype=torch.bfloat16, *, rows: int, device=None,
                 heads=None):
        from repro_torch.models.lm import lm_init_cache

        self.cfg = cfg
        self.n_slots = n_slots
        self.page_tokens = page_tokens
        self.max_blocks = max_blocks
        self.n_frames = n_frames
        self.tokens_cap = max_blocks * page_tokens  # pages' rows per slot
        self.rows = int(rows)
        if not 0 < self.rows <= self.tokens_cap:
            raise ValueError(f"rows {self.rows} outside (0, {self.tokens_cap}]")
        self.dtype = dtype
        self.device = torch.device("cpu" if device is None else device)
        self.heads = heads

        template = lm_init_cache(cfg, n_slots, self.tokens_cap, dtype, device="meta")
        self.leaves: dict[str, LeafSpec] = {}
        for keys, leaf in _leaf_paths(template):
            name = str(keys[-1])
            if name not in PAGED_LEAVES:
                continue
            slot_ax = 1 if str(keys[0]).startswith("unit_") else 0
            seq_ax = leaf.ndim + PACKED_SEQ_AXIS[name]
            assert seq_ax == slot_ax + 1, (keys, leaf.shape)
            tail = tuple(leaf.shape[seq_ax + 1:])
            elems = page_tokens * int(math.prod(tail))
            spec = LeafSpec(key="/".join(str(k) for k in keys), keys=keys, dtype=leaf.dtype,
                            lead=tuple(leaf.shape[:slot_ax]), tail=tail, elems=elems,
                            words=_n_words(elems))
            self.leaves[spec.key] = spec
        if not self.leaves:
            # recurrentgemma: rings and RG-LRU state only (the reference
            # refuses it too, store.py:141)
            raise ValueError(f"{cfg.name}: no pageable cache leaves (the paged pool "
                             f"stores {PAGED_LEAVES}; window rings and recurrent state "
                             f"stay slot state), so it cannot be served paged")

        #: dense elems / stored mask bits of one logical page, summed over
        #: every paged leaf: the admission controller's page unit
        self.page_elems = sum(s.lead_prod * s.elems for s in self.leaves.values())
        self.page_mask_bits = sum(s.lead_prod * s.words * MASK_WORD_BITS
                                  for s in self.leaves.values())
        if heads is not None:
            self.page_elems, self.page_mask_bits = heads.total(
                [self.page_elems, self.page_mask_bits])
        self.page_dense_fp32_bytes = self.page_elems * 4.0

    # -- array construction --------------------------------------------------

    def init_arrays(self) -> dict:
        """All-zero page arrays (frame 0 stays all-zero forever: the null
        page that unallocated table entries gather)."""
        out = {}
        for key, s in self.leaves.items():
            z = dict(device=self.device)
            out[key] = {
                "values": torch.zeros((*s.lead, self.n_frames, s.elems), dtype=s.dtype, **z),
                "mask": torch.zeros((*s.lead, self.n_frames, s.words), dtype=torch.int32,
                                    **z).view(torch.uint32),
                "nnz": torch.zeros((*s.lead, self.n_frames), dtype=torch.int32, **z),
            }
        return out

    def init_state(self) -> dict:
        """Dense slot-state tree: the full cache with paged leaves
        stripped to ``None`` holes and a per-slot position vector."""
        from repro_torch.models.lm import lm_init_cache

        state = self.strip(lm_init_cache(self.cfg, self.n_slots, 1, self.dtype,
                                         device=self.device))
        state["pos"] = torch.zeros((self.n_slots,), dtype=torch.int64, device=self.device)
        return state

    def strip(self, cache: dict) -> dict:
        """Replace every paged leaf with ``None``."""
        out = _clone(cache)
        for s in self.leaves.values():
            _set(out, s.keys, None)
        return out

    def shapes(self, n_slots: int, n_frames: int) -> tuple:
        """The shapes of the page arrays' and the slot state's leaves, in
        the reference's order (dict keys sorted), at another geometry:
        what a snapshot of that geometry must hold."""
        from repro_torch.models.lm import lm_init_cache

        arrays = [shape for _, s in sorted(self.leaves.items())
                  for shape in ((*s.lead, n_frames, s.words), (*s.lead, n_frames),
                                (*s.lead, n_frames, s.elems))]  # mask, nnz, values
        state = self.strip(lm_init_cache(self.cfg, n_slots, 1, self.dtype, device="meta"))
        state["pos"] = torch.empty((n_slots,), device="meta")
        return arrays, [tuple(t.shape) for t in pool_leaves(state)]

    # -- gather: pages -> dense working cache --------------------------------

    def assemble(self, store: dict, state: dict, table: torch.Tensor) -> dict:
        """The dense cache tree the decode step takes: every slot's frames
        (``table``: (n_slots, max_blocks) int64 on the device) gathered
        by one ``index_select`` a leaf, unpacked by one ``kv_unpack``, and
        cut to ``rows``.  Unallocated blocks gather frame 0 (exact zeros,
        the tail a monolithic pool slot carries)."""
        cache = _clone(state)
        flat = table.reshape(-1)
        for key, s in self.leaves.items():
            g_v = store[key]["values"].index_select(s.lead_n, flat)
            g_m = word_view(store[key]["mask"]).index_select(s.lead_n, flat)
            dense = kv_unpack(g_v, g_m.view(torch.uint32), s.elems)
            dense = dense.reshape(*s.lead, self.n_slots, self.tokens_cap, *s.tail)
            _set(cache, s.keys, dense.narrow(s.lead_n + 1, 0, self.rows).contiguous())
        return cache

    # -- scatter: pages of rows back into frames -----------------------------

    def _page_rows(self, dense: torch.Tensor, s: LeafSpec, slot: torch.Tensor,
                   block: torch.Tensor) -> torch.Tensor:
        """(*lead, n, elems): for each i, the ``page_tokens`` rows of
        block ``block[i]`` of slot ``slot[i]`` of ``dense`` ((*lead, S,
        rows, *tail)); rows at or past the leaf's length read as zero."""
        length = dense.shape[s.lead_n + 1]
        tok = block[:, None] * self.page_tokens + torch.arange(
            self.page_tokens, device=dense.device)
        lead = (slice(None),) * s.lead_n
        rows = dense[lead + (slot[:, None], tok.clamp(max=length - 1))]
        valid = (tok < length).reshape((1,) * s.lead_n + tuple(tok.shape)
                                       + (1,) * len(s.tail))
        rows = torch.where(valid, rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
        return rows.reshape(*s.lead, tok.shape[0], s.elems)

    def _store_pages(self, arrays: dict, pages: torch.Tensor, s: LeafSpec,
                     frames: torch.Tensor) -> None:
        """Pack (*lead, n, elems) page rows with one ``kv_pack`` call and
        copy each into its frame (``frames``: (n,) int64)."""
        packed = kv_pack(pages)
        arrays["values"].index_copy_(s.lead_n, frames, packed["values"].to(s.dtype))
        word_view(arrays["mask"]).index_copy_(s.lead_n, frames, word_view(packed["mask"]))
        arrays["nnz"].index_copy_(s.lead_n, frames, packed["nnz"].to(torch.int32))

    def writeback(self, store: dict, cache: dict, write_frame, write_block) -> dict:
        """In place: per slot, re-pack the one page its decode step wrote
        (block ``write_block[slot]`` into frame ``write_frame[slot]``),
        all slots of a leaf in one ``kv_pack`` call.  The engine routes
        inactive slots' frames to the scratch sink, so their garbage never
        lands in a live frame."""
        dev = self.device
        frames = torch.as_tensor(write_frame, dtype=torch.int64).to(dev)
        block = torch.as_tensor(write_block, dtype=torch.int64).to(dev)
        slots = torch.arange(self.n_slots, device=dev)
        for key, s in self.leaves.items():
            self._store_pages(store[key], self._page_rows(lookup(cache, s.keys), s, slots, block),
                              s, frames)
        return store

    # -- chunked prefill install ---------------------------------------------

    def pad_prefill(self, pcache: dict) -> dict:
        """A batch-1 prefill cache's paged leaves, ``{leaf key: dense
        leaf}``: the only part of it the chunked page installer keeps."""
        out = {}
        for key, s in self.leaves.items():
            leaf = lookup(pcache, s.keys)
            n = leaf.shape[s.lead_n + 1]
            if n > self.tokens_cap:
                raise ValueError(f"{key}: prefill length {n} exceeds page capacity "
                                 f"{self.tokens_cap}")
            out[key] = leaf.to(s.dtype)
        return out

    def install_blocks(self, store: dict, pcache_pages: dict, blocks: list,
                       frames: list) -> dict:
        """In place: write prompt blocks ``blocks`` (all leaves) of a
        :meth:`pad_prefill` output into ``frames``, one ``kv_pack`` call a
        leaf for all of them: the unit of chunked prefill."""
        dev = self.device
        block = torch.as_tensor(blocks, dtype=torch.int64).to(dev)
        frame = torch.as_tensor(frames, dtype=torch.int64).to(dev)
        zeros = torch.zeros_like(block)
        for key, s in self.leaves.items():
            self._store_pages(store[key], self._page_rows(pcache_pages[key], s, zeros, block),
                              s, frame)
        return store

    # -- spill / resume -------------------------------------------------------

    def extract_frames(self, store: dict, frames: list) -> list:
        """The exact packed bits of ``frames``, as host copies: one
        ``{leaf key: {"values", "mask", "nnz"}}`` dict per frame (for
        host-side spill storage); one gather and one copy a part."""
        idx = torch.as_tensor(frames, dtype=torch.int64).to(self.device)
        out = [{} for _ in frames]
        for key, s in self.leaves.items():
            for part in _PARTS:
                host = host_copy(word_view(store[key][part]).index_select(s.lead_n, idx)
                                 ).view(store[key][part].dtype)
                for i, row in enumerate(host.unbind(s.lead_n)):
                    out[i].setdefault(key, {})[part] = row
        return out

    def restore_frames(self, store: dict, payloads: list, frames: list) -> dict:
        """In place, the inverse of :meth:`extract_frames`: bit-exact resume
        of each payload (host tensors or numpy arrays) into its frame."""
        if not frames:
            return store
        idx = torch.as_tensor(frames, dtype=torch.int64).to(self.device)
        for key, s in self.leaves.items():
            for part in _PARTS:
                dst = word_view(store[key][part])
                rows = torch.stack([word_view(as_tensor(p[key][part])).view(dst.dtype)
                                    .reshape(dst.shape[:s.lead_n] + dst.shape[s.lead_n + 1:])
                                    for p in payloads], dim=s.lead_n)
                dst.index_copy_(s.lead_n, idx, rows.to(self.device))
        return store

    # -- wire accounting ------------------------------------------------------

    def live_nnz(self, store: dict, frames: list) -> float:
        """Total nonzeros across ``frames``, exact (int64): the one device
        read behind the per-tick density and wire stats; the whole pool's
        under a kv-head split (:meth:`total`)."""
        nnz = 0
        if frames:
            idx = torch.as_tensor(frames, dtype=torch.int64).to(self.device)
            parts = [store[key]["nnz"].index_select(s.lead_n, idx).sum(dtype=torch.int64)
                     for key, s in self.leaves.items()]
            nnz = int(torch.stack(parts).sum())
        return self.total(nnz)

    def total(self, nnz: int) -> float:
        """A nonzero count of this store's frames as the whole pool's: summed
        over ``model`` under a kv-head split (every rank joins), else as it
        is."""
        return nnz if self.heads is None else self.heads.total([nnz])[0]

    def map_heads(self, arrays: dict, fn) -> dict:
        """Page arrays (or a stack of spilled frames: ``{leaf key:
        {"values", "mask", "nnz"}}``, any lead dims) in another head layout:
        each leaf's pages unpacked, mapped by ``fn`` (a ``KVHeadSplit``'s
        ``whole`` or ``local``, kv heads at dim -2) and packed again."""
        out = {}
        for key, s in self.leaves.items():
            values = as_tensor(arrays[key]["values"])
            d = s.tail[-1]
            shape = (*values.shape[:-1], self.page_tokens,
                     values.shape[-1] // (self.page_tokens * d), d)
            r = repack(values, as_tensor(arrays[key]["mask"]), shape, fn)
            out[key] = {part: r[part] for part in _PARTS}
        return out

    def wire_stats(self, nnz_total: float, n_allocated: int, num_pages: int,
                   value_bits: int = KV_VALUE_BITS) -> dict:
        """Same surface as ``kvpool.pool_wire_stats`` computed over
        allocated frames, with the dense-fp32 baseline taken at the
        *physical* budget (``num_pages`` dense pages: what a dense
        allocator would keep resident)."""
        elems = n_allocated * self.page_elems
        mask_bits = n_allocated * self.page_mask_bits
        wire_bits = nnz_total * value_bits + mask_bits
        wire_bytes = wire_bits / 8.0
        dense_fp32 = num_pages * self.page_dense_fp32_bytes
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return {
            "kv_elems": float(elems),
            "kv_nnz": float(nnz_total),
            "kv_density": nnz_total / elems if elems else 0.0,
            "kv_wire_bytes": wire_bytes,
            "kv_logical_bytes": float(n_allocated * self.page_elems * itemsize),
            "kv_dense_fp32_bytes": dense_fp32,
            "kv_compression_vs_fp32": dense_fp32 / wire_bytes if wire_bytes else 0.0,
        }
