"""Block table: (request, block-range) -> page frames, with chain-hash
prefix sharing and copy-on-write (port of
``repro/serving/paging/blocktable.py``).

One *logical block* covers ``page_tokens`` consecutive cache rows across
**every** paged leaf of every layer (DESIGN.md §12) — a single frame id
per block keeps the table one ``(n_slots, max_blocks)`` int32 array on
the device side, and prefix reuse naturally shares all layers at once
(position ``i``'s KV depends only on tokens ``<= i``, per layer).

Prefix sharing is a weak chain-hash index over *pure* blocks: a block is
registered under the hash chain of every prompt token it covers, so two
prompts sharing a prefix hit the same chain keys.  The final partial
block is keyed by the full prompt (content + fill count), so identical
prompts share even their partial tail and fork lazily on first decode
write.  Hash chains are tuples of ints — python hashes those
deterministically (no PYTHONHASHSEED dependence).

COW protocol: before any in-place write to block ``b`` of request ``r``,
call :meth:`ensure_writable`.  A frame with refcount > 1 is copied-on-
write (the caller rewrites the whole block from its assembled dense
cache, so "copy" is implicit in the full-page write-back); a frame with
refcount 1 is written in place, which *invalidates* its index entry —
its content no longer matches the registered hash.  Either way the
returned frame has refcount 1 and is referenced by no other request:
COW never aliases a written page.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.serving.paging.allocator import PageAllocator, PageError


def chain_keys(tokens, page_tokens: int, n_fill: int) -> list[tuple]:
    """Index keys for the blocks covering ``n_fill`` prompt rows: one
    ``("full", chain_hash)`` per complete block, plus one
    ``("partial", chain_hash, fill)`` for a trailing partial block."""
    toks = tuple(int(t) for t in tokens)
    keys: list[tuple] = []
    h = 0
    n_blocks = (n_fill + page_tokens - 1) // page_tokens
    for b in range(n_blocks):
        lo, hi = b * page_tokens, min((b + 1) * page_tokens, n_fill)
        h = hash((h, toks[lo:hi]))
        keys.append(("full", h) if hi - lo == page_tokens
                    else ("partial", h, hi - lo))
    return keys


class BlockTable:
    """Per-request frame lists over one shared :class:`PageAllocator`."""

    def __init__(self, allocator: PageAllocator, page_tokens: int,
                 prefix_cache: bool = True):
        if page_tokens < 1:
            raise PageError(f"page_tokens must be >= 1, got {page_tokens}")
        self.allocator = allocator
        self.page_tokens = page_tokens
        self.prefix_cache = prefix_cache
        self.blocks: dict[int, list[int]] = {}  # rid -> frames, block order
        self._index: dict[tuple, int] = {}      # chain key -> pure frame
        self._frame_key: dict[int, tuple] = {}  # inverse (weak: dies w/ frame)
        # counters surfaced as telemetry
        self.prefix_hits = 0
        self.cow_copies = 0

    # -- state views --------------------------------------------------------

    def frames_of(self, rid: int) -> list[int]:
        return list(self.blocks[rid])

    def n_blocks(self, rid: int) -> int:
        return len(self.blocks[rid])

    def shared_frames(self) -> set:
        """Frames referenced by more than one request."""
        return {f for frames in self.blocks.values() for f in frames
                if self.allocator.refcount(f) > 1}

    def check_invariants(self) -> None:
        refs: dict[int, int] = {}
        for frames in self.blocks.values():
            for f in frames:
                refs[f] = refs.get(f, 0) + 1
        for f, n in refs.items():
            assert self.allocator.refcount(f) == n, (
                f"frame {f}: allocator refcount {self.allocator.refcount(f)} "
                f"!= {n} table references")
        assert set(refs) == set(self.allocator.allocated_frames()), (
            "allocator/table frame sets diverged")
        for key, f in self._index.items():
            assert self._frame_key.get(f) == key, "index/inverse diverged"
            assert self.allocator.refcount(f) >= 1, "index holds freed frame"

    # -- request lifecycle --------------------------------------------------

    def open(self, rid: int) -> None:
        if rid in self.blocks:
            raise PageError(f"request {rid} already has a block table")
        self.blocks[rid] = []

    def plan_prompt(self, tokens, n_fill: int) -> list[Optional[int]]:
        """Sharing plan for a prompt covering ``n_fill`` rows: per block,
        the pure frame to adopt (prefix-cache hit) or None (must install).
        Read-only — admission gating calls this before committing."""
        keys = chain_keys(tokens, self.page_tokens, n_fill)
        if not self.prefix_cache:
            return [None] * len(keys)
        return [self._index.get(k) for k in keys]

    def append_block(self, rid: int, key: Optional[tuple] = None) -> int:
        """Allocate a fresh frame as the next block of ``rid``; register
        it under ``key`` (a pure prompt block) when prefix caching."""
        frame = self.allocator.alloc()
        self.blocks[rid].append(frame)
        if key is not None and self.prefix_cache and key not in self._index:
            self._index[key] = frame
            self._frame_key[frame] = key
        return frame

    def register(self, frame: int, key: tuple) -> None:
        """Index a frame whose *content* now matches ``key`` — called when
        the block's page bits are actually written (registering at
        allocation time would let another request adopt a frame whose
        install is still pending)."""
        if (self.prefix_cache and key not in self._index
                and frame not in self._frame_key):
            self._index[key] = frame
            self._frame_key[frame] = key

    def adopt_block(self, rid: int, frame: int) -> int:
        """Share an existing pure frame as the next block of ``rid``."""
        self.allocator.incref(frame)
        self.blocks[rid].append(frame)
        self.prefix_hits += 1
        return frame

    def ensure_writable(self, rid: int, block_idx: int) -> tuple[int, bool]:
        """Return ``(frame, cow)`` such that writing the whole block into
        ``frame`` is safe: no other request references it, and no stale
        index entry claims its content."""
        frames = self.blocks[rid]
        old = frames[block_idx]
        if self.allocator.refcount(old) > 1:
            new = self.allocator.alloc()  # caller rewrites the full page
            self.allocator.decref(old)
            frames[block_idx] = new
            self.cow_copies += 1
            return new, True
        self._invalidate(old)  # in-place write: content diverges from hash
        return old, False

    def grow(self, rid: int) -> int:
        """Append one fresh (private, unregistered) block — decode spilled
        past the last allocated block."""
        frame = self.allocator.alloc()
        self.blocks[rid].append(frame)
        return frame

    def truncate(self, rid: int, n_blocks: int) -> None:
        """Drop blocks past ``n_blocks`` (rollback for a partially-grown
        request that is being preempted before its write landed)."""
        while len(self.blocks[rid]) > n_blocks:
            f = self.blocks[rid].pop()
            if self.allocator.decref(f) == 0:
                self._invalidate(f)

    def release(self, rid: int) -> list[int]:
        """Drop every block of ``rid``; returns the frames that became
        free.  Double release raises :class:`PageError`."""
        if rid not in self.blocks:
            raise PageError(f"double free: request {rid} has no block table "
                            f"(already released?)")
        freed = []
        for f in self.blocks.pop(rid):
            if self.allocator.decref(f) == 0:
                self._invalidate(f)
                freed.append(f)
        return freed

    def _invalidate(self, frame: int) -> None:
        key = self._frame_key.pop(frame, None)
        if key is not None:
            self._index.pop(key, None)
