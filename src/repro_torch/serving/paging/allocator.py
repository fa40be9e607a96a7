"""Free-list page-frame allocator with per-frame refcounts (port of
``repro/serving/paging/allocator.py``).

Pure python on purpose (like the scheduler): the hypothesis property
suite (tests/test_torch_paging.py) drives thousands of alloc/share/release
streams against the invariants —

  * conservation: ``n_free + n_allocated == capacity`` always;
  * no leaks: refcounts hit zero exactly at release, and a frame whose
    refcount reaches zero is immediately reusable;
  * no double-free: ``decref`` on a free frame raises :class:`PageError`
    instead of silently corrupting the free list;

— while the engine drives the same object per tick.

Two frame ids below :data:`PageAllocator.RESERVED` never enter the free
list:

  frame 0  the permanent *null page* (all-zero packed content).  Block
           table entries beyond a request's allocated blocks point here,
           so a gather of the full (slot, max_blocks) frame table
           reconstructs exactly the zero tail a monolithic pool slot
           carries.
  frame 1  the *scratch sink*: inactive slots' decode write-back lands
           here.  Never referenced by any block table and excluded from
           wire accounting, so garbage writes are invisible.
"""

from __future__ import annotations

import bisect


class PageError(ValueError):
    """Page accounting violation (double free, unknown frame, exhaustion)."""


class PageAllocator:
    """Fixed pool of page frames; lowest-free-first allocation so the
    engine's frame choices are deterministic for a given request stream."""

    #: frames below this id are the null page / scratch sink (see module doc)
    RESERVED = 2

    def __init__(self, capacity: int):
        if capacity <= 0:
            raise PageError(f"page capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._free: list[int] = list(range(self.RESERVED,
                                           self.RESERVED + capacity))
        self._ref: dict[int, int] = {}

    # -- state views --------------------------------------------------------

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_allocated(self) -> int:
        return len(self._ref)

    def allocated_frames(self) -> list[int]:
        return sorted(self._ref)

    def refcount(self, frame: int) -> int:
        return self._ref.get(frame, 0)

    def check_invariants(self) -> None:
        assert self.n_free + self.n_allocated == self.capacity, (
            f"frame leak: {self.n_free} free + {self.n_allocated} allocated "
            f"!= {self.capacity}")
        assert set(self._free).isdisjoint(self._ref), "frame double-booked"
        assert all(r >= 1 for r in self._ref.values()), "zombie refcount"

    # -- lifecycle ----------------------------------------------------------

    def alloc(self) -> int:
        """Claim the lowest free frame with refcount 1."""
        if not self._free:
            raise PageError(f"out of pages: all {self.capacity} frames live")
        frame = self._free.pop(0)
        self._ref[frame] = 1
        return frame

    def try_alloc(self):
        """``alloc`` that returns None instead of raising on exhaustion."""
        return self.alloc() if self._free else None

    def incref(self, frame: int) -> int:
        if frame not in self._ref:
            raise PageError(f"incref on unallocated frame {frame}")
        self._ref[frame] += 1
        return self._ref[frame]

    def decref(self, frame: int) -> int:
        """Drop one reference; at zero the frame returns to the free list.
        Returns the remaining refcount (0 = freed)."""
        if frame not in self._ref:
            raise PageError(
                f"double free: frame {frame} is not allocated (released "
                f"twice, or never allocated)")
        self._ref[frame] -= 1
        if self._ref[frame] == 0:
            del self._ref[frame]
            bisect.insort(self._free, frame)
            return 0
        return self._ref[frame]
