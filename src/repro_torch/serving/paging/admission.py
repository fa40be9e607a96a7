"""Density-aware admission control: overcommit logical pages against
measured packed bits (port of ``repro/serving/paging/admission.py``).

The physical budget is ``num_pages`` *dense* pages of SPRING wire
storage — exactly what a dense allocator would hand the pool.  A packed
page at density ``d`` costs ``20*d + 1`` bits/elem (values at the 20-bit
storage width + 1 occupancy bit, the memstash/kvpool formula), so the
same physical bytes hold ``~ (20 + 1) / (20*d + 1)`` packed pages: at
the natural half-full occupancy of a rolling decode pool that is ~2x
the dense page count.  Admission projects a candidate's page cost at the
pool's *measured* density (conservative 1.0 while the pool is empty) and
admits while the projection fits the budget; the logical frame pool is
capped at ``ceil(num_pages * overcommit)`` so the block tables stay
bounded however sparse the traffic.

When density spikes (pages fill in, projections go stale), live bits can
exceed the budget: the engine's defined spill path preempts the most
recently admitted requests — their exact packed bits move to host memory
— until the pool fits again.  `tests/test_torch_paging.py` seals that after a
spill the resident set never exceeds the physical budget, and that
spilled requests resume bit-identically.
"""

from __future__ import annotations

from repro_torch.core.masking import MASK_WORD_BITS
from repro_torch.kernels.kv_cache.ops import KV_VALUE_BITS


class AdmissionController:
    """Byte-budget arithmetic; pure, stateless between calls."""

    def __init__(self, page_elems: int, page_mask_bits: int, num_pages: int,
                 value_bits: int = KV_VALUE_BITS):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        self.page_elems = page_elems          # dense elems per page, all leaves
        self.page_mask_bits = page_mask_bits  # stored mask words per page
        self.num_pages = num_pages
        self.value_bits = value_bits
        #: the physical allocation: num_pages fully-dense packed pages
        self.budget_bits = num_pages * self.page_bits(1.0)

    def page_bits(self, density: float) -> float:
        """Wire bits of one packed page at ``density`` (20*d + 1 form:
        values at the storage width + the mask words actually stored)."""
        return self.page_elems * self.value_bits * density + self.page_mask_bits

    def projected_bits(self, live_bits: float, n_new_pages: int,
                       density: float) -> float:
        return live_bits + n_new_pages * self.page_bits(density)

    def admits(self, live_bits: float, n_new_pages: int,
               density: float) -> bool:
        """Admit iff the candidate's pages, costed at the measured pool
        density, still fit the physical budget."""
        return (self.projected_bits(live_bits, n_new_pages, density)
                <= self.budget_bits)

    def admits_exact(self, live_bits: float, exact_bits: float) -> bool:
        """Resume-path gate: a spilled request's packed bits are known
        exactly, no density projection needed."""
        return live_bits + exact_bits <= self.budget_bits

    def over_budget(self, live_bits: float) -> bool:
        return live_bits > self.budget_bits

    def utilization(self, live_bits: float) -> float:
        return live_bits / self.budget_bits if self.budget_bits else 0.0


def mask_word_bits(n_words: int) -> int:
    return n_words * MASK_WORD_BITS
