"""Memstash policy configuration (port of ``repro/memstash/config.py``;
see DESIGN.md §4.3).

A ``MemstashConfig`` decides, per stash point, what happens to the forward
activation that the backward pass will need:

  none   — leave it to autograd (dense residual, the fp32/bf16 baseline);
  remat  — ``torch.utils.checkpoint``: store nothing, recompute in backward;
  stash  — store it in SPRING's binary-mask compressed form (packed
           occupancy bits + front-collapsed non-zeros) and decompress it in
           the backward pass; the block is then recomputed from the
           restored input (remat-from-compressed-input).

The config is a frozen dataclass, hashable as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

STASH_POLICIES = ("none", "remat", "stash")


@dataclasses.dataclass(frozen=True)
class MemstashConfig:
    """Checkpoint policy of every stash point.

    policy:     the policy for every stash point.
    min_elems:  stash points smaller than this fall back to "none" — the
                mask word + metadata overhead isn't worth it.

    The reference's per-layer overrides, value-bit width and lossy
    capacity have no caller in the port; the wire accounting uses the
    Q4.16 value width, :data:`repro_torch.memstash.format.VALUE_BITS`.
    """

    policy: str = "none"
    min_elems: int = 1024

    def __post_init__(self):
        if self.policy not in STASH_POLICIES:
            raise ValueError(f"policy {self.policy!r} not in {STASH_POLICIES}")

    def policy_for(self, elems: Optional[int] = None) -> str:
        if self.policy != "none" and elems is not None and elems < self.min_elems:
            return "none"
        return self.policy


# Convenience presets: CNN ReLU activations are genuinely sparse (the
# paper's ~50% claim) so compressed stashing pays; LM residual streams are
# dense, where remat is the sane default and "stash" degrades gracefully
# to ~dense bytes + 1 mask bit/elem (measurable via the instrumentation).
STASH_ALL = MemstashConfig(policy="stash")
REMAT_ALL = MemstashConfig(policy="remat")
