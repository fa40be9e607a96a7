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
import fnmatch
from typing import Optional

STASH_POLICIES = ("none", "remat", "stash")


@dataclasses.dataclass(frozen=True)
class MemstashConfig:
    """Per-stash-point checkpoint policy.

    policy:     default policy for every stash point.
    per_layer:  ``((fnmatch_pattern, policy), ...)`` overrides matched
                against the stash-point name (``"lm/residual"``, a CNN
                layer's name); first match wins.
    value_bits: bits per stored non-zero in the wire accounting (the
                paper's Q4.16 value is 20; the traffic formula is
                ``bits/elem = value_bits * density + 1``).
    capacity:   fraction of the dense length allocated for the collapsed
                value buffer.  1.0 is always bit-exact; < 1.0 trades
                exactness above that density for a genuinely smaller
                saved buffer (overflow values decode as zero and are
                counted by ``StashedActivation.overflow``).
    min_elems:  stash points smaller than this fall back to "none" — the
                mask word + metadata overhead isn't worth it.
    """

    policy: str = "none"
    per_layer: tuple = ()
    value_bits: int = 20
    capacity: float = 1.0
    min_elems: int = 1024

    def __post_init__(self):
        if self.policy not in STASH_POLICIES:
            raise ValueError(f"policy {self.policy!r} not in {STASH_POLICIES}")
        for pat, pol in self.per_layer:
            if pol not in STASH_POLICIES:
                raise ValueError(f"per_layer[{pat!r}] policy {pol!r} not in {STASH_POLICIES}")
        if not 0.0 < self.capacity <= 1.0:
            raise ValueError(f"capacity must be in (0, 1], got {self.capacity}")

    def policy_for(self, name: str, elems: Optional[int] = None) -> str:
        pol = self.policy
        for pat, p in self.per_layer:
            if fnmatch.fnmatchcase(name, pat):
                pol = p
                break
        if pol != "none" and elems is not None and elems < self.min_elems:
            return "none"
        return pol


# Convenience presets: CNN ReLU activations are genuinely sparse (the
# paper's ~50% claim) so compressed stashing pays; LM residual streams are
# dense, where remat is the sane default and "stash" degrades gracefully
# to ~dense bytes + 1 mask bit/elem (measurable via the instrumentation).
STASH_ALL = MemstashConfig(policy="stash")
REMAT_ALL = MemstashConfig(policy="remat")
