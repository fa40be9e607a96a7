"""spring-survive: elastic serving under failure and overload (port of
``repro/serving/elastic``).

Snapshot/restore (exact packed-bits engine state, versioned and
spec-hash-stamped), live slot rescaling, and the chaos harness that seals
them against the uninterrupted oracle (the reference's DESIGN.md §13).
"""

from repro_torch.serving.elastic.chaos import ChaosEvent, ChaosHarness
from repro_torch.serving.elastic.snapshot import (
    SNAPSHOT_VERSION,
    SnapshotError,
    apply_snapshot,
    build_snapshot,
    check_compatible,
    load_snapshot,
    save_snapshot,
)

__all__ = [
    "SNAPSHOT_VERSION",
    "SnapshotError",
    "ChaosEvent",
    "ChaosHarness",
    "apply_snapshot",
    "build_snapshot",
    "check_compatible",
    "load_snapshot",
    "save_snapshot",
]
