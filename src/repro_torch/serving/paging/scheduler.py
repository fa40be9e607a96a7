"""Page-aware scheduler: FCFS admission gated by page feasibility, plus
the preempt/resume lifecycle the spill path needs (port of
``repro/serving/paging/scheduler.py``).

The machinery (gated admission with strict head-of-line blocking,
preemption into a resume queue, subset token recording) moved into the
base :class:`repro_torch.serving.scheduler.SlotScheduler` when spring-survive
made it load-bearing for *both* backends (monolithic rescale/restore
spills too — DESIGN.md §13).  This subclass survives as the historical
name plus the ``admit_paged`` spelling the paged engine/tests use.
"""

from __future__ import annotations

from repro_torch.serving.scheduler import (  # noqa: F401  (re-export)
    RequestTracker,
    ShedPolicy,
    SlotScheduler,
    SpilledRequest,
)


class PagedScheduler(SlotScheduler):
    """FCFS over slots *and* pages; preempted requests resume first."""

    #: historical spelling of the gated admission entry point
    admit_paged = SlotScheduler.admit_gated
