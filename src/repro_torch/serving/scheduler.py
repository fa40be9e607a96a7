"""FCFS slot admission + request lifecycle, with elastic extensions.

A copy of ``repro/serving/scheduler.py`` (pure Python; the port imports
nothing from ``repro``).  The port's engine uses the FCFS core; the
shedding and preemption paths come along unused until they are ported.

Model-agnostic on purpose: the scheduler never touches jax, so the
hypothesis property suites (tests/test_serving_scheduler.py,
tests/test_elastic.py) can drive thousands of arrival/length streams
against the invariants —

  * no slot leaks: every admitted request returns its slot on retirement,
    and ``len(active) + len(free) == n_slots`` at every tick;
  * no starvation: admission order is exactly submission order (FCFS) —
    unless a :class:`ShedPolicy` explicitly reorders by priority/deadline;
  * exact completion: a request retires with ``min(steps-to-eos,
    max_tokens)`` tokens, never more, never fewer;
  * no silent loss: every submitted request ends either completed or
    typed-rejected (``"queue_full"`` at submit, ``"deadline"`` at shed) —
    the spring-survive seal;

— while the engine drives the same object with real jitted steps.

spring-survive additions (DESIGN.md §13):

  * *preemption*: a spilled request leaves its slot without retiring —
    its tokens-so-far and an opaque engine payload (the exact packed KV
    bits) park in a resume queue that drains, highest priority first
    (rid order within a class), ahead of new admissions;
  * *gated* admission (:meth:`admit_gated`): spilled requests resume
    first, then the queue, each gated by a caller feasibility check with
    strict head-of-line blocking;
  * *load shedding*: queue-depth rejection at submit, admission-deadline
    expiry at tick boundaries, both returning typed reasons;
  * *rescaling*: :meth:`rescale` re-sizes the slot pool of a drained
    (all-spilled) scheduler without touching queue/spill/log state.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Any, Callable, Optional

from repro_torch.serving.request import Request

#: typed rejection reasons (the only ways a request is ever refused)
REJECT_QUEUE_FULL = "queue_full"
REJECT_DEADLINE = "deadline"


@dataclasses.dataclass(frozen=True)
class ShedPolicy:
    """Load-shedding + SLO-aware admission knobs (all off by default).

    ``max_queue_depth``   submit-time shed: a request arriving at a full
                          queue is rejected with ``"queue_full"``.
    ``deadline_ticks``    admission deadline: a request still queued
                          ``deadline_ticks`` ticks after submission is
                          shed with ``"deadline"`` (per-request
                          ``Request.deadline_ticks`` overrides this).
    ``deadline_aware``    EDF variant of FCFS: admission pops the queued
                          request with the earliest absolute deadline
                          (FCFS among equal/absent deadlines).
    ``priority_aware``    admission pops the highest ``Request.priority``
                          first (FCFS within a class).
    """

    max_queue_depth: Optional[int] = None
    deadline_ticks: Optional[int] = None
    deadline_aware: bool = False
    priority_aware: bool = False

    def __post_init__(self):
        if self.max_queue_depth is not None and self.max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1, got {self.max_queue_depth}")
        if self.deadline_ticks is not None and self.deadline_ticks < 0:
            raise ValueError(
                f"deadline_ticks must be >= 0, got {self.deadline_ticks}")

    @property
    def reorders(self) -> bool:
        """True when admission order may diverge from submission order
        (the FCFS seal is then checked per-class instead of globally)."""
        return self.deadline_aware or self.priority_aware


@dataclasses.dataclass
class SpilledRequest:
    """A preempted in-flight request: everything needed to resume it
    bit-identically (the engine owns the payload's meaning)."""

    req: Request
    tokens: list
    payload: Any  # engine-side: exact packed KV bits + pos + next token


class RequestTracker:
    """One in-flight request: its slot, emitted tokens, finish rule."""

    def __init__(self, req: Request, slot: int):
        self.req = req
        self.slot = slot
        self.tokens: list = []
        self.finished_by: Optional[str] = None

    @property
    def finished(self) -> bool:
        return self.finished_by is not None

    def append(self, tok: int) -> bool:
        """Record one emitted token; returns True when the request is done
        (EOS emitted — included in the output — or max_tokens reached)."""
        assert not self.finished, f"request {self.req.rid} already finished"
        self.tokens.append(tok)
        if self.req.eos_id is not None and tok == self.req.eos_id:
            self.finished_by = "eos"
        elif len(self.tokens) >= self.req.max_tokens:
            self.finished_by = "max_tokens"
        return self.finished


class SlotScheduler:
    """Fixed slot pool + FCFS queue; requests join mid-flight and retire
    independently, freed slots refill from the queue on the next tick.
    With a :class:`ShedPolicy`, admission may shed (queue depth /
    deadlines) and reorder (priority / EDF); without one the behavior is
    byte-for-byte the historical FCFS scheduler."""

    def __init__(self, n_slots: int, policy: Optional[ShedPolicy] = None):
        if n_slots <= 0:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        self.policy = policy
        self._free: list[int] = list(range(n_slots))  # kept sorted
        self._queue: collections.deque[Request] = collections.deque()
        #: rid -> (enqueue tick, absolute deadline tick or None)
        self._queue_meta: dict[int, tuple[int, Optional[int]]] = {}
        self.active: dict[int, RequestTracker] = {}
        #: rids in admission order (the FCFS seal)
        self.admission_log: list[int] = []
        self._submit_log: list[int] = []
        #: (rid, reason) for every typed rejection, submission order
        self.shed_log: list[tuple[int, str]] = []
        #: preempted requests, highest priority first (rid order within)
        self._spilled: list[SpilledRequest] = []
        self.n_spills = 0
        self.n_resumes = 0

    # -- state views --------------------------------------------------------

    @property
    def free_slots(self) -> int:
        return len(self._free)

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def spilled(self) -> int:
        return len(self._spilled)

    @property
    def occupancy(self) -> float:
        return len(self.active) / self.n_slots

    def has_work(self) -> bool:
        return bool(self._queue or self.active or self._spilled)

    def check_invariants(self) -> None:
        assert len(self.active) + len(self._free) == self.n_slots, (
            f"slot leak: {len(self.active)} active + {len(self._free)} free "
            f"!= {self.n_slots}")
        assert set(self._free).isdisjoint(self.active), "slot double-booked"
        if self.policy is None or not self.policy.reorders:
            # FCFS seal: admission order is submission order with the
            # typed-rejected rids removed (shedding skips, never reorders)
            shed = {rid for rid, _ in self.shed_log}
            expect = [r for r in self._submit_log if r not in shed]
            assert self.admission_log == expect[:len(self.admission_log)], (
                "FCFS violated: admissions diverged from submission order")
        # conservation: every submitted rid is queued, active, spilled,
        # admitted (possibly retired) or typed-rejected — never lost
        seen = (set(self._queue_meta)
                | {t.req.rid for t in self.active.values()}
                | {s.req.rid for s in self._spilled}
                | set(self.admission_log)
                | {rid for rid, _ in self.shed_log})
        assert set(self._submit_log) <= seen, (
            f"request lost silently: {set(self._submit_log) - seen}")

    # -- lifecycle ----------------------------------------------------------

    def submit(self, req: Request, tick: int = 0) -> Optional[str]:
        """Enqueue ``req``; returns a typed rejection reason (and records
        it in ``shed_log``) instead of queueing when the policy sheds."""
        self._submit_log.append(req.rid)
        pol = self.policy
        if (pol is not None and pol.max_queue_depth is not None
                and len(self._queue) >= pol.max_queue_depth):
            self.shed_log.append((req.rid, REJECT_QUEUE_FULL))
            return REJECT_QUEUE_FULL
        deadline = None
        rel = req.deadline_ticks if req.deadline_ticks is not None else (
            pol.deadline_ticks if pol is not None else None)
        if rel is not None:
            deadline = tick + rel
        self._queue.append(req)
        self._queue_meta[req.rid] = (tick, deadline)
        return None

    def shed_expired(self, tick: int) -> list[tuple[Request, str]]:
        """Drop queued requests whose admission deadline passed before
        ``tick``; returns ``(request, reason)`` pairs (reason is always
        ``"deadline"``) so the engine can record typed rejections."""
        shed = []
        kept: collections.deque[Request] = collections.deque()
        for req in self._queue:
            _, deadline = self._queue_meta[req.rid]
            if deadline is not None and tick > deadline:
                del self._queue_meta[req.rid]
                self.shed_log.append((req.rid, REJECT_DEADLINE))
                shed.append((req, REJECT_DEADLINE))
            else:
                kept.append(req)
        self._queue = kept
        return shed

    # -- admission ordering (policy-aware) -----------------------------------

    def _next_index(self) -> int:
        """Queue index of the next admission: FIFO head unless the policy
        reorders, then (priority desc, deadline asc, submission order)."""
        pol = self.policy
        if pol is None or not pol.reorders:
            return 0

        def key(pair):
            idx, req = pair
            prio = -req.priority if pol.priority_aware else 0
            if pol.deadline_aware:
                _, deadline = self._queue_meta[req.rid]
                dl = deadline if deadline is not None else float("inf")
            else:
                dl = 0
            return (prio, dl, idx)  # idx: FCFS within a class

        return min(enumerate(self._queue), key=key)[0]

    def _peek_next(self) -> Request:
        return self._queue[self._next_index()]

    def _pop_next(self) -> Request:
        idx = self._next_index()
        req = self._queue[idx]
        del self._queue[idx]
        del self._queue_meta[req.rid]
        return req

    def admit(self) -> list[RequestTracker]:
        """Pop into free slots (lowest slot first, deterministic); policy
        order (FCFS by default).  Ungated form — engines with spill or
        feasibility gates use :meth:`admit_gated`."""
        assert not self._spilled, (
            "spilled requests pending: use admit_gated so they resume first")
        return [t for t, _ in self.admit_gated(lambda s: True, lambda r: True)]

    def admit_gated(
        self,
        can_resume: Callable[[SpilledRequest], bool],
        can_admit: Callable[[Request], bool],
    ) -> list[tuple[RequestTracker, Optional[SpilledRequest]]]:
        """Fill free slots: spilled requests first (highest priority,
        then oldest), then the queue in policy order, each gated by the
        caller's feasibility check.  Head-of-line blocking is strict in
        both queues *and* across them: a blocked spilled head stalls new
        admissions too, so the spill path can never be starved by a
        stream of small requests."""
        out: list[tuple[RequestTracker, Optional[SpilledRequest]]] = []
        while self._free and self._spilled:
            if not can_resume(self._spilled[0]):
                return out
            spilled = self._spilled.pop(0)
            slot = self._free.pop(0)
            tracker = RequestTracker(spilled.req, slot)
            tracker.tokens = list(spilled.tokens)
            self.active[slot] = tracker
            self.n_resumes += 1
            # no admission_log append: the rid was logged when first
            # admitted (the FCFS seal tracks first admissions only)
            out.append((tracker, spilled))
        while self._free and self._queue:
            if not can_admit(self._peek_next()):
                return out
            slot = self._free.pop(0)
            req = self._pop_next()
            tracker = RequestTracker(req, slot)
            self.active[slot] = tracker
            self.admission_log.append(req.rid)
            out.append((tracker, None))
        return out

    def retire(self, slot: int) -> RequestTracker:
        tracker = self.active.pop(slot)
        bisect.insort(self._free, slot)
        return tracker

    # -- preemption ---------------------------------------------------------

    def preempt(self, slot: int, payload: Any) -> SpilledRequest:
        """Evict the request in ``slot`` without retiring it: the slot
        frees immediately, the request parks in the resume queue (highest
        priority first; rid order — original FCFS — within a class, so
        shrinking below occupancy leaves exactly the lowest-priority
        requests on the spill path)."""
        tracker = self.active.pop(slot)
        bisect.insort(self._free, slot)
        spilled = SpilledRequest(req=tracker.req, tokens=list(tracker.tokens),
                                 payload=payload)
        bisect.insort(self._spilled, spilled,
                      key=lambda s: (-s.req.priority, s.req.rid))
        self.n_spills += 1
        return spilled

    # -- rescaling ----------------------------------------------------------

    def rescale(self, n_slots: int) -> None:
        """Re-size the slot pool.  The engine spills every active request
        first (the repack path), so only queue/spill/log state carries
        over; the free list is rebuilt for the new size."""
        if n_slots <= 0:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        assert not self.active, (
            "rescale requires a drained pool: spill active requests first")
        self.n_slots = n_slots
        self._free = list(range(n_slots))

    # -- decode-tick token recording ----------------------------------------

    def record_tokens(self, token_by_slot: dict) -> list[RequestTracker]:
        """Append one decode tick's token per slot in ``token_by_slot``;
        retire and return the trackers that finished on this tick.  Slots
        absent from the dict (still installing pages on the paged
        backend) get no token this tick."""
        done = []
        for slot in sorted(token_by_slot):
            if self.active[slot].append(int(token_by_slot[slot])):
                done.append(self.retire(slot))
        return done
