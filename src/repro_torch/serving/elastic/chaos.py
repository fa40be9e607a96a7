"""ChaosHarness: drive a serving engine through arbitrary failure
schedules and prove nothing observable changes (port of
``repro/serving/elastic/chaos.py``).

The harness steps an engine tick-by-tick while injecting events at
chosen *harness-step* boundaries (not ``engine.tick`` — a rewind moves
the engine's tick counter backwards, while the harness clock only moves
forward, so every scheduled event fires exactly once):

  ``snapshot``    stash an in-memory snapshot (becomes the rewind target)
  ``rewind``      restore the last stash — the engine re-executes the
                  interval, re-emitting the *same* tokens
  ``kill``        process death: snapshot, abandon the live engine (or
                  swap in a freshly built one via ``make_engine``),
                  restore into the survivor
  ``roundtrip``   snapshot -> .npz on disk -> load -> restore, with a
                  byte-exactness check on the serialized artifact
  ``rescale``     grow/shrink slots and/or (paged backend) the physical
                  page budget on the live engine

The seal (tests/test_torch_elastic.py, and on the card chip_smoke.py's
phase 6g): for any event schedule, every completed request's token list
is bit-identical to the uninterrupted run — the packed-bits snapshot is
exact, so chaos is invisible in the output.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable, Optional

from repro_torch.serving.elastic import snapshot as snapshot_mod


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One injected failure: ``kind`` at harness step ``at``.

    ``slots``/``num_pages`` parameterize ``rescale`` (None = keep).
    """

    at: int
    kind: str  # "snapshot" | "rewind" | "kill" | "roundtrip" | "rescale"
    slots: Optional[int] = None
    num_pages: Optional[int] = None

    KINDS = ("snapshot", "rewind", "kill", "roundtrip", "rescale")

    def __post_init__(self):
        if self.kind not in self.KINDS:
            raise ValueError(f"unknown chaos event kind {self.kind!r}")
        if self.at < 0:
            raise ValueError(f"event step must be >= 0, got {self.at}")


class ChaosHarness:
    """Run ``engine`` to completion under an event schedule.

    ``make_engine`` (optional) builds a cold replacement engine for
    ``kill`` events — true process death.  Without it, a kill restores
    into the same object, which exercises the identical code path minus
    engine construction.
    """

    def __init__(self, engine, events, *,
                 make_engine: Optional[Callable[[], object]] = None,
                 max_steps: int = 10_000, tmp_dir: Optional[str] = None):
        self.engine = engine
        self.make_engine = make_engine
        self.max_steps = max_steps
        self.tmp_dir = tmp_dir or tempfile.gettempdir()
        self._pending: dict[int, list[ChaosEvent]] = {}
        for ev in events:
            self._pending.setdefault(ev.at, []).append(ev)
        self.applied: list[ChaosEvent] = []

    def run(self) -> dict:
        """Drain the engine under chaos; returns its final summary."""
        steps = 0
        stash = None
        while self.engine.sched.has_work():
            for ev in self._pending.pop(steps, ()):
                stash = self._apply(ev, stash)
                self.applied.append(ev)
            if not self.engine.sched.has_work():
                break  # a rewind target may itself be fully drained
            self.engine.step()
            self.engine.sched.check_invariants()
            steps += 1
            if steps > self.max_steps:
                raise RuntimeError(
                    f"chaos run still has work after {self.max_steps} steps")
        return self.engine.summary()

    # -- event application ----------------------------------------------------

    def _apply(self, ev: ChaosEvent, stash):
        eng = self.engine
        if ev.kind == "snapshot":
            return eng.snapshot()
        if ev.kind == "rewind":
            if stash is not None:
                eng.restore(stash)
            return stash
        if ev.kind == "kill":
            snap = eng.snapshot()
            survivor = self.make_engine() if self.make_engine else eng
            survivor.restore(snap)
            self.engine = survivor
            return stash
        if ev.kind == "roundtrip":
            snap = eng.snapshot()
            fd, path = tempfile.mkstemp(suffix=".npz", dir=self.tmp_dir)
            os.close(fd)
            try:
                snapshot_mod.save_snapshot(snap, path)
                eng.restore(snapshot_mod.load_snapshot(path))
            finally:
                os.unlink(path)
            return stash
        if ev.kind == "rescale":
            kw = {}
            if ev.num_pages is not None:
                if eng.backend_kind != "paged":
                    raise ValueError(
                        "num_pages rescale needs the paged backend")
                kw["num_pages"] = ev.num_pages
            eng.rescale(ev.slots, **kw)
            return stash
        raise AssertionError(f"unreachable: {ev.kind}")
