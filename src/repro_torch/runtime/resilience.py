"""Host-side resilience: the straggler watchdog (port of
``repro/runtime/resilience.py``; pure Python, copied).

``StragglerWatchdog`` — per-step wall-time EWMA with a multiplicative
threshold; slow steps are logged and counted, and a configurable
escalation (abort-and-restart from a snapshot) triggers after K
consecutive slow steps.  The serving engine times every tick with it.
The reference's ``ElasticMeshPolicy`` waits for the mesh port.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

log = logging.getLogger("repro_torch.resilience")


@dataclasses.dataclass
class WatchdogEvent:
    step: int
    duration: float
    ewma: float
    slow: bool


class StragglerWatchdog:
    def __init__(
        self,
        threshold: float = 2.0,
        alpha: float = 0.1,
        escalate_after: int = 5,
        on_escalate: Optional[Callable[[], None]] = None,
        warmup_steps: int = 3,
    ):
        self.threshold = threshold
        self.alpha = alpha
        self.escalate_after = escalate_after
        self.on_escalate = on_escalate
        self.warmup_steps = warmup_steps
        self.ewma: Optional[float] = None
        self.consecutive_slow = 0
        self.events: list[WatchdogEvent] = []
        self._t0: Optional[float] = None
        self._seen = 0

    def step_start(self):
        self._t0 = time.monotonic()

    def step_end(self, step: int) -> WatchdogEvent:
        if self._t0 is None:
            # used to be a bare TypeError from the float arithmetic below
            raise RuntimeError(
                "StragglerWatchdog.step_end() called without a matching "
                "step_start()")
        dt = time.monotonic() - self._t0
        self._t0 = None  # consume: a double step_end is the same bug
        self._seen += 1
        slow = False
        if self.ewma is None:
            self.ewma = dt
        else:
            if self._seen > self.warmup_steps and dt > self.threshold * self.ewma:
                slow = True
                self.consecutive_slow += 1
                log.warning("straggler: step %d took %.3fs (ewma %.3fs)", step, dt, self.ewma)
                if self.consecutive_slow >= self.escalate_after and self.on_escalate:
                    log.error("straggler escalation after %d slow steps", self.consecutive_slow)
                    self.on_escalate()
            else:
                self.consecutive_slow = 0
            # slow steps don't poison the baseline
            if not slow:
                self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        ev = WatchdogEvent(step, dt, self.ewma, slow)
        self.events.append(ev)
        return ev
