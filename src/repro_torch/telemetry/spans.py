"""Span tracer with Chrome trace-event (Perfetto-loadable) JSON export (a
copy of ``repro/telemetry/spans.py``; pure Python).

Spans wrap the phases worth attributing wall-clock to: the ServingEngine
tick phases (schedule / prefill / install / decode / sample / repack,
spill / resume, rescale).  Each completed span becomes one Chrome ``"ph": "X"``
(complete) event — ``chrome://tracing`` and https://ui.perfetto.dev load
the exported file directly.

Overhead contract (the reference's DESIGN.md §11): when tracing is
disabled — the default — ``span()`` is one attribute load, one truthiness test, and the
return of a shared no-op context manager.  No object allocation, no
timestamp read, no lock.  The enabled path takes two ``monotonic_ns``
reads and one list append per span (plus one lock-guarded sampling
accumulator update per root span); there is deliberately no torch work
and no device sync inside the tracer, so enabling it cannot perturb
numerics (the on/off parity seal in tests/test_torch_telemetry.py).
On the card a span around queued work measures its issue; the engine
closes its spans where it already waits for the device.

Sampling is deterministic (no PRNG — workflows replay): a fractional
accumulator records ``ceil(k * rate)`` of the first ``k`` top-level
spans, evenly spread.  Nested spans follow their root's decision so a
sampled trace always shows complete ticks, never orphaned children.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

__all__ = ["SpanTracer", "Span", "validate_chrome_trace"]

#: Required keys of a Chrome complete event (the schema CI validates).
CHROME_EVENT_KEYS = ("name", "ph", "ts", "dur", "pid", "tid")


class Span:
    """One open span; append-only record closed by ``__exit__``."""

    __slots__ = ("tracer", "name", "args", "_t0", "recorded")

    def __init__(self, tracer: "SpanTracer", name: str, args: dict,
                 recorded: bool):
        self.tracer = tracer
        self.name = name
        self.args = args
        self.recorded = recorded
        self._t0 = 0

    def __enter__(self) -> "Span":
        self.tracer._depth.value += 1
        self._t0 = time.monotonic_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = time.monotonic_ns()
        self.tracer._depth.value -= 1
        if self.recorded:
            self.tracer._record(self.name, self._t0, t1, self.args)


class _NullSpan:
    """Shared no-op context manager: the whole disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


_NULL = _NullSpan()


class _Depth(threading.local):
    def __init__(self):
        self.value = 0
        self.root_sampled = True


class SpanTracer:
    """Collects spans; exports the Chrome trace-event JSON object."""

    def __init__(self, enabled: bool = True, sample_rate: float = 1.0):
        if not 0.0 < sample_rate <= 1.0:
            raise ValueError(
                f"sample_rate must be in (0, 1], got {sample_rate}")
        self.enabled = enabled
        self.sample_rate = sample_rate
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._depth = _Depth()
        self._acc = 0.0  # deterministic sampling accumulator
        self._epoch_ns = time.monotonic_ns()
        self._pid = os.getpid()

    # -- recording -----------------------------------------------------------

    def span(self, name: str, **args):
        """Context manager timing one phase.  Disabled tracers hand back
        the shared no-op; nested spans inherit the root sampling call."""
        if not self.enabled:
            return _NULL
        if self._depth.value == 0:  # root: one sampling decision per tree
            with self._lock:  # _acc is shared across threads' root spans
                self._acc += self.sample_rate
                sampled = self._acc >= 1.0
                if sampled:
                    self._acc -= 1.0
            self._depth.root_sampled = sampled
        # unsampled spans still track depth (a _NULL here would make the
        # dropped root's children look like fresh roots and re-roll the
        # sampling decision mid-tree)
        return Span(self, name, args, recorded=self._depth.root_sampled)

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker (Chrome ``"ph": "i"`` instant event)."""
        if not self.enabled or not self._depth.root_sampled:
            return
        ev = {
            "name": name, "ph": "i", "s": "t",
            "ts": (time.monotonic_ns() - self._epoch_ns) / 1e3,
            "pid": self._pid, "tid": threading.get_ident(),
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def _record(self, name: str, t0_ns: int, t1_ns: int, args: dict) -> None:
        ev = {
            "name": name, "ph": "X",
            "ts": (t0_ns - self._epoch_ns) / 1e3,  # microseconds
            "dur": (t1_ns - t0_ns) / 1e3,
            "pid": self._pid, "tid": threading.get_ident(),
        }
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    # -- export --------------------------------------------------------------

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._acc = 0.0

    def to_chrome_trace(self, extra_metadata: Optional[dict] = None) -> dict:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        meta = {"tracer": "spring-trace"}
        if extra_metadata:
            meta.update(extra_metadata)
        return {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": meta,
        }

    def write(self, path: str, extra_metadata: Optional[dict] = None) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(extra_metadata), f)
        return path


def validate_chrome_trace(data) -> list[dict]:
    """Validate a loaded trace object (or JSON text) against the Chrome
    trace-event schema this tracer emits; returns the events.

    Raises ``ValueError`` naming the first violation — the CI
    trace-schema step feeds exported files through this.
    """
    if isinstance(data, (str, bytes)):
        data = json.loads(data)
    if not isinstance(data, dict) or "traceEvents" not in data:
        raise ValueError("trace must be an object with a 'traceEvents' key")
    events = data["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("'traceEvents' must be a list")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event {i} is not an object")
        ph = ev.get("ph")
        if ph not in ("X", "i"):
            raise ValueError(f"event {i}: unexpected phase {ph!r}")
        keys = CHROME_EVENT_KEYS if ph == "X" else tuple(
            k for k in CHROME_EVENT_KEYS if k != "dur")
        for k in keys:
            if k not in ev:
                raise ValueError(f"event {i} ({ev.get('name')!r}): "
                                 f"missing key {k!r}")
        if not isinstance(ev["name"], str) or not ev["name"]:
            raise ValueError(f"event {i}: name must be a non-empty string")
        if ph == "X" and ev["dur"] < 0:
            raise ValueError(f"event {i}: negative duration")
    return events
