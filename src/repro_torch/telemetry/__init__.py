"""spring-trace: unified telemetry — metrics registry, span tracing, and
serving latency attribution (a copy of ``repro/telemetry/__init__.py``;
the reference's DESIGN.md §11).

One subsystem owns all runtime measurement:

  * :mod:`repro_torch.telemetry.metrics` — the labeled
    :class:`MetricsRegistry` (counters / gauges / quantile-sketch
    histograms) every other subsystem writes into, with
    ``snapshot()`` / ``reset()`` isolation and Prometheus exposition;
  * :mod:`repro_torch.telemetry.spans` — the Chrome-trace span tracer;
  * :mod:`repro_torch.telemetry.sketch` — the mergeable quantile sketch;
  * :mod:`repro_torch.telemetry.report` — the CLI rendering artifacts.

Ambient surface (this module): instrumented code calls
``telemetry.span("serve.tick.decode")`` / ``telemetry.enabled()``
unconditionally; both are near-zero-overhead no-ops until a
:class:`TelemetryConfig` scope activates a tracer.  The serve launcher
activates it (the RunSpec's ``telemetry.enabled``) via
:func:`scope`, which also writes the trace file on exit.  Enabling
telemetry never changes computed values — the tracer does no torch work
(sealed by the on/off parity test).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

from repro_torch.telemetry.metrics import MetricsRegistry, default_registry
from repro_torch.telemetry.sketch import QuantileSketch
from repro_torch.telemetry.spans import SpanTracer, validate_chrome_trace

__all__ = [
    "TelemetryConfig", "MetricsRegistry", "QuantileSketch", "SpanTracer",
    "default_registry", "validate_chrome_trace",
    "span", "instant", "enabled", "tracer", "scope", "metrics",
]


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Resolved telemetry settings (mirrors the RunSpec section)."""

    enabled: bool = False
    trace_path: str = ""  # "" = collect in memory only
    sample_rate: float = 1.0  # fraction of tick/step span trees recorded


class _Ambient(threading.local):
    """Per-thread active tracer (None = disabled fast path)."""

    def __init__(self):
        self.tracer: Optional[SpanTracer] = None


_AMBIENT = _Ambient()


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL = _NullSpan()


def tracer() -> Optional[SpanTracer]:
    """The active tracer, or None when telemetry is disabled."""
    return _AMBIENT.tracer


def enabled() -> bool:
    return _AMBIENT.tracer is not None


def span(name: str, **args):
    """Time one phase: ``with telemetry.span("serve.tick.decode"): ...``.

    Disabled path = one attribute load + one None test + returning a
    shared no-op context manager (the reference's overhead gate
    budget measures exactly this call).
    """
    t = _AMBIENT.tracer
    if t is None:
        return _NULL
    return t.span(name, **args)


def instant(name: str, **args) -> None:
    """Zero-duration trace marker (no-op when disabled)."""
    t = _AMBIENT.tracer
    if t is not None:
        t.instant(name, **args)


def metrics() -> MetricsRegistry:
    """Alias for :func:`default_registry` (the one metrics home)."""
    return default_registry()


@contextlib.contextmanager
def scope(cfg: Optional[TelemetryConfig], metadata: Optional[dict] = None):
    """Activate telemetry for a session body.

    Yields the active :class:`SpanTracer` (None when ``cfg`` is None or
    disabled — callers need no branching; ambient ``span()`` handles it).
    On exit the trace is written to ``cfg.trace_path`` when set, and the
    previous ambient tracer is restored (scopes nest).
    """
    if cfg is None or not cfg.enabled:
        yield None
        return
    t = SpanTracer(enabled=True, sample_rate=cfg.sample_rate)
    prev = _AMBIENT.tracer
    _AMBIENT.tracer = t
    try:
        yield t
    finally:
        _AMBIENT.tracer = prev
        if cfg.trace_path:
            t.write(cfg.trace_path, extra_metadata=metadata)
