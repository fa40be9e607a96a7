"""MetricsRegistry: one labeled home for every runtime measurement (a copy
of ``repro/telemetry/metrics.py``; pure Python).

Three instrument kinds, deliberately Prometheus-shaped so the exposition
is a straight rendering rather than a translation layer:

  * **counter** — monotonically increasing total (kernel dispatches,
    tokens emitted, wire bytes moved);
  * **gauge** — last-written value (KV-pool density, slot occupancy);
  * **histogram** — a :class:`~repro_torch.telemetry.sketch.QuantileSketch`
    per label set (token latency, TTFT, queue wait, tile-skip fraction).

One process-wide default registry replaces the module-level dicts that
used to hold kernel dispatch counts (``kernels/registry.py``) — every
subsystem writes here, and tests isolate through the explicit
``snapshot()`` / ``reset()`` API.

``snapshot()`` is the JSON artifact embedded in the serve launcher's
output under ``telemetry``; ``to_prometheus()`` (also
available on a saved snapshot via :func:`prometheus_from_snapshot`)
renders the text exposition format for scrape-style consumption, and
``render_table()`` the human view ``repro_torch.telemetry.report`` prints.
"""

from __future__ import annotations

import threading
from typing import Optional

from repro_torch.telemetry.sketch import QuantileSketch

__all__ = ["MetricsRegistry", "default_registry", "prometheus_from_snapshot",
           "render_snapshot_table"]

KINDS = ("counter", "gauge", "histogram")

#: Histogram percentiles reported in snapshots / tables.
PERCENTILES = (50, 95, 99)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Family:
    """One metric name: its kind, help text, and per-label-set cells."""

    __slots__ = ("name", "kind", "help", "cells")

    def __init__(self, name: str, kind: str, help: str):
        self.name = name
        self.kind = kind
        self.help = help
        self.cells: dict[tuple, object] = {}


class MetricsRegistry:
    """Thread-safe labeled metrics store with snapshot/reset isolation."""

    def __init__(self, *, alpha: float = 0.01, max_exact: int = 128):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}
        self._alpha = alpha
        self._max_exact = max_exact

    # -- registration / write path ------------------------------------------

    def _family(self, name: str, kind: str, help: str) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            fam = self._families[name] = _Family(name, kind, help)
        elif fam.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as a {fam.kind}, "
                f"cannot re-register as a {kind}")
        return fam

    def inc(self, name: str, value: float = 1.0, *, help: str = "",
            **labels) -> None:
        """Increment a counter cell (creates the family on first use)."""
        if value < 0:
            raise ValueError(f"counter {name!r}: negative increment {value}")
        key = _label_key(labels)
        with self._lock:
            cells = self._family(name, "counter", help).cells
            cells[key] = cells.get(key, 0.0) + value

    def set(self, name: str, value: float, *, help: str = "",
            **labels) -> None:
        """Write a gauge cell (last value wins)."""
        with self._lock:
            self._family(name, "gauge", help).cells[_label_key(labels)] = \
                float(value)

    def observe(self, name: str, value: float, *, help: str = "",
                **labels) -> None:
        """Feed one sample into a histogram cell's quantile sketch."""
        key = _label_key(labels)
        with self._lock:
            cells = self._family(name, "histogram", help).cells
            sk = cells.get(key)
            if sk is None:
                sk = cells[key] = QuantileSketch(alpha=self._alpha,
                                                max_exact=self._max_exact)
            sk.add(value)

    # -- read path -----------------------------------------------------------

    def get(self, name: str, **labels):
        """Current value of one cell: float for counter/gauge, the live
        QuantileSketch for a histogram; None if never written."""
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                return None
            return fam.cells.get(_label_key(labels))

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._families)

    def snapshot(self) -> dict:
        """JSON-safe view of every cell.

        ``{name: {"kind", "help", "cells": [{"labels": {...}, ...}]}}``;
        histogram cells carry count/sum/min/max/mean + the reporting
        percentiles and the full serialized sketch (so snapshots merge).
        """
        with self._lock:
            out = {}
            for name in sorted(self._families):
                fam = self._families[name]
                cells = []
                for key in sorted(fam.cells):
                    cell: dict = {"labels": dict(key)}
                    v = fam.cells[key]
                    if fam.kind == "histogram":
                        cell.update(
                            count=v.count, sum=v.sum, mean=v.mean,
                            min=v.min if v.count else None,
                            max=v.max if v.count else None,
                            **v.percentiles(PERCENTILES),
                            sketch=v.to_dict())
                    else:
                        cell["value"] = v
                    cells.append(cell)
                out[name] = {"kind": fam.kind, "help": fam.help,
                             "cells": cells}
            return out

    def reset(self, name: Optional[str] = None) -> None:
        """Clear one family (``name``) or everything (the per-test
        isolation hook; registrations are recreated on next write)."""
        with self._lock:
            if name is None:
                self._families.clear()
            else:
                self._families.pop(name, None)

    def restore(self, snap: dict) -> None:
        """Load a ``snapshot()`` payload back into the live registry.

        Cells present in the snapshot *overwrite* live cells of the same
        name/labels (counters are assigned, not added; histogram sketches
        are replaced wholesale) — this is not a merge.  Intended to follow
        ``reset()``, as a test's isolation does, to put the
        registry back exactly as a prior snapshot saw it."""
        with self._lock:
            for name in snap:
                fam_snap = snap[name]
                fam = self._family(name, fam_snap["kind"],
                                   fam_snap.get("help", ""))
                for cell in fam_snap["cells"]:
                    key = _label_key(cell.get("labels", {}))
                    if fam.kind == "histogram":
                        fam.cells[key] = QuantileSketch.from_dict(
                            cell["sketch"])
                    else:
                        fam.cells[key] = float(cell["value"])

    # -- renderings ----------------------------------------------------------

    def to_prometheus(self) -> str:
        return prometheus_from_snapshot(self.snapshot())

    def render_table(self) -> str:
        return render_snapshot_table(self.snapshot())


# -- snapshot renderings (shared by the live registry and saved artifacts) --


def _prom_labels(labels: dict) -> str:
    if not labels:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + body + "}"


def _prom_value(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def prometheus_from_snapshot(snap: dict) -> str:
    """Prometheus text exposition (v0.0.4) of a ``snapshot()`` payload.

    Histograms expose ``_count`` / ``_sum`` plus quantile samples in the
    summary style (``{quantile="0.5"}``) — the sketch stores quantiles,
    not cumulative le-buckets, so summary is the faithful rendering.
    """
    lines = []
    for name in sorted(snap):
        fam = snap[name]
        kind = {"histogram": "summary"}.get(fam["kind"], fam["kind"])
        if fam.get("help"):
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {kind}")
        for cell in fam["cells"]:
            labels = cell.get("labels", {})
            if fam["kind"] == "histogram":
                for p in PERCENTILES:
                    q = dict(labels, quantile=str(p / 100.0))
                    lines.append(
                        f"{name}{_prom_labels(q)} "
                        f"{_prom_value(cell[f'p{p:g}'])}")
                lines.append(f"{name}_count{_prom_labels(labels)} "
                             f"{_prom_value(cell['count'])}")
                lines.append(f"{name}_sum{_prom_labels(labels)} "
                             f"{_prom_value(cell['sum'])}")
            else:
                lines.append(f"{name}{_prom_labels(labels)} "
                             f"{_prom_value(cell['value'])}")
    return "\n".join(lines) + ("\n" if lines else "")


def render_snapshot_table(snap: dict) -> str:
    """Human table of a snapshot (the ``repro_torch.telemetry.report`` view)."""
    rows = [("metric", "kind", "labels", "value")]
    for name in sorted(snap):
        fam = snap[name]
        for cell in fam["cells"]:
            labels = ",".join(f"{k}={v}"
                              for k, v in sorted(cell.get("labels", {}).items()))
            if fam["kind"] == "histogram":
                val = (f"n={cell['count']} mean={cell['mean']:.6g} "
                       + " ".join(f"p{p:g}={cell[f'p{p:g}']:.6g}"
                                  for p in PERCENTILES))
            else:
                val = f"{cell['value']:.6g}"
            rows.append((name, fam["kind"], labels or "-", val))
    if len(rows) == 1:
        return "(no metrics recorded)"
    widths = [max(len(r[i]) for r in rows) for i in range(3)]
    out = []
    for i, r in enumerate(rows):
        out.append("  ".join([r[0].ljust(widths[0]), r[1].ljust(widths[1]),
                              r[2].ljust(widths[2]), r[3]]))
        if i == 0:
            out.append("  ".join("-" * w for w in widths + [8]))
    return "\n".join(out)


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem writes to (kernels,
    serving, launchers).  Tests isolate via ``default_registry().reset()``."""
    return _DEFAULT
