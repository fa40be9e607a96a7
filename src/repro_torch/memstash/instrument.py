"""Byte-accounting instrumentation for stash points (port of
``repro/memstash/instrument.py``).

A thread-local recorder collects one row per stash point while
:func:`record_stash_traffic` is active.  PyTorch runs eagerly, so every
row carries measured values (the reference records shape-only markers
under tracing); each row costs one extra compress and a host sync, so the
recorder is off unless asked for.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional

import torch

from repro_torch.memstash.config import MemstashConfig
from repro_torch.memstash.format import (
    compress,
    dense_fp32_bytes,
    formula_bits_per_elem,
    logical_bytes,
    wire_bytes,
)


class _Recorder(threading.local):
    def __init__(self):
        self.rows: Optional[list] = None


_REC = _Recorder()


@contextlib.contextmanager
def record_stash_traffic():
    """Collect stash-point rows from the forwards run inside the block."""
    prev = _REC.rows
    _REC.rows = []
    try:
        yield _REC.rows
    finally:
        _REC.rows = prev


def maybe_record(name: str, x: torch.Tensor, scfg: MemstashConfig) -> None:
    """Record measured compression stats for one stash point."""
    if _REC.rows is None:
        return
    with torch.no_grad():
        sv = compress(x.detach())
    n = sv.n
    nnz = int(sv.nnz)
    density = nnz / n
    _REC.rows.append({
        "layer": name,
        "elems": n,
        "nnz": nnz,
        "density": density,
        "dtype": str(x.dtype).replace("torch.", ""),
        "logical_bytes": logical_bytes(sv),
        "dense_fp32_bytes": dense_fp32_bytes(sv),
        "wire_bytes": float(wire_bytes(sv)),
        "formula_bytes": n * formula_bits_per_elem(density) / 8.0,
    })


def summarize(rows: list) -> dict:
    """Aggregate per-layer rows into model-level totals."""
    if not rows:
        return {"stash_points": 0}
    wire = sum(r["wire_bytes"] for r in rows)
    dense = sum(r["dense_fp32_bytes"] for r in rows)
    formula = sum(r["formula_bytes"] for r in rows)
    elems = sum(r["elems"] for r in rows)
    return {
        "stash_points": len(rows),
        "total_elems": elems,
        "mean_density": sum(r["nnz"] for r in rows) / elems,
        "dense_fp32_bytes": dense,
        "wire_bytes": wire,
        "formula_bytes": formula,
        "compression_vs_fp32": dense / wire if wire else float("inf"),
        "wire_vs_formula": wire / formula if formula else float("nan"),
    }
