"""Compressed activation stash (port of ``repro/memstash``): binary-mask
compressed forward residuals, restored on the backward pass."""

from repro_torch.memstash.config import REMAT_ALL, STASH_ALL, STASH_POLICIES, MemstashConfig
from repro_torch.memstash.format import (
    VALUE_BITS,
    StashedActivation,
    compress,
    decompress,
    dense_fp32_bytes,
    formula_bits_per_elem,
    logical_bytes,
    wire_bits,
    wire_bytes,
)
from repro_torch.memstash.instrument import record_stash_traffic, summarize
from repro_torch.memstash.stash import checkpoint_apply, stash_apply

__all__ = [
    "MemstashConfig", "REMAT_ALL", "VALUE_BITS", "STASH_ALL", "STASH_POLICIES", "StashedActivation",
    "checkpoint_apply", "compress", "decompress", "dense_fp32_bytes",
    "formula_bits_per_elem", "logical_bytes", "record_stash_traffic", "stash_apply",
    "summarize", "wire_bits", "wire_bytes",
]
