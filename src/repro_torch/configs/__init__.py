"""Architectures the port serves (all ten of ``repro.configs``), the
dry-run shape cells and the per-family memstash default."""

from repro_torch.configs.base import SHAPES, ArchDef, ResolvedArch, ShapeSpec, default_memstash
from repro_torch.configs.registry import ARCHS, get_arch

__all__ = ["SHAPES", "ARCHS", "ArchDef", "ResolvedArch", "ShapeSpec", "default_memstash",
           "get_arch"]
