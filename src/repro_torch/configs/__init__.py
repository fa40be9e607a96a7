"""Architectures the port serves (a subset of ``repro.configs``)."""

from repro_torch.configs.base import ArchDef
from repro_torch.configs.registry import ARCHS, get_arch

__all__ = ["ARCHS", "ArchDef", "get_arch"]
