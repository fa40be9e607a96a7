"""Architectures the port serves (a subset of ``repro.configs``)."""

from __future__ import annotations

from repro_torch.configs import llama3_2_1b, mamba2_780m
from repro_torch.configs.base import ArchDef

ARCHS: dict[str, ArchDef] = {a.arch_id: a for a in (llama3_2_1b.ARCH, mamba2_780m.ARCH)}


def get_arch(arch_id: str) -> ArchDef:
    if arch_id not in ARCHS:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported; ported: {sorted(ARCHS)}")
    return ARCHS[arch_id]
