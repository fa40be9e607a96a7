"""Architectures the port serves (a subset of ``repro.configs``)."""

from __future__ import annotations

from repro_torch.configs import llama3_2_1b
from repro_torch.configs.base import ArchDef

ARCHS: dict[str, ArchDef] = {llama3_2_1b.ARCH.arch_id: llama3_2_1b.ARCH}


def get_arch(arch_id: str) -> ArchDef:
    if arch_id not in ARCHS:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported; ported: {sorted(ARCHS)}")
    return ARCHS[arch_id]
