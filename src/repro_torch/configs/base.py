"""Architecture definition (minimal port of ``repro/configs/base.py``).

An ``ArchDef`` carries the published config and a ``reduced()`` smoke-test
variant of the same family.  The dry-run shape cells and ShapeDtypeStruct
stand-ins of the reference have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.models.lm import LMConfig


@dataclasses.dataclass(frozen=True)
class ArchDef:
    arch_id: str
    family: str  # dense | hybrid | vlm | moe | ssm | audio
    config: LMConfig
    reduced: Callable[[], LMConfig]
    source: str = ""

    def resolve(self, reduced: bool = False) -> LMConfig:
        return self.reduced() if reduced else self.config
