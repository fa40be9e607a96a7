"""Architecture definition and the dry-run shape cells (port of
``repro/configs/base.py``).

An ``ArchDef`` carries the published config and a ``reduced()`` smoke-test
variant of the same family.  ``SHAPES`` and :func:`default_memstash` are
copies of the reference's: the RunSpec validates ``shape.cell`` against
the one and resolves ``memstash.policy="auto"`` through the other.  The
reference's ShapeDtypeStruct stand-ins have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Union

from repro_torch.memstash.config import MemstashConfig
from repro_torch.models.encdec import EncDecConfig
from repro_torch.models.lm import LMConfig


def default_memstash(family: str) -> MemstashConfig:
    """Recommended memstash policy per workload family: ``"cnn"`` (the
    paper's CNNs, genuinely sparse post-ReLU activations) stashes
    compressed, every LM family (dense | hybrid | vlm | moe | ssm | audio)
    recomputes."""
    if family == "cnn":
        return MemstashConfig(policy="stash")
    return MemstashConfig(policy="remat")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ResolvedArch:
    """An arch view with one concrete config picked (full or reduced, or a
    spec-modified copy): what the train step factories take.  ``reduced()``
    returns the same config, resolution already happened."""

    is_encdec: bool
    config: Union[LMConfig, EncDecConfig]

    def reduced(self) -> Union[LMConfig, EncDecConfig]:
        return self.config


@dataclasses.dataclass(frozen=True)
class ArchDef:
    arch_id: str
    family: str  # dense | hybrid | vlm | moe | ssm | audio
    config: Union[LMConfig, EncDecConfig]
    reduced: Callable[[], Union[LMConfig, EncDecConfig]]
    source: str = ""

    @property
    def is_encdec(self) -> bool:
        return isinstance(self.config, EncDecConfig)

    def resolve(self, reduced: bool = False) -> Union[LMConfig, EncDecConfig]:
        return self.reduced() if reduced else self.config

    def view(self, reduced: bool = False, config=None) -> ResolvedArch:
        """The arch with one config picked (``config`` overrides)."""
        if config is None:
            config = self.resolve(reduced)
        return ResolvedArch(self.is_encdec, config)
