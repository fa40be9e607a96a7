"""Registry of the architectures the port serves (port of
``repro/configs/registry.py``, all ten of them): ``--arch <id>``."""

from __future__ import annotations

from repro_torch.configs.base import ArchDef
from repro_torch.configs.deepseek_v2_lite_16b import ARCH as _deepseek
from repro_torch.configs.internvl2_26b import ARCH as _internvl2
from repro_torch.configs.llama3_2_1b import ARCH as _llama
from repro_torch.configs.mamba2_780m import ARCH as _mamba2
from repro_torch.configs.minitron_4b import ARCH as _minitron
from repro_torch.configs.mistral_nemo_12b import ARCH as _nemo
from repro_torch.configs.olmoe_1b_7b import ARCH as _olmoe
from repro_torch.configs.qwen2_7b import ARCH as _qwen2
from repro_torch.configs.recurrentgemma_9b import ARCH as _rgemma
from repro_torch.configs.whisper_medium import ARCH as _whisper

ARCHS: dict[str, ArchDef] = {a.arch_id: a for a in [_minitron, _nemo, _qwen2, _llama, _rgemma,
                                                    _internvl2, _deepseek, _olmoe, _mamba2,
                                                    _whisper]}


def get_arch(arch_id: str) -> ArchDef:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(ARCHS)}")
    return ARCHS[arch_id]
