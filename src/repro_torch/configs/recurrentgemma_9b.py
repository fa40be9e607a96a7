"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (GQA kv=1, i.e. MQA)
d_ff=12288 vocab=256000 — RG-LRU + local attn, pattern 2 recurrent : 1
local-attention [arXiv:2402.19427].  38 = 12 x (rec,rec,local) + 2 rec.
Local attention: window 2048, head_dim 256.  Copied from
``repro/configs/recurrentgemma_9b.py``."""
from repro_torch.configs.base import ArchDef
from repro_torch.models.attention import AttnSpec
from repro_torch.models.lm import LMConfig
from repro_torch.models.recurrent import RGLRUSpec


def _full() -> LMConfig:
    return LMConfig(
        name="recurrentgemma-9b", d_model=4096, vocab=256000, n_layers=38,
        pattern_unit=(("rglru", "swiglu"), ("rglru", "swiglu"), ("local", "swiglu")),
        n_units=12,
        suffix=(("rglru", "swiglu"), ("rglru", "swiglu")),
        local_attn=AttnSpec(n_heads=16, n_kv_heads=1, head_dim=256, window=2048),
        rglru=RGLRUSpec(d_rnn=4096),
        d_ff=12288, supports_long_context=True,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="recurrentgemma-9b-reduced", d_model=64, vocab=512, n_layers=5,
        pattern_unit=(("rglru", "swiglu"), ("rglru", "swiglu"), ("local", "swiglu")),
        n_units=1,
        suffix=(("rglru", "swiglu"), ("rglru", "swiglu")),
        local_attn=AttnSpec(n_heads=4, n_kv_heads=1, head_dim=16, window=16),
        rglru=RGLRUSpec(d_rnn=64),
        d_ff=192, supports_long_context=True, remat=False,
    )


ARCH = ArchDef("recurrentgemma-9b", "hybrid", _full(), reduced, "arXiv:2402.19427")
