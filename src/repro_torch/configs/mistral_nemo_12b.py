"""mistral-nemo-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407].
head_dim=128 is explicit (not d_model / n_heads, which is 160); untied
lm_head, rope theta 1M.  Copied from ``repro/configs/mistral_nemo_12b.py``."""
from repro_torch.configs.base import ArchDef
from repro_torch.models.attention import AttnSpec
from repro_torch.models.lm import LMConfig


def _full() -> LMConfig:
    return LMConfig(
        name="mistral-nemo-12b", d_model=5120, vocab=131072, n_layers=40,
        pattern_unit=(("attn", "swiglu"),), n_units=40,
        attn=AttnSpec(n_heads=32, n_kv_heads=8, head_dim=128, rope_theta=1_000_000.0),
        d_ff=14336,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="mistral-nemo-12b-reduced", d_model=128, vocab=512, n_layers=3,
        pattern_unit=(("attn", "swiglu"),), n_units=3,
        attn=AttnSpec(n_heads=8, n_kv_heads=2, head_dim=16, rope_theta=1_000_000.0),
        d_ff=384, remat=False,
    )


ARCH = ArchDef("mistral-nemo-12b", "dense", _full(), reduced,
               "hf:mistralai/Mistral-Nemo-Base-2407")
