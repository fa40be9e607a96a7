"""minitron-4b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 — pruned nemotron [arXiv:2407.14679; hf].  head_dim=128,
untied lm_head, rope theta 10k.  Copied from
``repro/configs/minitron_4b.py``."""
from repro_torch.configs.base import ArchDef
from repro_torch.models.attention import AttnSpec
from repro_torch.models.lm import LMConfig


def _full() -> LMConfig:
    return LMConfig(
        name="minitron-4b", d_model=3072, vocab=256000, n_layers=32,
        pattern_unit=(("attn", "swiglu"),), n_units=32,
        attn=AttnSpec(n_heads=24, n_kv_heads=8, head_dim=128, rope_theta=10000.0),
        d_ff=9216,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="minitron-4b-reduced", d_model=96, vocab=512, n_layers=3,
        pattern_unit=(("attn", "swiglu"),), n_units=3,
        attn=AttnSpec(n_heads=6, n_kv_heads=2, head_dim=16),
        d_ff=256, remat=False,
    )


ARCH = ArchDef("minitron-4b", "dense", _full(), reduced, "arXiv:2407.14679")
