"""llama3.2-1b [dense]: 16L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=128256 — small llama3 [hf:meta-llama/Llama-3.2-1B]. head_dim=64,
tied embeddings, rope theta 500k.  Copied from
``repro/configs/llama3_2_1b.py``."""
from repro_torch.configs.base import ArchDef
from repro_torch.models.attention import AttnSpec
from repro_torch.models.lm import LMConfig


def _full() -> LMConfig:
    return LMConfig(
        name="llama3.2-1b", d_model=2048, vocab=128256, n_layers=16,
        pattern_unit=(("attn", "swiglu"),), n_units=16,
        attn=AttnSpec(n_heads=32, n_kv_heads=8, head_dim=64, rope_theta=500_000.0),
        d_ff=8192, tie_embeddings=True,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="llama3.2-1b-reduced", d_model=128, vocab=512, n_layers=3,
        pattern_unit=(("attn", "swiglu"),), n_units=3,
        attn=AttnSpec(n_heads=8, n_kv_heads=2, head_dim=16, rope_theta=500_000.0),
        d_ff=384, tie_embeddings=True, remat=False,
    )


ARCH = ArchDef("llama3.2-1b", "dense", _full(), reduced, "hf:meta-llama/Llama-3.2-1B")
