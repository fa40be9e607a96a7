"""qwen2-7b [dense]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — GQA, QKV bias [arXiv:2407.10671; hf].  head_dim 128, rope
theta 1M, untied lm_head.  Copied from ``repro/configs/qwen2_7b.py``."""
from repro_torch.configs.base import ArchDef
from repro_torch.models.attention import AttnSpec
from repro_torch.models.lm import LMConfig


def _full() -> LMConfig:
    return LMConfig(
        name="qwen2-7b", d_model=3584, vocab=152064, n_layers=28,
        pattern_unit=(("attn", "swiglu"),), n_units=28,
        attn=AttnSpec(n_heads=28, n_kv_heads=4, head_dim=128,
                      rope_theta=1_000_000.0, qkv_bias=True),
        d_ff=18944,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="qwen2-7b-reduced", d_model=112, vocab=512, n_layers=3,
        pattern_unit=(("attn", "swiglu"),), n_units=3,
        attn=AttnSpec(n_heads=7, n_kv_heads=1, head_dim=16, qkv_bias=True),
        d_ff=320, remat=False,
    )


ARCH = ArchDef("qwen2-7b", "dense", _full(), reduced, "arXiv:2407.10671")
