"""internvl2-26b [vlm]: 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT frontend + InternLM2-20B backbone
[arXiv:2404.16821].  The ViT is a STUB: 256 precomputed patch embeddings
are prepended to the text sequence.  Copied from
``repro/configs/internvl2_26b.py``."""
from repro_torch.configs.base import ArchDef
from repro_torch.models.attention import AttnSpec
from repro_torch.models.lm import LMConfig


def _full() -> LMConfig:
    return LMConfig(
        name="internvl2-26b", d_model=6144, vocab=92553, n_layers=48,
        pattern_unit=(("attn", "swiglu"),), n_units=48,
        attn=AttnSpec(n_heads=48, n_kv_heads=8, head_dim=128, rope_theta=1_000_000.0),
        d_ff=16384, vlm_prefix_len=256,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="internvl2-26b-reduced", d_model=96, vocab=512, n_layers=3,
        pattern_unit=(("attn", "swiglu"),), n_units=3,
        attn=AttnSpec(n_heads=6, n_kv_heads=2, head_dim=16),
        d_ff=256, vlm_prefix_len=8, remat=False,
    )


ARCH = ArchDef("internvl2-26b", "vlm", _full(), reduced, "arXiv:2404.16821")
