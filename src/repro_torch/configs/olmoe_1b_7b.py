"""olmoe-1b-7b [moe]: 16L d_model=2048 16H (kv=16, i.e. MHA) per-expert
d_ff=1024 vocab=50304, 64 experts top-8 [arXiv:2409.02060; hf].  Copied
from ``repro/configs/olmoe_1b_7b.py``."""
from repro_torch.configs.base import ArchDef
from repro_torch.models.attention import AttnSpec
from repro_torch.models.lm import LMConfig
from repro_torch.models.moe import MoESpec


def _full() -> LMConfig:
    return LMConfig(
        name="olmoe-1b-7b", d_model=2048, vocab=50304, n_layers=16,
        pattern_unit=(("attn", "moe"),), n_units=16,
        attn=AttnSpec(n_heads=16, n_kv_heads=16, head_dim=128),
        moe=MoESpec(n_experts=64, top_k=8, d_ff=1024),
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="olmoe-1b-7b-reduced", d_model=64, vocab=512, n_layers=3,
        pattern_unit=(("attn", "moe"),), n_units=3,
        attn=AttnSpec(n_heads=4, n_kv_heads=4, head_dim=16),
        moe=MoESpec(n_experts=8, top_k=2, d_ff=48, capacity_factor=4.0), remat=False,
    )


ARCH = ArchDef("olmoe-1b-7b", "moe", _full(), reduced, "arXiv:2409.02060")
