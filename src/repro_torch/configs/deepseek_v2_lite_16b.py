"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H (MLA kv_lora=512)
per-expert d_ff=1408 vocab=102400, 64 routed experts top-6 + 2 shared,
first layer dense MLP (d_ff=10944) [arXiv:2405.04434; hf].  Copied from
``repro/configs/deepseek_v2_lite_16b.py``."""
from repro_torch.configs.base import ArchDef
from repro_torch.models.attention import MLASpec
from repro_torch.models.lm import LMConfig
from repro_torch.models.moe import MoESpec


def _full() -> LMConfig:
    return LMConfig(
        name="deepseek-v2-lite-16b", d_model=2048, vocab=102400, n_layers=27,
        prefix=(("mla", "swiglu"),),          # layer 0: dense MLP
        pattern_unit=(("mla", "moe"),), n_units=26,
        mla=MLASpec(n_heads=16, kv_lora_rank=512, qk_nope_dim=128,
                    qk_rope_dim=64, v_head_dim=128),
        moe=MoESpec(n_experts=64, top_k=6, d_ff=1408, n_shared=2, shared_d_ff=1408),
        d_ff=10944,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="deepseek-v2-lite-16b-reduced", d_model=64, vocab=512, n_layers=3,
        prefix=(("mla", "swiglu"),),
        pattern_unit=(("mla", "moe"),), n_units=2,
        mla=MLASpec(n_heads=4, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
                    v_head_dim=16),
        moe=MoESpec(n_experts=8, top_k=2, d_ff=48, n_shared=2, shared_d_ff=48,
                    capacity_factor=4.0),
        d_ff=160, remat=False,
    )


ARCH = ArchDef("deepseek-v2-lite-16b", "moe", _full(), reduced, "arXiv:2405.04434")
