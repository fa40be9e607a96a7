"""mamba2-780m [ssm]: 48L d_model=1536 (attention-free) vocab=50280,
ssm_state=128 — SSD state-space duality [arXiv:2405.21060].
d_inner = 2*d = 3072, head_dim 64 -> 48 heads, 1 state group, tied
embeddings.  Copied from ``repro/configs/mamba2_780m.py``."""
from repro_torch.configs.base import ArchDef
from repro_torch.models.lm import LMConfig
from repro_torch.models.ssm import SSMSpec


def _full() -> LMConfig:
    return LMConfig(
        name="mamba2-780m", d_model=1536, vocab=50280, n_layers=48,
        pattern_unit=(("ssm", "none"),), n_units=48,
        ssm=SSMSpec(d_inner=3072, n_heads=48, d_state=128, n_groups=1),
        tie_embeddings=True,
    )


def reduced() -> LMConfig:
    return LMConfig(
        name="mamba2-780m-reduced", d_model=64, vocab=512, n_layers=4,
        pattern_unit=(("ssm", "none"),), n_units=4,
        ssm=SSMSpec(d_inner=128, n_heads=4, d_state=16, n_groups=1),
        tie_embeddings=True, remat=False,
    )


ARCH = ArchDef("mamba2-780m", "ssm", _full(), reduced, "arXiv:2405.21060")
