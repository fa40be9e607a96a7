"""whisper-medium [audio]: 24+24L enc-dec d_model=1024 16H d_ff=4096
vocab=51865 — conv/mel frontend is a STUB (precomputed frame embeddings)
[arXiv:2212.04356].  Copied from ``repro/configs/whisper_medium.py``."""
from repro_torch.configs.base import ArchDef
from repro_torch.models.encdec import EncDecConfig


def _full() -> EncDecConfig:
    return EncDecConfig(
        name="whisper-medium", d_model=1024, vocab=51865,
        n_enc_layers=24, n_dec_layers=24, n_heads=16, d_ff=4096, enc_seq=1500,
    )


def reduced() -> EncDecConfig:
    return EncDecConfig(
        name="whisper-medium-reduced", d_model=64, vocab=512,
        n_enc_layers=2, n_dec_layers=2, n_heads=4, d_ff=128, enc_seq=32,
        remat=False,
    )


ARCH = ArchDef("whisper-medium", "audio", _full(), reduced, "arXiv:2212.04356")
