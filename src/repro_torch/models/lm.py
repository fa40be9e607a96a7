"""Decoder-LM stack for serving (port of ``repro/models/lm.py``).

Covers the ``("attn", "swiglu")`` pattern (the llama family); other mixers
and FFNs raise ``NotImplementedError``.  The reference scans a stacked
``unit_0`` parameter tree; here the layers are a Python list of per-layer
dicts, walked in order.  Caches keep the reference's stacked layout,
``{"pos", "unit_0": {"k", "v"}}`` with leaves ``(n_units, B, S, KV, D)``,
so the packed slot pool is laid out exactly as the reference's.

The tied-embedding logits product stays ``torch.matmul`` in fp32: the
reference computes it outside any kernel too (``lm.py:412-415``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models.attention import AttnSpec
from repro_torch.models.layers import (
    SpringContext,
    dense_init,
    embed_apply,
    embed_init,
    rmsnorm_apply,
    rmsnorm_init,
    swiglu_apply,
    swiglu_init,
)

SUPPORTED_KIND = ("attn", "swiglu")


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    d_model: int
    vocab: int
    n_layers: int
    pattern_unit: tuple  # ((mixer, ffn), ...)
    n_units: int
    prefix: tuple = ()
    suffix: tuple = ()
    attn: Optional[AttnSpec] = None
    d_ff: int = 0
    norm: str = "rms"
    tie_embeddings: bool = False
    remat: bool = True  # training-only in the reference; kept for config parity

    def __post_init__(self):
        n = len(self.prefix) + len(self.pattern_unit) * self.n_units + len(self.suffix)
        if n != self.n_layers:
            raise ValueError(f"{self.name}: pattern covers {n} != {self.n_layers} layers")

    def check_supported(self) -> None:
        kinds = set(self.pattern_unit) | set(self.prefix) | set(self.suffix)
        if (kinds != {SUPPORTED_KIND} or self.prefix or self.suffix
                or self.norm != "rms" or self.n_units < 1):
            raise NotImplementedError(
                f"{self.name}: only a repeated {SUPPORTED_KIND} unit with rms norm "
                f"is ported (got pattern {self.pattern_unit}, prefix {self.prefix}, "
                f"suffix {self.suffix}, norm {self.norm})")

    @property
    def layer_kinds(self) -> list:
        """(unit index, position in unit) of every layer, in order."""
        return [(i, u) for i in range(self.n_units) for u in range(len(self.pattern_unit))]


def block_init(gen: torch.Generator, cfg: LMConfig, *, device=None) -> dict:
    return {
        "norm1": rmsnorm_init(cfg.d_model, device=device),
        "mixer": attn_mod.gqa_init(gen, cfg.d_model, cfg.attn, device=device),
        "norm2": rmsnorm_init(cfg.d_model, device=device),
        "ffn": swiglu_init(gen, cfg.d_model, cfg.d_ff, device=device),
    }


def block_apply(params: dict, x: torch.Tensor, ctx: SpringContext, cfg: LMConfig,
                positions: torch.Tensor, cache: Optional[dict] = None, pos=None,
                return_cache: bool = False):
    """Pre-norm residual block.  Returns (x, new_cache)."""
    h = rmsnorm_apply(params["norm1"], x)
    out, new_cache = attn_mod.gqa_apply(params["mixer"], h, ctx, cfg.attn, positions,
                                        cache, pos, return_cache)
    x = (x + out).to(x.dtype)
    h = rmsnorm_apply(params["norm2"], x)
    x = (x + swiglu_apply(params["ffn"], h, ctx)).to(x.dtype)
    return x, new_cache


def lm_init(cfg: LMConfig, seed: int = 0, *, device="cuda") -> dict:
    """Random parameters from ``seed`` on ``device`` (a ``torch.Generator``
    there; the values differ from the reference's ``jax.random`` ones — use
    :func:`repro_torch.convert.params_from_jax` to carry a JAX init across)."""
    cfg.check_supported()
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    params: dict = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, device=device),
        "final_norm": rmsnorm_init(cfg.d_model, device=device),
        "layers": [block_init(gen, cfg, device=device) for _ in cfg.layer_kinds],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab, device=device)
    return params


def _logits(params: dict, cfg: LMConfig, h: torch.Tensor) -> torch.Tensor:
    w = (params["embed"]["embedding"].t() if cfg.tie_embeddings
         else params["lm_head"]["kernel"])
    return torch.matmul(h.to(torch.float32), w.to(torch.float32))


def lm_init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  *, device=None) -> dict:
    cfg.check_supported()
    cache: dict = {"pos": torch.zeros((), dtype=torch.int64, device=device)}
    for u in range(len(cfg.pattern_unit)):
        one = attn_mod.gqa_init_cache(batch, cfg.attn, max_len, dtype, device=device)
        cache[f"unit_{u}"] = {name: leaf[None].repeat(cfg.n_units, *([1] * leaf.ndim))
                              for name, leaf in one.items()}
    return cache


def pad_cache(cache: dict, extra: int) -> dict:
    """Grow the k/v caches by ``extra`` decode positions (prefill builds
    caches sized to the prompt; decoding needs headroom)."""
    if extra <= 0:
        return cache
    out = dict(cache)
    for unit in (name for name in cache if name.startswith("unit_")):
        # leaves (n_units, B, S, KV, D): pad the seq axis, third from the end
        out[unit] = {name: torch.nn.functional.pad(leaf, (0, 0, 0, 0, 0, extra))
                     for name, leaf in cache[unit].items()}
    return out


def lm_prefill(params: dict, cfg: LMConfig, tokens: torch.Tensor,
               ctx: SpringContext) -> tuple[torch.Tensor, dict]:
    """Full forward over (B, S) tokens: last-position logits (B, V) and the
    serving cache (``pos`` = S)."""
    cfg.check_supported()
    x = embed_apply(params["embed"], tokens, ctx)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    per_unit: dict = {u: [] for u in range(len(cfg.pattern_unit))}
    for (_, u), p in zip(cfg.layer_kinds, params["layers"]):
        x, c = block_apply(p, x, ctx, cfg, positions, return_cache=True)
        per_unit[u].append(c)
    cache: dict = {"pos": torch.tensor(s, dtype=torch.int64, device=x.device)}
    for u, cs in per_unit.items():
        cache[f"unit_{u}"] = {name: torch.stack([c[name] for c in cs]) for name in cs[0]}
    x = rmsnorm_apply(params["final_norm"], x)
    return _logits(params, cfg, x[:, -1]), cache


def lm_decode_step(params: dict, cfg: LMConfig, tokens: torch.Tensor, cache: dict,
                   ctx: SpringContext) -> tuple[torch.Tensor, dict]:
    """One decode step over (B,) tokens.  ``cache["pos"]`` is a scalar or a
    per-row (B,) vector; returns (logits (B, V), updated cache)."""
    cfg.check_supported()
    pos = cache["pos"]
    x = embed_apply(params["embed"], tokens[:, None], ctx)
    b = x.shape[0]
    positions = (pos.reshape(-1, 1) if pos.ndim else pos).expand(b, 1)
    per_unit: dict = {u: [] for u in range(len(cfg.pattern_unit))}
    for (i, u), p in zip(cfg.layer_kinds, params["layers"]):
        layer_cache = {name: leaf[i] for name, leaf in cache[f"unit_{u}"].items()}
        x, c = block_apply(p, x, ctx, cfg, positions, layer_cache, pos)
        per_unit[u].append(c)
    new_cache: dict = {"pos": pos + 1}
    for u, cs in per_unit.items():
        new_cache[f"unit_{u}"] = {name: torch.stack([c[name] for c in cs]) for name in cs[0]}
    x = rmsnorm_apply(params["final_norm"], x)
    return _logits(params, cfg, x[:, 0]), new_cache
