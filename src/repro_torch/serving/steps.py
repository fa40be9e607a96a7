"""Serving step builders (port of ``repro/serving/steps.py``).

The reference jit-compiles these; PyTorch runs them eagerly (parameters
carry no gradients, so no autograd graph is built).  Both take the
numerics ``SpringConfig`` and return closures over the model config.
"""

from __future__ import annotations

from repro_torch.models import lm as lm_mod
from repro_torch.models.layers import SpringContext


def make_prefill_step(cfg, spring):
    def prefill(params, tokens):
        return lm_mod.lm_prefill(params, cfg, tokens, SpringContext(cfg=spring))
    return prefill


def make_decode_step(cfg, spring):
    def decode(params, tokens, cache):
        return lm_mod.lm_decode_step(params, cfg, tokens, cache, SpringContext(cfg=spring))
    return decode
