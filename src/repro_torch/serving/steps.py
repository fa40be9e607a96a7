"""Serving step builders (port of ``repro/serving/steps.py``).

The reference jit-compiles these; PyTorch runs them eagerly (parameters
carry no gradients, so no autograd graph is built).  Both take the model
config, the numerics ``SpringConfig`` and the int8-cache flag, and return
closures; ``prune_ratio`` magnitude-prunes every dense projection's
weight at each call, as the reference's ``step_cfg.prune_ratio`` does
(the pruned weights are not cached).  An ``EncDecConfig`` (whisper) gets the encoder-decoder steps:
its prefill runs the encoder once, projects the cross K/V into a cache of
the prompt's length and takes the last position's logits from one
teacher-forced decoder pass, as the reference's does; the static serving
path never calls it (it builds the cache itself and decodes from the
prompt's first token).  A VLM's prefill takes its image embeddings.
"""

from __future__ import annotations

import torch

from repro_torch.models import encdec as ed_mod
from repro_torch.models import lm as lm_mod
from repro_torch.models.layers import SpringContext


def make_prefill_step(cfg, spring, int8_cache: bool = False, prune_ratio: float = 0.0):
    ctx = SpringContext(cfg=spring, prune_ratio=prune_ratio, int8_cache=int8_cache)
    if isinstance(cfg, ed_mod.EncDecConfig):
        def prefill(params, tokens, *, frames):
            enc = ed_mod.encode(params, cfg, frames, ctx)
            cache = ed_mod.cross_cache(params, cfg, enc, ctx, max_len=tokens.shape[1])
            h = ed_mod.decode_hidden(params, cfg, tokens, enc, ctx)
            logits = h[:, -1].to(torch.float32) @ params["embed"]["embedding"].t()
            return logits, cache
        return prefill

    def prefill(params, tokens, *, img_embeds=None):
        return lm_mod.lm_prefill(params, cfg, tokens, ctx, img_embeds)
    return prefill


def make_decode_step(cfg, spring, int8_cache: bool = False, prune_ratio: float = 0.0):
    step = (ed_mod.encdec_decode_step if isinstance(cfg, ed_mod.EncDecConfig)
            else lm_mod.lm_decode_step)
    ctx = SpringContext(cfg=spring, prune_ratio=prune_ratio, int8_cache=int8_cache)

    def decode(params, tokens, cache):
        return step(params, cfg, tokens, cache, ctx)
    return decode
