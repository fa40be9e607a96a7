"""Plain PyTorch version of flash attention (port of
``repro/kernels/flash_attention/ref.py``, the registry's oracle).

Dense fp32 softmax over every key with the causal and sliding-window
masks; rows with no live key output 0.  It is what the ``flash_attention``
wrapper runs for CPU tensors, and what the CUDA kernel is held against on
the card.  It sees only the real keys, so unlike the reference's padded
Pallas route it never lets a padded key into the softmax.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, HKV, Skv, D); fp32 dense softmax with
    scale 1/sqrt(D), the result in q's dtype."""
    _, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = h // hkv
    sm_scale = 1.0 / (d**0.5)
    kr = k.repeat_interleave(group, dim=1).to(torch.float32)
    vr = v.repeat_interleave(group, dim=1).to(torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(torch.float32), kr) * sm_scale
    q_idx = torch.arange(sq, device=q.device)[:, None]
    k_idx = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_idx >= k_idx
    if window is not None:
        mask &= k_idx > q_idx - window
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    # fully-masked rows (none, for causal with Sq <= Skv) -> zeros
    p = torch.where(mask.any(dim=-1)[None, None, :, None], p, torch.zeros((), device=q.device))
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)
