"""Chunked cross-entropy (port of ``repro/models/losses.py``): the
(tokens x vocab) logits tensor never materializes whole.

The sequence is cut into chunks of :data:`LOSS_CHUNK` positions (the last,
shorter one separately, as the reference does: seq-1 is rarely a multiple
of it).  Each chunk's logits are recomputed in the backward pass
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``), so the
live logits are one chunk's ``B x chunk x V``.  The head product is a
plain ``torch.matmul``, as the reference's einsum runs outside any kernel;
the entry points keep TF32 off on the card.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

LOSS_CHUNK = 512


def _chunk_ce(h_blk: torch.Tensor, y_blk: torch.Tensor, w_vocab: torch.Tensor,
              logits_dtype: torch.dtype) -> torch.Tensor:
    logits = torch.matmul(h_blk.to(logits_dtype), w_vocab.to(logits_dtype)).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y_blk[..., None])[..., 0]
    return (lse - gold).sum()


def _checkpointed(h_blk, y_blk, w_vocab, logits_dtype):
    if torch.is_grad_enabled() and (h_blk.requires_grad or w_vocab.requires_grad):
        return torch.utils.checkpoint.checkpoint(_chunk_ce, h_blk, y_blk, w_vocab,
                                                 logits_dtype, use_reentrant=False)
    return _chunk_ce(h_blk, y_blk, w_vocab, logits_dtype)


def chunked_softmax_xent(
    h: torch.Tensor,  # (B, N, d) final hidden states (pre-head)
    labels: torch.Tensor,  # (B, N) integer
    w_vocab: torch.Tensor,  # (d, V)
    chunk: int = LOSS_CHUNK,
    logits_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Sum of token cross-entropies (the caller normalizes).

    ``logits_dtype=torch.bfloat16`` computes the head product in bf16; the
    log-sum-exp stays fp32."""
    n = h.shape[1]
    labels = labels.to(torch.int64)
    c = min(chunk, n)
    n_full, rem = n // c, n % c
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_full):
        total = total + _checkpointed(h[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c],
                                      w_vocab, logits_dtype)
    if rem:
        total = total + _checkpointed(h[:, n_full * c:], labels[:, n_full * c:], w_vocab,
                                      logits_dtype)
    return total
