"""Chunked cross-entropy (port of ``repro/models/losses.py``): the
(tokens x vocab) logits tensor never materializes whole.

The sequence is cut into chunks of :data:`LOSS_CHUNK` positions (the last,
shorter one separately, as the reference does: seq-1 is rarely a multiple
of it).  Each chunk's logits are recomputed in the backward pass
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``), so the
live logits are one chunk's ``B x chunk x V``.  The head product is a
plain ``torch.matmul``, as the reference's einsum runs outside any kernel;
the entry points keep TF32 off on the card.

Under a vocabulary split over ``model`` (``split``, the head's
``runtime.sharding.Split``; tensor parallelism) each rank holds the head's
columns ``[lo, hi)`` and computes those logits: the log-sum-exp takes the
cross-rank max and the cross-rank sum of ``exp(logit - max)``, the gold
logit is the one rank's that holds the label (the others add zero), all
summed in rank order so every rank holds the same loss
(:class:`_VocabParallelCE`); its backward is softmax minus one-hot on the
rank's columns.  The hidden states enter through
``dist.tensor.copy_to_model``, whose backward sums their gradient over
``model`` once for all chunks.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.dist.tensor import copy_to_model, model_mesh
from repro_torch.runtime.sharding import in_context

LOSS_CHUNK = 512


def _chunk_ce(h_blk: torch.Tensor, y_blk: torch.Tensor, w_vocab: torch.Tensor,
              logits_dtype: torch.dtype) -> torch.Tensor:
    logits = torch.matmul(h_blk.to(logits_dtype), w_vocab.to(logits_dtype)).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y_blk[..., None])[..., 0]
    return (lse - gold).sum()


class _VocabParallelCE(torch.autograd.Function):
    """Sum of token cross-entropies from (..., V/n) fp32 logits holding
    vocabulary columns ``[lo, lo + V/n)`` on each rank of ``model``."""

    @staticmethod
    def forward(ctx, logits, labels, mesh, lo):
        width = logits.shape[-1]
        m = mesh.all_reduce(logits.amax(dim=-1), "model", "max")
        sum_exp = mesh.all_reduce(torch.exp(logits - m[..., None]).sum(dim=-1), "model")
        lse = m + torch.log(sum_exp)
        local = labels - lo
        inside = (local >= 0) & (local < width)
        gold = torch.gather(logits, -1, local.clamp(0, width - 1)[..., None])[..., 0]
        gold = mesh.all_reduce(torch.where(inside, gold, torch.zeros((), device=gold.device)),
                               "model")
        ctx.save_for_backward(logits, lse, local, inside)
        return (lse - gold).sum()

    @staticmethod
    def backward(ctx, g):
        logits, lse, local, inside = ctx.saved_tensors
        grad = torch.exp(logits - lse[..., None])
        onehot = torch.zeros_like(grad).scatter_(-1, local.clamp(0, grad.shape[-1] - 1)[..., None],
                                                 inside[..., None].to(grad.dtype))
        return (grad - onehot) * g, None, None, None


def _chunk_ce_split(h_blk: torch.Tensor, y_blk: torch.Tensor, w_vocab: torch.Tensor,
                    logits_dtype: torch.dtype, lo: int) -> torch.Tensor:
    logits = torch.matmul(h_blk.to(logits_dtype), w_vocab.to(logits_dtype)).to(torch.float32)
    return _VocabParallelCE.apply(logits, y_blk, model_mesh(), lo)


def _checkpointed(h_blk, y_blk, w_vocab, logits_dtype, split=None):
    fn, args = ((_chunk_ce, (logits_dtype,)) if split is None
                else (_chunk_ce_split, (logits_dtype, split.lo)))
    if torch.is_grad_enabled() and (h_blk.requires_grad or w_vocab.requires_grad):
        return torch.utils.checkpoint.checkpoint(in_context(fn), h_blk, y_blk, w_vocab, *args,
                                                 use_reentrant=False)
    return fn(h_blk, y_blk, w_vocab, *args)


def chunked_softmax_xent(
    h: torch.Tensor,  # (B, N, d) final hidden states (pre-head)
    labels: torch.Tensor,  # (B, N) integer
    w_vocab: torch.Tensor,  # (d, V)
    chunk: int = LOSS_CHUNK,
    logits_dtype: torch.dtype = torch.float32,
    split=None,
) -> torch.Tensor:
    """Sum of token cross-entropies (the caller normalizes).

    ``logits_dtype=torch.bfloat16`` computes the head product in bf16; the
    log-sum-exp stays fp32.  ``split``: ``w_vocab`` holds the vocabulary
    columns of a split over ``model`` (the module docstring)."""
    n = h.shape[1]
    labels = labels.to(torch.int64)
    if split is not None:
        h = copy_to_model(h)
    c = min(chunk, n)
    n_full, rem = n // c, n % c
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_full):
        total = total + _checkpointed(h[:, i * c:(i + 1) * c], labels[:, i * c:(i + 1) * c],
                                      w_vocab, logits_dtype, split)
    if rem:
        total = total + _checkpointed(h[:, n_full * c:], labels[:, n_full * c:], w_vocab,
                                      logits_dtype, split)
    return total
