"""Plain PyTorch versions of the SSD scan (port of
``repro/kernels/ssd_scan/ref.py``, the sequential oracle, and of
``ssd_scan_jnp`` in ``repro/kernels/ssd_scan/ops.py``, the chunked form).

Shapes: x (B, S, H, P), dt (B, S, H), a (H,) negative, b/c (B, S, G, N)
with H % G == 0 (head h reads group h // (H / G)).

``ssd_scan_chunked`` is the math of the CUDA kernel and of the Pallas
kernel: per 128-step chunk the decay-masked ``C·Bᵀ`` intra-chunk form,
plus ``exp(cum)·C@h0`` from the state entering the chunk; the (N, P)
state is carried across chunks.  It is what the ``ssd_scan`` wrapper runs
for CPU tensors and what the kernel is held against on the card.  A ragged
S is padded with zeros (dt = 0 decays by exp(0) = 1 and adds nothing), so
the final state is exactly the state at position S.

The CUDA kernel runs the same math as four stages (the chunked
decomposition of the Mamba-2 authors' kernels), and each has a plain
version here that the card's stage kernels are held against:

  1. :func:`ssd_chunk_scores` — ``C·Bᵀ`` once per group and chunk over the
     live pairs j <= t;
  2. :func:`ssd_chunk_state` — the cumulative log decay of each chunk and
     the chunk's own (N, P) state;
  3. :func:`ssd_state_passing` — the in-order scan over the chunks: the
     state entering each chunk, and the final state;
  4. :func:`ssd_chunk_scan` — y from the scores, the decays, x and the
     state entering the chunk.

Composed, they give :func:`ssd_scan_chunked`'s y and final state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CHUNK = 128


def _chunked(t: torch.Tensor) -> torch.Tensor:
    """(B, S, ...) -> fp32 (B, NC, CHUNK, ...), the ragged tail read as zeros."""
    pad = (-t.shape[1]) % CHUNK
    if pad:
        t = F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
    return t.to(torch.float32).reshape(t.shape[0], -1, CHUNK, *t.shape[2:])


def _tril(device) -> torch.Tensor:
    return torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool, device=device))


def ssd_scan_reference(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor) -> torch.Tensor:
    """Sequential evaluation of h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,
    y_t = C_t h_t, one token at a time, in fp32 (in float64 for float64
    inputs)."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    group = h // g
    ft = torch.promote_types(x.dtype, torch.float32)
    bf = b.repeat_interleave(group, dim=2).to(ft)  # (B,S,H,N)
    cf = c.repeat_interleave(group, dim=2).to(ft)
    xf, dtf, a = x.to(ft), dt.to(ft), a.to(ft)
    state = torch.zeros((bsz, h, n, p), dtype=ft, device=x.device)
    ys = []
    for t in range(s):
        alpha = torch.exp(dtf[:, t] * a[None, :])  # (B,H)
        state = state * alpha[..., None, None] + torch.einsum(
            "bhn,bhp->bhnp", bf[:, t] * dtf[:, t, :, None], xf[:, t])
        ys.append(torch.einsum("bhn,bhnp->bhp", cf[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_scan_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     c: torch.Tensor, return_state: bool = False):
    """Chunked SSD (chunks of CHUNK steps), vectorized over (B, H); with
    ``return_state`` also the final (B, H, N, P) fp32 state."""
    bsz, s, h, p = x.shape
    n = b.shape[3]
    group = h // b.shape[2]
    xf, dtf = _chunked(x), _chunked(dt)  # (B,NC,L,H,P), (B,NC,L,H)
    bf = _chunked(b).repeat_interleave(group, dim=3)  # (B,NC,L,H,N)
    cf = _chunked(c).repeat_interleave(group, dim=3)
    nc = xf.shape[1]

    da = dtf * a[None, None, None, :]  # (B,NC,L,H)
    cum = torch.cumsum(da, dim=2)

    # intra-chunk dual form; the exponent is masked, not the exp: the upper
    # triangle's positive diffs would overflow exp to inf and make inf * 0
    scores = torch.einsum("bclhn,bcjhn->bchlj", cf, bf)
    cum_h = cum.movedim(3, 2)  # (B,NC,H,L)
    diff = cum_h[..., :, None] - cum_h[..., None, :]  # (B,NC,H,L,L)
    w = torch.exp(torch.where(_tril(x.device), diff, torch.full((), -torch.inf, device=x.device)))
    dt_h = dtf.movedim(3, 2)  # (B,NC,H,L)
    s_mat = scores * w * dt_h[..., None, :]
    y_intra = torch.einsum("bchlj,bcjhp->bclhp", s_mat, xf)

    # chunk states and the cross-chunk scan
    decay_end = torch.exp(cum_h[..., -1:] - cum_h)  # (B,NC,H,L)
    chunk_state = torch.einsum("bclhn,bchl,bclhp->bchnp", bf, decay_end * dt_h, xf)
    chunk_decay = torch.exp(cum_h[..., -1])  # (B,NC,H)
    h_state = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    h_prevs = []
    for ci in range(nc):
        h_prevs.append(h_state)
        h_state = h_state * chunk_decay[:, ci, :, None, None] + chunk_state[:, ci]
    h_prev = torch.stack(h_prevs, dim=1)  # (B,NC,H,N,P): state entering each chunk

    y_inter = torch.einsum("bclhn,bchnp->bclhp", cf, h_prev) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(bsz, -1, h, p)[:, :s].to(x.dtype)
    if return_state:
        return y, h_state
    return y


# -- the four stages ---------------------------------------------------------------


def ssd_chunk_scores(b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Stage 1: ``cb`` (B, NC, G, L, L) fp32, ``cb[.., t, j] = C_t · B_j`` of
    each chunk for j <= t and 0 above the diagonal.  It depends on the
    group alone, so it is computed once for all the group's heads."""
    cf, bf = _chunked(c), _chunked(b)  # (B,NC,L,G,N)
    cb = torch.einsum("bctgn,bcjgn->bcgtj", cf, bf)
    return torch.where(_tril(b.device), cb, torch.zeros((), device=b.device))


def ssd_chunk_state(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor) -> tuple:
    """Stage 2: ``(chunk_state, cum)``.  ``cum`` (B, NC, H, L) is the
    inclusive cumulative sum of ``dt·a`` within each chunk;
    ``chunk_state`` (B, NC, H, N, P) is the chunk's own state,
    ``Σ_j B_j exp(cum_L − cum_j) dt_j x_jᵀ``."""
    h = x.shape[2]
    group = h // b.shape[2]
    xf, dtf = _chunked(x), _chunked(dt)  # (B,NC,L,H,P), (B,NC,L,H)
    bf = _chunked(b).repeat_interleave(group, dim=3)  # (B,NC,L,H,N)
    cum = torch.cumsum(dtf * a[None, None, None, :], dim=2).movedim(3, 2)  # (B,NC,H,L)
    decay_end = torch.exp(cum[..., -1:] - cum)
    chunk_state = torch.einsum("bclhn,bchl,bclhp->bchnp", bf, decay_end * dtf.movedim(3, 2), xf)
    return chunk_state, cum


def ssd_state_passing(chunk_state: torch.Tensor, cum: torch.Tensor) -> tuple:
    """Stage 3: ``(h_prev, final_state)``: ``h = h·exp(cum_L) + state_c``
    in chunk order from h = 0; ``h_prev`` (B, NC, H, N, P) is the state
    entering each chunk, ``final_state`` (B, H, N, P) the state after the
    last."""
    decay = torch.exp(cum[..., -1])  # (B,NC,H)
    h_state = torch.zeros_like(chunk_state[:, 0])
    h_prevs = []
    for ci in range(chunk_state.shape[1]):
        h_prevs.append(h_state)
        h_state = h_state * decay[:, ci, :, None, None] + chunk_state[:, ci]
    return torch.stack(h_prevs, dim=1), h_state


def ssd_chunk_scan(x: torch.Tensor, dt: torch.Tensor, c: torch.Tensor, cb: torch.Tensor,
                   cum: torch.Tensor, h_prev: torch.Tensor) -> torch.Tensor:
    """Stage 4: y (B, S, H, P) in x's dtype,
    ``y_t = exp(cum_t) C_t h_prev + Σ_{j<=t} cb[t, j] exp(cum_t − cum_j) dt_j x_j``,
    the exponent masked above the diagonal before the exp."""
    bsz, s, h, p = x.shape
    group = h // c.shape[2]
    xf, dtf = _chunked(x), _chunked(dt)
    cf = _chunked(c).repeat_interleave(group, dim=3)  # (B,NC,L,H,N)
    diff = cum[..., :, None] - cum[..., None, :]  # (B,NC,H,L,L)
    w = torch.exp(torch.where(_tril(x.device), diff, torch.full((), -torch.inf, device=x.device)))
    s_mat = cb.repeat_interleave(group, dim=2) * w * dtf.movedim(3, 2)[..., None, :]
    y_intra = torch.einsum("bchlj,bcjhp->bclhp", s_mat, xf)
    y_inter = (torch.einsum("bclhn,bchnp->bclhp", cf, h_prev)
               * torch.exp(cum).movedim(2, 3)[..., None])
    return (y_intra + y_inter).reshape(bsz, -1, h, p)[:, :s].to(x.dtype)
