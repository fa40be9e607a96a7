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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CHUNK = 128


def ssd_scan_reference(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor) -> torch.Tensor:
    """Sequential evaluation of h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,
    y_t = C_t h_t, one token at a time."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    group = h // g
    bf = b.repeat_interleave(group, dim=2).to(torch.float32)  # (B,S,H,N)
    cf = c.repeat_interleave(group, dim=2).to(torch.float32)
    xf, dtf = x.to(torch.float32), dt.to(torch.float32)
    state = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
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
    g, n = b.shape[2], b.shape[3]
    group = h // g
    pad = (-s) % CHUNK
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    sp = s + pad
    nc = sp // CHUNK

    xf = x.to(torch.float32).reshape(bsz, nc, CHUNK, h, p)
    dtf = dt.to(torch.float32).reshape(bsz, nc, CHUNK, h)
    bf = b.to(torch.float32).reshape(bsz, nc, CHUNK, g, n).repeat_interleave(group, dim=3)
    cf = c.to(torch.float32).reshape(bsz, nc, CHUNK, g, n).repeat_interleave(group, dim=3)

    da = dtf * a[None, None, None, :]  # (B,NC,L,H)
    cum = torch.cumsum(da, dim=2)

    # intra-chunk dual form; the exponent is masked, not the exp: the upper
    # triangle's positive diffs would overflow exp to inf and make inf * 0
    scores = torch.einsum("bclhn,bcjhn->bchlj", cf, bf)
    cum_h = cum.movedim(3, 2)  # (B,NC,H,L)
    diff = cum_h[..., :, None] - cum_h[..., None, :]  # (B,NC,H,L,L)
    tril = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool, device=x.device))
    w = torch.exp(torch.where(tril, diff, torch.full((), -torch.inf, device=x.device)))
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
    y = (y_intra + y_inter).reshape(bsz, sp, h, p)[:, :s].to(x.dtype)
    if return_state:
        return y, h_state
    return y
