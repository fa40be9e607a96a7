"""Plain PyTorch version of the masked matmul kernel (port of
``repro/kernels/masked_matmul/ref.py``).

Dense fp32 product of the same operands + the identical SR epilogue (same
counters, same hash).  Tile skipping must not change results, so this
version skips nothing.  It is what the ``masked_matmul`` wrapper runs for
CPU tensors, and what the CUDA kernel is held against on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.prng import hash_uint32, uniform_from_bits

#: the reference kernel's MXU tile; the SR counter's row stride is N
#: padded to it (mm_kernel.py:85), whatever tile the CUDA kernel uses
BM = BN = BK = 128


def padded_dims(m: int, n: int, k: int) -> tuple[int, int, int]:
    def up(d, t):
        return -(-d // t) * t

    return up(m, BM), up(n, BN), up(k, BK)


def sr_epilogue(y: torch.Tensor, seed: int, *, il: int = 4, fl: int = 16,
                n_pad: int | None = None) -> torch.Tensor:
    """The kernel's SR epilogue on an (M, N) fp32 product: counter
    ``row * n_pad + col``, ``n_pad`` defaulting to N rounded up to 128."""
    m, n = y.shape
    if n_pad is None:
        _, n_pad, _ = padded_dims(m, n, 1)
    eps = 2.0**-fl
    min_v, max_v = -(2.0**il), 2.0**il - eps
    xc = torch.clamp(y, min_v, max_v)
    scaled = xc * (2.0**fl)
    lo = torch.floor(scaled)
    frac = scaled - lo
    gi = torch.arange(m, dtype=torch.int64, device=y.device)[:, None]
    gj = torch.arange(n, dtype=torch.int64, device=y.device)[None, :]
    counter = gi * n_pad + gj  # hash_uint32 takes it mod 2**32, as uint32 wraps
    u = uniform_from_bits(hash_uint32(counter, seed))
    rounded = lo + (u < frac).to(torch.float32)
    return torch.clamp(rounded * eps, min_v, max_v)


def masked_matmul_reference(
    x: torch.Tensor,
    w: torch.Tensor,
    seed: int = 0,
    *,
    il: int = 4,
    fl: int = 16,
    apply_sr: bool = True,
) -> torch.Tensor:
    y = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    if not apply_sr:
        return y
    return sr_epilogue(y, seed, il=il, fl=fl)


def splitk_reduce_reference(partial: torch.Tensor, seed: int = 0, *, il: int = 4,
                            fl: int = 16, apply_sr: bool = False) -> torch.Tensor:
    """Plain version of the split-K reduce: (chunks, M, N) partial sums ->
    (M, N), added in chunk order (the kernel's order, so the two agree
    bit for bit), then the SR epilogue when ``apply_sr``."""
    y = partial[0].clone()
    for c in range(1, partial.shape[0]):
        y += partial[c]
    return sr_epilogue(y, seed, il=il, fl=fl) if apply_sr else y
