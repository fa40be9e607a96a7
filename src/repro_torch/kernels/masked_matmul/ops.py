"""Public wrapper for the sparsity-aware fixed-point matmul (port of
``repro/kernels/masked_matmul/ops.py``).

``masked_matmul`` dispatches on the operands' device: CUDA tensors launch
the hand-written kernel in ``csrc/masked_matmul.cu`` (per-tile occupancy,
then the tile-gated product with its SR epilogue) or raise; CPU tensors
run the plain version in ``ref.py``.  There is no availability-based
pick: a CUDA tensor never falls back to the plain version.

The kernel tiles at 64 x 64 x 32; :func:`tile_skip_fraction` keeps
reporting at the reference's 128 granularity so the two packages'
numbers compare.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.masked_matmul.ref import (
    BK,
    BM,
    BN,
    masked_matmul_reference,
    padded_dims,
)

__all__ = ["masked_matmul", "masked_matmul_reference", "padded_dims",
           "tile_skip_fraction", "tile_occupancy",
           "tile_occupancy_reference", "kernel_tiles", "BM", "BN", "BK"]

_c_int, _c_float, _c_ptr = ctypes.c_int, ctypes.c_float, ctypes.c_void_p


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda.load("masked_matmul")
    lib.tile_occupancy_launch.argtypes = [_c_ptr, _c_int, _c_int, _c_int, _c_int,
                                          _c_ptr, _c_ptr]
    lib.tile_occupancy_launch.restype = _c_int
    lib.masked_matmul_launch.argtypes = [
        _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_int,
        ctypes.c_uint, _c_int, _c_float, _c_float, _c_float, _c_float, _c_ptr]
    lib.masked_matmul_launch.restype = _c_int
    lib.masked_matmul_tiles.argtypes = [ctypes.POINTER(_c_int)]
    lib.masked_matmul_tiles.restype = None
    return lib


@functools.cache
def kernel_tiles() -> tuple[int, int, int]:
    """(BM, BN, BK) of the built CUDA kernel."""
    out = (_c_int * 3)()
    _lib().masked_matmul_tiles(out)
    return out[0], out[1], out[2]


def _occupancy(a: torch.Tensor, tm: int, tn: int) -> torch.Tensor:
    """(M, N) with M % tm == N % tn == 0 -> (M/tm, N/tn) int32 any-nonzero."""
    m, n = a.shape
    t = a.reshape(m // tm, tm, n // tn, tn)
    return (t != 0.0).any(dim=3).any(dim=1).to(torch.int32)


def tile_occupancy_reference(a: torch.Tensor, tile_rows: int, tile_cols: int) -> torch.Tensor:
    """Plain version of :func:`tile_occupancy`: zero-pad to whole tiles,
    then one any-nonzero flag per tile."""
    rows, cols = a.shape
    pad = (0, -(-cols // tile_cols) * tile_cols - cols, 0, -(-rows // tile_rows) * tile_rows - rows)
    return _occupancy(torch.nn.functional.pad(a.to(torch.float32), pad), tile_rows, tile_cols)


def tile_occupancy(a: torch.Tensor, tile_rows: int, tile_cols: int) -> torch.Tensor:
    """(R, C) -> (ceil(R/tile_rows), ceil(C/tile_cols)) int32 any-nonzero
    flags (the ragged edge counts as zero).  A contiguous fp32 CUDA tensor
    launches ``tile_occupancy_kernel``, one block per tile (and counts one
    launch); a CPU tensor runs :func:`tile_occupancy_reference`."""
    if not a.is_cuda:
        return tile_occupancy_reference(a, tile_rows, tile_cols)
    if not (a.dtype == torch.float32 and a.ndim == 2 and a.is_contiguous()):
        raise ValueError("tile_occupancy: needs a contiguous 2-D fp32 tensor, got "
                         f"{a.dtype} {tuple(a.shape)}")
    rows, cols = a.shape
    occ = torch.empty((-(-rows // tile_rows), -(-cols // tile_cols)), dtype=torch.int32,
                      device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    cuda.check(_lib().tile_occupancy_launch(a.data_ptr(), rows, cols, tile_rows, tile_cols,
                                            occ.data_ptr(), stream), "tile_occupancy")
    tile_occupancy.launches += 1
    return occ


#: kernel launches made by this wrapper (two per ``masked_matmul`` launch)
tile_occupancy.launches = 0


def tile_skip_fraction(x: torch.Tensor, w: torch.Tensor,
                       tiles: tuple[int, int, int] = (BM, BN, BK)) -> float:
    """Fraction of (i, j, k) tile steps skipped for these operands, at the
    reference's 128 tiles unless ``tiles`` = (BM, BN, BK) says otherwise."""
    tm, tn, tk = tiles
    x_occ = tile_occupancy_reference(x, tm, tk).to(torch.float32)
    w_occ = tile_occupancy_reference(w, tk, tn).to(torch.float32)
    issued = float((x_occ @ w_occ).sum())
    total = x_occ.shape[0] * w_occ.shape[0] * w_occ.shape[1]
    return 1.0 - issued / total


def _launch(x: torch.Tensor, w: torch.Tensor, seed: int, il: int, fl: int,
            apply_sr: bool) -> torch.Tensor:
    if w.device != x.device:
        raise ValueError(f"masked_matmul: x on {x.device}, w on {w.device}")
    x = x.to(torch.float32).contiguous()
    w = w.to(torch.float32).contiguous()
    m, k = x.shape
    n = w.shape[1]
    if min(m, n, k) == 0 or max(m, n, k) >= 2**31:
        raise ValueError(f"masked_matmul: unsupported shape ({m},{k}) @ ({k},{n})")
    lib = _lib()
    tm, tn, tk = kernel_tiles()
    _, n_pad, _ = padded_dims(m, n, k)
    with torch.cuda.device(x.device):
        x_occ = tile_occupancy(x, tm, tk)
        w_occ = tile_occupancy(w, tk, tn)
        out = torch.empty((m, n), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        eps = 2.0**-fl
        cuda.check(lib.masked_matmul_launch(
            x.data_ptr(), w.data_ptr(), x_occ.data_ptr(), w_occ.data_ptr(),
            out.data_ptr(), m, n, k, n_pad, int(seed) & 0xFFFFFFFF, int(apply_sr),
            2.0**fl, eps, -(2.0**il), 2.0**il - eps, stream), "masked_matmul")
    masked_matmul.launches += 1
    return out


def masked_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    seed: int = 0,
    *,
    il: int = 4,
    fl: int = 16,
    apply_sr: bool = True,
) -> torch.Tensor:
    """Sparsity-aware ``x @ w`` on the Q(il,fl) grid with SR epilogue.

    x: (M, K) grid values (zeros are skippable); w: (K, N).  CUDA operands
    launch the kernel (and count one launch); CPU operands run
    :func:`masked_matmul_reference`.
    """
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"masked_matmul: bad shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.is_cuda:
        return _launch(x, w, seed, il, fl, apply_sr)
    return masked_matmul_reference(x, w, seed, il=il, fl=fl, apply_sr=apply_sr)


#: kernel launches made by this wrapper (the CPU path counts nothing)
masked_matmul.launches = 0
