"""Public wrapper for the sparsity-aware fixed-point matmul (port of
``repro/kernels/masked_matmul/ops.py``).

``masked_matmul`` dispatches on the operands' device: CUDA tensors launch
one of the two hand-written kernels in ``csrc/masked_matmul.cu`` or
raise; CPU tensors run the plain version in ``ref.py``.  There is no
availability-based pick: a CUDA tensor never falls back to the plain
version, and neither kernel falls back to the other.

:func:`route` picks the kernel from the shape alone: M <= :data:`SKINNY_M`
(decode ticks, short prompts, VGG-19's fc layers) goes to the skinny
kernel, which streams the weight and flags x's empty K-tiles itself;
every other M goes to the tile kernel, after the ``tile_occupancy``
pre-pass of both operands.  The two give the same bits on the same row.

Both kernels read each operand row-major or column-major in place, so the
backward GEMMs (``backward.py``) pass ``w.T`` and ``x.T`` as views.  They
split K into chunks of :data:`SPLIT_K` when K is longer than that (a
split that depends on K alone, reduced in a fixed order by a third
kernel, :func:`splitk_reduce`).  ``backward=`` routes the call through
the sparsity-aware autograd Function of ``backward.py``.

Occupancy flags and recorded tile steps are at :data:`KERNEL_TILES`
(64 x 64 x 32); :func:`tile_skip_fraction` keeps reporting at the
reference's 128 granularity so the two packages' numbers compare.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from repro_torch.core import masking
from repro_torch.kernels import cuda, registry
from repro_torch.kernels.masked_matmul.ref import (
    BK,
    BM,
    BN,
    masked_matmul_reference,
    padded_dims,
    splitk_reduce_reference,
)

__all__ = ["masked_matmul", "masked_matmul_reference", "padded_dims",
           "tile_skip_fraction", "tile_occupancy", "tile_occupancy_reference",
           "splitk_reduce", "splitk_reduce_reference", "split_k",
           "record_tile_skip", "route", "launch", "launch_skinny", "launch_tile",
           "KERNEL_TILES", "SKINNY_M", "SPLIT_K", "BM", "BN", "BK"]

_c_int, _c_float, _c_ptr, _c_ll = ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_longlong

#: (rows, columns, depth) of the occupancy flags: a's flags are rows x
#: depth, b's depth x columns; depth is both kernels' K-step, and tile steps
#: are recorded at these tiles (checked against the library)
KERNEL_TILES = (64, 64, 32)
#: M up to this takes the skinny kernel: near the fp32 ridge (67 TFLOP/s
#: over 3.35 TB/s, about 20 FLOPs per byte; 2 M FLOPs per 4-byte weight)
SKINNY_M = 32
#: K longer than this is split into chunks of this length (a multiple of BK)
SPLIT_K = 8192


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda.load("masked_matmul")
    lib.tile_occupancy_launch.argtypes = [_c_ptr, _c_int, _c_int, _c_int, _c_int,
                                          _c_ptr, _c_ptr]
    lib.tile_occupancy_launch.restype = _c_int
    lib.masked_matmul_launch.argtypes = [
        _c_ptr, _c_ll, _c_int, _c_ptr, _c_ll, _c_int,      # a, lda, a_col, b, ldb, b_col
        _c_ptr, _c_ll, _c_ll, _c_ptr, _c_ll, _c_ll,        # a_occ + strides, b_occ + strides
        _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_int, _c_int,  # out, partial, m n k, chunks
        _c_int, ctypes.c_uint, _c_int, _c_float, _c_float, _c_float, _c_float, _c_ptr]
    lib.masked_matmul_launch.restype = _c_int
    lib.masked_matmul_skinny_launch.argtypes = [
        _c_ptr, _c_ll, _c_int, _c_ptr, _c_ll, _c_int,      # a, lda, a_col, b, ldb, b_col
        _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_int, _c_int,  # out, partial, m n k, chunks
        _c_int, ctypes.c_uint, _c_int, _c_float, _c_float, _c_float, _c_float, _c_ptr]
    lib.masked_matmul_skinny_launch.restype = _c_int
    lib.splitk_reduce_launch.argtypes = [
        _c_ptr, _c_ptr, _c_int, _c_int, _c_int, _c_int, ctypes.c_uint, _c_int,
        _c_float, _c_float, _c_float, _c_float, _c_ptr]
    lib.splitk_reduce_launch.restype = _c_int
    lib.masked_matmul_config.argtypes = [ctypes.POINTER(_c_int)]
    lib.masked_matmul_config.restype = None
    conf = (_c_int * 5)()
    lib.masked_matmul_config(conf)
    want = (*KERNEL_TILES, SKINNY_M, SPLIT_K // KERNEL_TILES[2])
    if tuple(conf) != want:
        raise cuda.KernelBuildError(f"masked_matmul built with (flag tiles, SKINNY_M, chunk "
                                    f"tiles) {tuple(conf)}, the wrapper expects {want}")
    return lib


@functools.cache
def _epilogue(il: int, fl: int) -> tuple:
    """The SR epilogue's (2^fl, eps, min, max) on Q(il, fl) as C floats,
    converted once: ctypes converting four Python floats at every launch
    costs host time that a short launch does not hide."""
    eps = 2.0**-fl
    return tuple(ctypes.c_float(v) for v in (2.0**fl, eps, -(2.0**il), 2.0**il - eps))


def split_k(k: int) -> tuple[int, int]:
    """(K-tiles per chunk, chunks) for a reduction of length ``k``: one
    chunk up to :data:`SPLIT_K`, else chunks of :data:`SPLIT_K`.  A
    function of K alone, so a row's sums never depend on M or N."""
    bk = KERNEL_TILES[2]
    if k <= SPLIT_K:
        return -(-k // bk), 1
    return SPLIT_K // bk, -(-k // SPLIT_K)


def tile_occupancy_reference(a: torch.Tensor, tile_rows: int, tile_cols: int) -> torch.Tensor:
    """Plain version of :func:`tile_occupancy`: zero-pad to whole tiles,
    then one any-nonzero flag per tile."""
    rows, cols = a.shape
    pad = (0, -(-cols // tile_cols) * tile_cols - cols, 0, -(-rows // tile_rows) * tile_rows - rows)
    padded = torch.nn.functional.pad(a.to(torch.float32), pad)
    return masking.tile_occupancy(padded, tile_rows, tile_cols).to(torch.int32)


def tile_occupancy(a: torch.Tensor, tile_rows: int, tile_cols: int) -> torch.Tensor:
    """(R, C) -> (ceil(R/tile_rows), ceil(C/tile_cols)) int32 any-nonzero
    flags (the ragged edge counts as zero).  A contiguous fp32 CUDA tensor
    launches ``tile_occupancy_kernel``, one block per row of tiles across
    8 column tiles (and counts one launch); a CPU tensor runs
    :func:`tile_occupancy_reference`."""
    if not a.is_cuda:
        return tile_occupancy_reference(a, tile_rows, tile_cols)
    if not (a.dtype == torch.float32 and a.ndim == 2 and a.is_contiguous()):
        raise ValueError("tile_occupancy: needs a contiguous 2-D fp32 tensor, got "
                         f"{a.dtype} {tuple(a.shape)}")
    rows, cols = a.shape
    occ = torch.empty((-(-rows // tile_rows), -(-cols // tile_cols)), dtype=torch.int32,
                      device=a.device)
    if -(-occ.shape[1] // 8) > 65535:  # groups of 8 column tiles on grid y
        raise ValueError(f"tile_occupancy: {occ.shape[1]} column tiles exceed the grid")
    cuda.check(_lib().tile_occupancy_launch(a.data_ptr(), rows, cols, tile_rows, tile_cols,
                                            occ.data_ptr(), cuda.stream(a.device)),
               "tile_occupancy")
    tile_occupancy.launches += 1
    return occ


#: kernel launches made by this wrapper (two per tile-kernel product)
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


# -- tile-skip recording ------------------------------------------------------

_SKIP: dict | None = None


@contextlib.contextmanager
def record_tile_skip():
    """Inside the block, every product (forward, dx, dw) adds its issued
    and total (i, j, k) tile steps at the kernel's tiles to the yielded
    ``{op: [issued, total]}``.  Each record costs a small product of the
    occupancy flags and a host sync, so it is off unless asked for."""
    global _SKIP
    prev, _SKIP = _SKIP, {}
    try:
        yield _SKIP
    finally:
        _SKIP = prev


def _note_skip(op: str, a_occ: torch.Tensor, b_occ: torch.Tensor) -> None:
    issued = float((a_occ.to(torch.float32) @ b_occ.to(torch.float32)).sum())
    row = _SKIP.setdefault(op, [0.0, 0.0])
    row[0] += issued
    row[1] += a_occ.shape[0] * a_occ.shape[1] * b_occ.shape[1]


def note_plain(op: str, a: torch.Tensor, b: torch.Tensor) -> None:
    """Record the tile steps of a plain-version product ``a @ b`` at the
    kernel's tiles, when :func:`record_tile_skip` is active."""
    if _SKIP is not None:
        tm, tn, tk = KERNEL_TILES
        _note_skip(op, tile_occupancy_reference(a, tm, tk), tile_occupancy_reference(b, tk, tn))


# -- the kernels --------------------------------------------------------------


def route(m: int, n: int, k: int) -> str:
    """The kernel for an (m, k) @ (k, n) product: ``"skinny"`` for
    m <= :data:`SKINNY_M`, else ``"tile"``, for either operand layout.  A
    function of the shape alone; both kernels give the same bits."""
    if min(m, n, k) <= 0:
        raise ValueError(f"masked_matmul: no kernel for ({m},{k}) @ ({k},{n})")
    return "skinny" if m <= SKINNY_M else "tile"


def _layout(a: torch.Tensor):
    """(tensor, leading dim, column-major?) of one operand, read in place
    when it is row- or column-major."""
    if a.dtype != torch.float32:
        a = a.to(torch.float32)
    if not a.is_contiguous() and a.t().is_contiguous():
        return a, a.shape[0], 1
    a = a.contiguous()
    return a, a.shape[1], 0


def _flags(a: torch.Tensor, col: int, tile_rows: int, tile_cols: int) -> torch.Tensor:
    """Occupancy flags of a laid-out operand; a transposed operand's are
    the transposed flags of its untransposed self."""
    if col:
        return tile_occupancy(a.t(), tile_cols, tile_rows).t()
    return tile_occupancy(a, tile_rows, tile_cols)


def _checked_shape(a: torch.Tensor, b: torch.Tensor, op: str) -> tuple[int, int, int]:
    if b.device != a.device:
        raise ValueError(f"{op}: a on {a.device}, b on {b.device}")
    m, k = a.shape
    n = b.shape[1]
    chunks = split_k(k)[1]
    if min(m, n, k) == 0 or max(m, n, k) >= 2**31 or -(-n // KERNEL_TILES[1]) > 65535 \
            or chunks > 65535 or chunks * m * n >= 2**62:
        raise ValueError(f"{op}: unsupported shape ({m},{k}) @ ({k},{n})")
    return m, n, k


def _run(kernel: str, a, b, seed: int, il: int, fl: int, apply_sr: bool, op: str,
         launch_fn) -> torch.Tensor:
    """The shared frame of both kernels: shape checks, layouts, output and
    split-K buffers, the kernel's launch through ``launch_fn(a, lda,
    a_col, b, ldb, b_col, out, partial, m, n, k, chunk_tiles, chunks,
    epilogue args, stream)``, then the split-K reduce."""
    m, n, k = _checked_shape(a, b, op)
    chunk_tiles, chunks = split_k(k)
    _, n_pad, _ = padded_dims(m, n, k)
    dev = a.device
    with cuda.on_device(dev):
        a, lda, a_col = _layout(a)
        b, ldb, b_col = _layout(b)
        out = torch.empty((m, n), dtype=torch.float32, device=dev)
        partial = (torch.empty((chunks, m, n), dtype=torch.float32, device=dev)
                   if chunks > 1 else None)
        cuda.check(launch_fn(
            a, lda, a_col, b, ldb, b_col, out.data_ptr(),
            0 if partial is None else partial.data_ptr(), m, n, k, chunk_tiles, chunks,
            n_pad, int(seed) & 0xFFFFFFFF, int(apply_sr), *_epilogue(il, fl),
            cuda.stream(dev)), f"{op} ({kernel} kernel)")
        if partial is not None:
            out = splitk_reduce(partial, seed, il=il, fl=fl, apply_sr=apply_sr)
    return out


def launch_tile(a: torch.Tensor, b: torch.Tensor, seed: int, il: int, fl: int,
                apply_sr: bool, op: str = "masked_matmul") -> torch.Tensor:
    """``a @ b`` on the card through ``masked_mm_kernel``, after the
    ``tile_occupancy`` pre-pass of both operands (two counted launches).
    ``op`` names the caller for :func:`record_tile_skip`."""
    tm, tn, tk = KERNEL_TILES

    def go(a, lda, a_col, b, ldb, b_col, *rest):
        a_occ, b_occ = _flags(a, a_col, tm, tk), _flags(b, b_col, tk, tn)
        if _SKIP is not None:
            _note_skip(op, a_occ, b_occ)
        return _lib().masked_matmul_launch(
            a.data_ptr(), lda, a_col, b.data_ptr(), ldb, b_col,
            a_occ.data_ptr(), a_occ.stride(0), a_occ.stride(1),
            b_occ.data_ptr(), b_occ.stride(0), b_occ.stride(1), *rest)

    return _run("tile", a, b, seed, il, fl, apply_sr, op, go)


def launch_skinny(a: torch.Tensor, b: torch.Tensor, seed: int, il: int, fl: int,
                  apply_sr: bool, op: str = "masked_matmul") -> torch.Tensor:
    """``a @ b`` on the card through ``masked_mm_skinny_kernel`` (M <=
    :data:`SKINNY_M`; one counted launch), which flags x's empty K-tiles
    itself and computes no weight occupancy.  While
    :func:`record_tile_skip` is active the tile steps are recorded from
    the plain flags, as the tile kernel's pre-pass would give them."""
    if a.shape[0] > SKINNY_M:
        raise ValueError(f"{op}: the skinny kernel takes M <= {SKINNY_M}, got {a.shape[0]}")
    note_plain(op, a, b)

    def go(a, lda, a_col, b, ldb, b_col, *rest):
        return _lib().masked_matmul_skinny_launch(a.data_ptr(), lda, a_col, b.data_ptr(), ldb,
                                                  b_col, *rest)

    out = _run("skinny", a, b, seed, il, fl, apply_sr, op, go)
    launch_skinny.launches += 1
    return out


#: skinny-kernel launches, whichever wrapper (forward, dx, dw) made them
launch_skinny.launches = 0


def launch(a: torch.Tensor, b: torch.Tensor, seed: int, il: int, fl: int, apply_sr: bool,
           op: str = "masked_matmul") -> torch.Tensor:
    """``a @ b`` on the card through the kernel :func:`route` picks: each
    operand row-major or column-major (read in place), K split per
    :func:`split_k`, SR epilogue when ``apply_sr``.  ``op`` names the
    caller for :func:`record_tile_skip`."""
    kernel = launch_skinny if route(a.shape[0], b.shape[1], a.shape[1]) == "skinny" \
        else launch_tile
    return kernel(a, b, seed, il, fl, apply_sr, op)


def splitk_reduce(partial: torch.Tensor, seed: int = 0, *, il: int = 4, fl: int = 16,
                  apply_sr: bool = False) -> torch.Tensor:
    """(chunks, M, N) partial sums -> (M, N): chunks added in order, then
    the SR epilogue when ``apply_sr``.  A CUDA tensor launches
    ``splitk_reduce_kernel`` (and counts one launch); a CPU tensor runs
    :func:`splitk_reduce_reference`."""
    if not partial.is_cuda:
        return splitk_reduce_reference(partial, seed, il=il, fl=fl, apply_sr=apply_sr)
    if not (partial.dtype == torch.float32 and partial.ndim == 3 and partial.is_contiguous()):
        raise ValueError("splitk_reduce: needs a contiguous (chunks, M, N) fp32 tensor")
    chunks, m, n = partial.shape
    out = torch.empty((m, n), dtype=torch.float32, device=partial.device)
    if out.numel() == 0:
        return out
    # the call is about as short on the card as its host time, so the SR
    # counter's n_pad is padded_dims' BN rounding inlined
    cuda.check(_lib().splitk_reduce_launch(
        partial.data_ptr(), out.data_ptr(), m, n, chunks, -(-n // BN) * BN,
        int(seed) & 0xFFFFFFFF, int(apply_sr), *_epilogue(il, fl), cuda.stream(partial.device)),
        "splitk_reduce")
    splitk_reduce.launches += 1
    return out


#: kernel launches made by this wrapper
splitk_reduce.launches = 0


def masked_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    seed: int = 0,
    *,
    il: int = 4,
    fl: int = 16,
    apply_sr: bool = True,
    backward: str | None = None,
) -> torch.Tensor:
    """Sparsity-aware ``x @ w`` on the Q(il,fl) grid with SR epilogue.

    x: (M, K) grid values (zeros are skippable); w: (K, N).  CUDA operands
    launch the kernel (and count one launch); CPU operands run
    :func:`masked_matmul_reference`.

    Inside ``registry.record_kernel_metrics`` the call notes its
    ``tile_skip`` at the reference's 128 tiles, as the reference does.

    ``backward``: None/"none" gives the forward alone (the plain version
    differentiates densely; the kernel has no gradient, so on the card it
    raises when autograd would need one); "auto" wraps the call in the
    autograd Function whose dL/dx and dL/dw are ``masked_matmul_dx`` /
    ``masked_matmul_dw`` (``backward.py``).  The port has no impl ladder,
    so these are the only choices.
    """
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"masked_matmul: bad shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if registry.metrics_active():
        registry.note_metric("masked_matmul", tile_skip=tile_skip_fraction(x, w))
    if backward == "auto":
        # imported here: backward.py imports this module
        from repro_torch.kernels.masked_matmul.backward import MaskedMatmulFn

        return MaskedMatmulFn.apply(x, w, seed, il, fl, apply_sr)
    if backward not in (None, "none"):
        raise ValueError(f"masked_matmul: backward={backward!r}; choose None, 'none' or 'auto'")
    return forward(x, w, seed, il=il, fl=fl, apply_sr=apply_sr)


def forward(x: torch.Tensor, w: torch.Tensor, seed: int = 0, *, il: int = 4, fl: int = 16,
            apply_sr: bool = True) -> torch.Tensor:
    """The forward product alone: the kernel on CUDA tensors (one counted
    ``masked_matmul`` launch), the plain version on CPU tensors."""
    if x.is_cuda:
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            raise ValueError("masked_matmul: the kernel forward has no gradient; "
                             "pass backward='auto' to train through it")
        out = launch(x, w, seed, il, fl, apply_sr)
        masked_matmul.launches += 1
        return out
    note_plain("masked_matmul", x, w)
    return masked_matmul_reference(x, w, seed, il=il, fl=fl, apply_sr=apply_sr)


#: kernel launches made by this wrapper (the CPU path counts nothing)
masked_matmul.launches = 0
