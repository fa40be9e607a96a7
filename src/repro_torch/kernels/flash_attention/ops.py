"""Public wrapper for flash attention (port of
``repro/kernels/flash_attention/ops.py``).

``flash_attention(q, k, v, *, causal, window)`` takes the reference's
layout, q (B, H, Sq, D) and k/v (B, HKV, Skv, D) with H % HKV == 0, and
returns (B, H, Sq, D) in q's dtype.  It dispatches on the tensors' device:
a CUDA tensor launches the kernel in ``csrc/flash_attention.cu`` (one
launch, counted) or raises; a CPU tensor runs
:func:`~repro_torch.kernels.flash_attention.ref.attention_reference`.
The kernel has no backward (nor has the reference's Pallas kernel), so on
the card a call that autograd would need to differentiate raises instead
of dropping the gradient; the plain version stays differentiable.

The kernel reads q/k/v through their strides (only the D axis must be
contiguous), so the model hands it transposed views of its (B, S, H, D)
projections without a copy, and the output is allocated in q's own layout.
Keys at index >= Skv never enter the softmax on either path: the kernel
masks its ragged last kv tile by index.  :func:`plan` alone chooses the
kernel's query tile (its rows and the GQA heads packed into them), from the
shape and the card's SM count.  (The reference's Pallas route
pads Skv with zero keys and masks them only causally, so its non-causal
ragged case differs from its own oracle; the port follows the oracle.)
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.flash_attention.ref import attention_reference

__all__ = ["flash_attention", "attention_reference", "plan"]

#: head dims the CUDA kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)
#: query rows of the kernel's two tiles and the most heads of one kv group
#: it packs into a tile (checked against the library's when it loads)
TILE_ROWS, MAX_HEADS_PER_CTA = (128, 64), 8
#: the 128-row tile is taken when it gives at least this many CTAs per SM
#: (two waves of its two resident CTAs per SM); below, the 64-row tile
BIG_TILE_CTAS_PER_SM = 4


class Plan(NamedTuple):
    rows: int           # query rows per CTA
    heads_per_cta: int  # heads of one kv group in those rows
    positions: int      # rows / heads_per_cta positions of each head
    ctas: int


@functools.cache
def plan(batch: int, n_heads: int, n_kv_heads: int, sq: int, head_dim: int, n_sms: int) -> Plan:
    """The kernel's query tile for a shape.  Its rows are the largest
    power of two of a kv group's heads (at most :data:`MAX_HEADS_PER_CTA`)
    at the same positions, so a K/V tile is fetched once per group.  128
    rows where that gives :data:`BIG_TILE_CTAS_PER_SM` CTAs per SM and the
    head dim is at most 64; 64 rows otherwise (D 128 always: its 128-row
    tile does not fit two CTAs per SM).  Cached per shape: the wrapper asks
    on every call."""
    group = n_heads // n_kv_heads
    hpc = min(group & -group, MAX_HEADS_PER_CTA)

    def ctas(rows):
        return -(-sq // (rows // hpc)) * (n_heads // hpc) * batch

    big, small = TILE_ROWS
    rows = big if head_dim <= 64 and ctas(big) >= BIG_TILE_CTAS_PER_SM * n_sms else small
    return Plan(rows, hpc, rows // hpc, ctas(rows))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda.load("flash_attention")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_attention_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                           *([ll] * 12), i, i, ctypes.c_float, i, i, p]
    lib.flash_attention_launch.restype = i
    lib.flash_attention_config.argtypes = [ctypes.POINTER(i)]
    lib.flash_attention_config.restype = None
    conf = (i * 3)()
    lib.flash_attention_config(conf)
    if tuple(conf) != (*TILE_ROWS, MAX_HEADS_PER_CTA):
        raise cuda.KernelBuildError(f"flash_attention built with (tile rows, most heads per "
                                    f"tile) {tuple(conf)}, the wrapper expects "
                                    f"{(*TILE_ROWS, MAX_HEADS_PER_CTA)}")
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: Optional[int]) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D (B, H, S, D)")
    b, h, _, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not agree")
    if k.shape[1] == 0 or h % k.shape[1]:
        raise ValueError(f"flash_attention: {h} heads do not divide into {k.shape[1]} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")


def _launch(q, k, v, causal: bool, window: Optional[int], rows: Optional[int] = None
            ) -> torch.Tensor:
    """The kernel on card tensors (one counted launch), on the tile that
    :func:`plan` chooses; ``rows`` overrides its rows (the card tests run
    each tile)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise ValueError("flash_attention: the kernel forward has no gradient; "
                         "run it under torch.no_grad() or on plain tensors")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: CUDA takes fp32 or bf16 q/k/v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v must be on one CUDA device")
    b, h, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {d} not in {HEAD_DIMS}")
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    out = torch.empty_like(q)  # keeps q's layout when q is dense
    if out.numel() == 0:
        return out
    tile = plan(b, h, hkv, sq, d, cuda.sm_count(q.device.index))
    with cuda.on_device(q.device):
        cuda.check(_lib().flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, h, hkv, sq, skv, d, int(q.dtype == torch.bfloat16),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            int(causal), 0 if window is None else int(window), 1.0 / (d**0.5),
            rows or tile.rows, tile.heads_per_cta, cuda.stream(q.device)), "flash_attention")
    flash_attention.launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """Multi-head attention; q (B,H,Sq,D), k/v (B,HKV,Skv,D) -> (B,H,Sq,D)."""
    _check(q, k, v, window)
    if q.is_cuda:
        return _launch(q, k, v, causal, window)
    return attention_reference(q, k, v, causal=causal, window=window)


#: kernel launches made by this wrapper (the CPU path counts nothing)
flash_attention.launches = 0
