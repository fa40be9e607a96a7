"""Kernel wrappers and their launch counters.

Each wrapper that launches a CUDA kernel counts its launches in a plain
integer attribute, so a run can show that its main path went through the
kernels: ``masked_matmul`` (the forward product), ``masked_matmul_dx`` and
``masked_matmul_dw`` (the backward products on the same two CUDA kernels),
``masked_matmul_skinny`` (the products of those three with M <= 32, on
the skinny kernel), ``tile_occupancy`` (the tile kernel's occupancy
pre-pass, two per product with M > 32),
``splitk_reduce`` (the split-K reduce, one per product with K > 8192),
``mask_pack``, ``stochastic_round``, ``flash_attention`` (one per prefill
attention), ``ssd_scan`` (one per SSD scan, four stage kernels) and
``dangling_filter`` (the pre-compute filter, on the kernel sweep's path
alone).  Importing this package builds nothing.
"""

from __future__ import annotations

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.mask_compress.ops import dangling_filter, mask_pack
from repro_torch.kernels.masked_matmul.backward import masked_matmul_dw, masked_matmul_dx
from repro_torch.kernels.masked_matmul.ops import (launch_skinny, masked_matmul, splitk_reduce,
                                                   tile_occupancy)
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.stochastic_round.ops import stochastic_round

#: kernel name -> its wrapper (the function that owns the counter)
WRAPPERS = {"masked_matmul": masked_matmul, "masked_matmul_dx": masked_matmul_dx,
            "masked_matmul_dw": masked_matmul_dw, "masked_matmul_skinny": launch_skinny,
            "tile_occupancy": tile_occupancy,
            "splitk_reduce": splitk_reduce, "mask_pack": mask_pack,
            "stochastic_round": stochastic_round, "flash_attention": flash_attention,
            "ssd_scan": ssd_scan, "dangling_filter": dangling_filter}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
