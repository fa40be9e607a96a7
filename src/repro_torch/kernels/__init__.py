"""Kernel wrappers and their launch counters.

Each wrapper that launches a CUDA kernel counts its launches in a plain
integer attribute (``masked_matmul.launches``, ``tile_occupancy.launches``
-- ``masked_matmul``'s occupancy pre-pass -- and ``mask_pack.launches``), so
a run can show that its main path went through the kernels.  Importing
this package builds nothing.
"""

from __future__ import annotations

from repro_torch.kernels.mask_compress.ops import mask_pack
from repro_torch.kernels.masked_matmul.ops import masked_matmul, tile_occupancy

#: kernel name -> its wrapper (the function that owns the counter)
WRAPPERS = {"masked_matmul": masked_matmul, "tile_occupancy": tile_occupancy,
            "mask_pack": mask_pack}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
