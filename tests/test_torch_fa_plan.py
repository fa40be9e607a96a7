"""The flash-attention kernel's query-tile plan, from the CPU: which tile
each shape the port serves takes.  The kernel itself runs each tile on
the card (``tests/test_torch_cuda.py``), and its library reports the tile
rows it was built with, which the wrapper checks when it loads it.
"""

import pytest

from repro_torch.kernels.flash_attention import ops as fa

H100_SMS = 132


@pytest.mark.parametrize("sq,want", [(32, (64, 4, 16, 16)), (128, (64, 4, 16, 64)),
                                     (512, (64, 4, 16, 256)), (4096, (128, 4, 32, 1024)),
                                     (8192, (128, 4, 32, 2048))])
def test_plan_packs_llama_groups_and_takes_the_big_tile_on_long_prompts(sq, want):
    """llama3.2-1b (H 32, HKV 8, D 64): 4 heads per tile; 128 rows once
    that gives 4 CTAs per SM of an H100, 64 rows below."""
    assert tuple(fa.plan(1, 32, 8, sq, 64, H100_SMS)) == want


@pytest.mark.parametrize("h,hkv,hpc", [(8, 8, 1), (8, 4, 2), (12, 2, 2), (32, 8, 4), (16, 2, 8),
                                       (32, 1, 8), (9, 3, 1)])
def test_plan_packs_the_largest_power_of_two_of_the_group(h, hkv, hpc):
    p = fa.plan(2, h, hkv, 1000, 32, H100_SMS)
    assert p.heads_per_cta == hpc and p.rows % hpc == 0 and p.positions == p.rows // hpc
    assert (h // hkv) % hpc == 0


def test_plan_keeps_head_dim_128_on_the_64_row_tile():
    assert fa.plan(1, 32, 8, 4096, 128, H100_SMS).rows == 64
    assert fa.plan(1, 32, 8, 4096, 64, H100_SMS).rows == 128


@pytest.mark.parametrize("sq,want", [(2600, (64, 8, 8, 650)), (4096, (64, 8, 8, 1024)),
                                     (40, (64, 8, 8, 10)), (1, (64, 8, 8, 2))])
def test_plan_takes_the_64_row_tile_at_head_dim_256(sq, want):
    """recurrentgemma-9b's local attention (H 16, HKV 1, D 256): 8 of the
    group's 16 heads at 8 positions a tile, two head tiles a strip, on the
    64-row tile whatever the prompt (the kernel splits D 256 over two warp
    groups of those rows)."""
    assert tuple(fa.plan(1, 16, 1, sq, 256, H100_SMS)) == want


def test_head_dim_256_is_instantiated():
    assert 256 in fa.HEAD_DIMS
    assert fa.plan(2, 4, 2, 300, 256, H100_SMS).rows == 64
