"""The masked matmul's two card kernels, from the CPU: which one a shape
takes, the K chunks both keep, and the tile steps recorded for either.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``);
here the wrapper's routing, split and records are held against counts
made independently with numpy, on the plain versions.
"""

import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import cuda
from repro_torch.kernels.masked_matmul import backward as tbw
from repro_torch.kernels.masked_matmul import ops as tmm


@pytest.mark.parametrize("m", [1, 3, 4, 17, 31, 32, 33, 64, 300, 4096])
@pytest.mark.parametrize("a_col,b_col", [(False, False), (False, True), (True, False),
                                         (True, True)])
def test_launch_routes_by_m_alone_for_either_layout(monkeypatch, m, a_col, b_col):
    """``launch`` sends M <= SKINNY_M to the skinny kernel and the rest to
    the tile kernel, whatever the operands' layouts; ``route`` says the
    same from the shape alone."""
    k, n = 70, 50
    a = torch.empty(k, m).t() if a_col else torch.empty(m, k)
    b = torch.empty(n, k).t() if b_col else torch.empty(k, n)
    taken = []
    for name in ("launch_skinny", "launch_tile"):
        monkeypatch.setattr(tmm, name, lambda *args, _n=name: taken.append(_n))
    tmm.launch(a, b, 0, 4, 16, False)
    want = "skinny" if m <= tmm.SKINNY_M else "tile"
    assert taken == [f"launch_{want}"]
    assert tmm.route(m, n, k) == want
    assert tmm.route(m, 1, 1) == tmm.route(m, 25088, 1_605_632) == want


def test_route_rejects_empty_shapes_and_skinny_rejects_large_m():
    assert tmm.route(1_605_632, 64, 576) == "tile"  # c0_1's dX
    assert tmm.route(32, 25088, 4096) == "skinny"  # fc6's dX at batch 32
    for shape in [(0, 4, 4), (4, 0, 4), (4, 4, 0)]:
        with pytest.raises(ValueError):
            tmm.route(*shape)
    with pytest.raises(ValueError, match="M <= 32"):
        tmm.launch_skinny(torch.zeros(33, 8), torch.zeros(8, 4), 0, 4, 16, False)


@pytest.mark.parametrize("k", [1, 31, 32, 100, 576, 2048, 8191, 8192, 8193, 25088, 1_605_632])
def test_split_k_cuts_k_into_8192_element_chunks(k):
    bk = tmm.KERNEL_TILES[2]
    chunk_tiles, chunks = tmm.split_k(k)
    assert chunks == -(-k // 8192)
    assert chunk_tiles * bk == (8192 if k > 8192 else -(-k // bk) * bk)
    assert (chunks - 1) * chunk_tiles * bk < k <= chunks * chunk_tiles * bk


def test_kernel_constants_match_the_source():
    """The wrapper's constants are the ones ``masked_matmul.cu`` is built
    with (the library reports them on the card; here the source is read)."""
    src = (cuda.CSRC / cuda.SOURCES["masked_matmul"]).read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("FLAG_M"), const("FLAG_N"), const("BK")) == tmm.KERNEL_TILES
    assert const("SKINNY_M") == tmm.SKINNY_M == 32
    assert const("MAX_CHUNK_TILES") * const("BK") == tmm.SPLIT_K == 8192


def _block_pruned(rng, shape, tile, p_zero):
    """Random values with whole ``tile``-shaped blocks zeroed."""
    v = rng.standard_normal(shape).astype(np.float32)
    keep = rng.random((-(-shape[0] // tile[0]), -(-shape[1] // tile[1]))) >= p_zero
    keep = np.repeat(np.repeat(keep, tile[0], 0), tile[1], 1)[: shape[0], : shape[1]]
    return v * keep


def _steps(a: np.ndarray, b: np.ndarray) -> tuple[float, float]:
    """(issued, total) (i, j, k) tile steps of a @ b at (64, 64, 32) tiles,
    counted by loops over the tiles."""
    tm, tn, tk = 64, 64, 32
    m, k = a.shape
    n = b.shape[1]
    ti, tj, tkk = -(-m // tm), -(-n // tn), -(-k // tk)
    issued = 0
    for i in range(ti):
        for j in range(tj):
            for kt in range(tkk):
                a_any = np.any(a[i * tm:(i + 1) * tm, kt * tk:(kt + 1) * tk] != 0)
                b_any = np.any(b[kt * tk:(kt + 1) * tk, j * tn:(j + 1) * tn] != 0)
                issued += bool(a_any and b_any)
    return float(issued), float(ti * tj * tkk)


@pytest.mark.parametrize("m", [4, 300])
def test_record_tile_skip_counts_steps_at_m4_and_m300(m):
    """With recording on, the forward, dx and dw each add the issued and
    total tile steps of their product, as counted tile by tile."""
    rng = np.random.default_rng(m)
    k, n = 200, 130
    x = _block_pruned(rng, (m, k), (4, 32), 0.4)
    w = _block_pruned(rng, (k, n), (32, 64), 0.4)
    g = _block_pruned(rng, (m, n), (4, 64), 0.3)
    xt, wt, gt = (torch.from_numpy(v) for v in (x, w, g))
    with tmm.record_tile_skip() as rec:
        tmm.masked_matmul(xt, wt, apply_sr=False)
        tbw.masked_matmul_dx(gt, wt)
        tbw.masked_matmul_dw(xt, gt)
    assert rec["masked_matmul"] == list(_steps(x, w))
    assert rec["masked_matmul_dx"] == list(_steps(g, w.T))
    assert rec["masked_matmul_dw"] == list(_steps(x.T, g))
    assert rec["masked_matmul"][0] < rec["masked_matmul"][1]  # something was skipped
