"""The port's CUDA kernels on the card, against their plain versions.

Every test takes the ``card`` fixture, which skips where there is no CUDA
card, so on a CPU-only host every one of them skips.  On a machine with
an H100 (``--noconftest``: ``tests/conftest.py`` imports jax, which that
machine need not have):

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

Torch only (no jax), so it runs where the reference package cannot.
Tolerances: the SR epilogue and mask words are exact on operands whose
products and sums are exact in fp32; otherwise fp32 sums in another order
differ by at most 2 * K * 2**-24 * (|x| @ |w|) elementwise.
"""

import pytest

torch = pytest.importorskip("torch")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _coarse(gen, shape, sparsity):
    v = torch.round(torch.randn(shape, generator=gen) * 2**6) / 2**8
    return v * (torch.rand(shape, generator=gen) > sparsity)


@pytest.mark.parametrize("m,k,n,sr", [(128, 128, 128, True), (100, 70, 50, True),
                                      (4, 2048, 512, True), (33, 300, 257, False)])
def test_masked_matmul_kernel_matches_plain(card, m, k, n, sr):
    from repro_torch.kernels.masked_matmul.ops import (masked_matmul, masked_matmul_reference,
                                                       tile_occupancy)

    gen = torch.Generator().manual_seed(m + k + n)
    x, w = _coarse(gen, (m, k), 0.5).to(card), _coarse(gen, (k, n), 0.5).to(card)
    x[:, : k // 2] = 0.0  # whole K-tiles skipped
    before, occ_before = masked_matmul.launches, tile_occupancy.launches
    got = masked_matmul(x, w, 7, apply_sr=sr)
    want = masked_matmul_reference(x, w, 7, apply_sr=sr)
    torch.cuda.synchronize()
    assert masked_matmul.launches == before + 1
    assert tile_occupancy.launches == occ_before + 2
    assert torch.equal(got, want)


def test_masked_matmul_kernel_allclose_on_q4_16(card):
    from repro_torch.core.fixedpoint import quantize_nearest
    from repro_torch.kernels.masked_matmul.ops import masked_matmul, masked_matmul_reference

    gen = torch.Generator().manual_seed(0)
    k = 2048
    x = quantize_nearest(torch.randn(32, k, generator=gen)).to(card)
    w = quantize_nearest(torch.randn(k, 512, generator=gen) / k**0.5).to(card)
    got = masked_matmul(x, w, apply_sr=False)
    want = masked_matmul_reference(x, w, apply_sr=False)
    tol = 2 * k * 2.0**-24 * (x.abs() @ w.abs())
    assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("rows,cols,tiles", [(4, 2048, (64, 32)), (2048, 8192, (32, 64)),
                                             (8192, 2048, (32, 64)), (100, 70, (64, 32))])
def test_tile_occupancy_kernel_matches_plain(card, rows, cols, tiles):
    from repro_torch.kernels.masked_matmul.ops import tile_occupancy, tile_occupancy_reference

    gen = torch.Generator().manual_seed(rows + cols)
    tr, tc = tiles
    keep = torch.rand(-(-rows // tr), -(-cols // tc), generator=gen) > 0.5
    keep[0, 0] = False
    keep = keep.repeat_interleave(tr, 0).repeat_interleave(tc, 1)[:rows, :cols]
    a = (torch.randn(rows, cols, generator=gen) * keep).to(card)  # whole tiles empty
    want = tile_occupancy_reference(a, tr, tc)
    assert int((want == 0).sum()) > 0
    assert torch.equal(tile_occupancy(a, tr, tc), want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("n_blocks,block_len", [(3, 33), (7, 1000), (64, 25088)])
def test_mask_pack_kernel_matches_plain(card, dtype, n_blocks, block_len):
    from repro_torch.kernels.mask_compress.ops import mask_pack, mask_pack_reference

    gen = torch.Generator().manual_seed(block_len)
    x = torch.randn(n_blocks, block_len, generator=gen)
    x = x * (torch.rand(n_blocks, block_len, generator=gen) > 0.4)
    x[:, ::7] = -0.0
    x = x.to(getattr(torch, dtype)).to(card)
    got = mask_pack(x)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), mask_pack_reference(x).view(torch.int32))


def test_engine_on_the_card_runs_the_kernels(card):
    from repro_torch import kernels
    from repro_torch.launch.serve import serve_session

    kernels.reset_launch_counts()
    out = serve_session("llama3.2-1b", reduced=True, mode="quant_sparse", slots=2,
                        queue=3, prompt_len=8, gen=4, device=card)
    counts = kernels.launch_counts()
    assert out["finite"] and all(r["n_tokens"] == 4 for r in out["per_request"])
    assert counts["masked_matmul"] > 0 and counts["mask_pack"] > 0
    assert counts["tile_occupancy"] == 2 * counts["masked_matmul"]
