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
    torch.backends.cudnn.allow_tf32 = False
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
    from repro_torch.kernels.masked_matmul.ops import SKINNY_M, launch_skinny

    before, occ_before = masked_matmul.launches, tile_occupancy.launches
    skinny_before = launch_skinny.launches
    got = masked_matmul(x, w, 7, apply_sr=sr)
    want = masked_matmul_reference(x, w, 7, apply_sr=sr)
    torch.cuda.synchronize()
    assert masked_matmul.launches == before + 1
    # the skinny kernel flags x itself; the tile kernel runs the pre-pass
    skinny = m <= SKINNY_M
    assert launch_skinny.launches == skinny_before + skinny
    assert tile_occupancy.launches == occ_before + (0 if skinny else 2)
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


# -- the two masked_matmul kernels: the same bits -----------------------------------


def _q_operand(gen, shape, col: bool, card):
    """Q4.16 values with whole 32-deep K-tiles zero, laid out row-major or
    (``col``) column-major as a transposed view."""
    from repro_torch.core.fixedpoint import quantize_nearest

    rows, cols = shape
    v = quantize_nearest(torch.randn((cols, rows) if col else shape, device=card,
                                     generator=gen) / 4)
    return v.t() if col else v


@pytest.mark.parametrize("sr", [False, True])
@pytest.mark.parametrize("b_col", [False, True])
@pytest.mark.parametrize("k,n", [(k, n) for k in (70, 2048, 8193, 25088) for n in (50, 512, 4096)])
def test_skinny_and_tile_kernels_bit_equal_on_the_same_rows(card, k, n, b_col, sr):
    """At M in {1, 3, 4, 17, 32}, x row- and column-major: the skinny and
    the tile kernel, each forced through its launcher, give the same bits,
    as do the first M rows of a tile launch at M = 300 (batch invariance),
    and two calls give the same bits."""
    from repro_torch.kernels.masked_matmul.ops import launch_skinny, launch_tile

    gen = torch.Generator(device=card).manual_seed(k * 7 + n + 2 * b_col)
    w = _q_operand(gen, (k, n), b_col, card)
    tall = _q_operand(gen, (300, k), False, card)
    tall[:, 32:96] = 0.0  # two x K-tiles empty
    for m in (1, 3, 4, 17, 32):
        for a_col in (False, True):
            x = tall[:m].t().contiguous().t() if a_col else tall[:m]
            skinny = launch_skinny(x, w, 11, 4, 16, sr)
            again = launch_skinny(x, w, 11, 4, 16, sr)
            tile = launch_tile(x, w, 11, 4, 16, sr)
            torch.cuda.synchronize()
            assert torch.equal(skinny, again), (m, a_col)
            assert torch.equal(skinny, tile), (m, a_col)
    rows = launch_tile(tall, w, 11, 4, 16, sr)[:32]
    assert torch.equal(rows, launch_skinny(tall[:32], w, 11, 4, 16, sr))


def test_skinny_kernel_skips_an_empty_x_k_tile(card):
    """NaN in the weight rows under an all-zero x K-tile: a skipped tile
    never reads them, so both kernels stay finite and give the bits they
    give with those rows zero."""
    from repro_torch.kernels.masked_matmul.ops import launch_skinny, launch_tile

    gen = torch.Generator(device=card).manual_seed(1)
    x = _q_operand(gen, (4, 2048), False, card)
    w = _q_operand(gen, (2048, 512), False, card)
    x[:, 64:128] = 0.0  # K-tiles 2 and 3
    w_nan = w.clone()
    w_nan[64:128] = float("nan")
    w[64:128] = 0.0
    want = launch_skinny(x, w, 0, 4, 16, False)
    for fn in (launch_skinny, launch_tile):
        got = fn(x, w_nan, 0, 4, 16, False)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        assert torch.equal(got, want)


@pytest.mark.parametrize("m,k,n,kernel", [(32, 8192, 512, "skinny"), (8, 8192, 4096, "skinny"),
                                          (300, 2048, 2048, "tile"), (4096, 576, 64, "tile")])
def test_masked_matmul_kernels_launch_above_the_default_shared_memory(card, m, k, n, kernel):
    """Both kernels' rings take more than the 48 KB of shared memory a
    launch gets by default; the launcher raises the limit, and the product
    agrees with the plain version within 2K 2^-24 (|x| @ |w|)."""
    from repro_torch.kernels.masked_matmul.ops import (launch_skinny, launch_tile,
                                                       masked_matmul_reference)

    gen = torch.Generator(device=card).manual_seed(m + n)
    x, w = _q_operand(gen, (m, k), False, card), _q_operand(gen, (k, n), False, card)
    got = (launch_skinny if kernel == "skinny" else launch_tile)(x, w, 0, 4, 16, False)
    want = masked_matmul_reference(x, w, apply_sr=False)
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 2 * k * 2.0**-24 * (x.abs() @ w.abs())).all())


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


def _pack_operand(gen, n_blocks, block_len, dtype):
    """Random values, 40% zeros, every 7th -0.0, and +-0.0, NaN, +-inf and
    +-subnormals of ``dtype`` at random places."""
    x = torch.randn(n_blocks, block_len, generator=gen)
    x = x * (torch.rand(n_blocks, block_len, generator=gen) > 0.4)
    x[:, ::7] = -0.0
    sub = torch.finfo(dtype).smallest_normal / 4
    specials = torch.tensor([0.0, -0.0, float("nan"), float("inf"), float("-inf"), sub, -sub])
    flat = x.view(-1)
    at = torch.randint(0, flat.numel(), (max(1, flat.numel() // 16),), generator=gen)
    flat[at] = specials[torch.randint(0, len(specials), at.shape, generator=gen)]
    return x.to(dtype)


@pytest.mark.parametrize("route", [None, "lane"])
@pytest.mark.parametrize("n_blocks,block_len", [(3, 33), (7, 1000), (3, 32), (3, 256), (5, 288),
                                                (64, 25088), (2, 2105856)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_mask_pack_kernel_matches_plain(card, dtype, n_blocks, block_len, route):
    """The planner's route (``stream`` where blocks end on a word
    boundary, ``lane`` for ragged lengths) and the lane route forced, on
    operands with special values."""
    from repro_torch.kernels import cuda
    from repro_torch.kernels.mask_compress import ops as mc

    dtype = getattr(torch, dtype)
    x = _pack_operand(torch.Generator().manual_seed(block_len), n_blocks, block_len,
                      dtype).to(card)
    p = mc.plan(n_blocks, block_len, mc._ELEM_BYTES[dtype], True,
                cuda.sm_count(x.device.index))
    assert p.route == ("stream" if block_len % 32 == 0 else "lane")
    before = mc.mask_pack.launches
    got = mc._launch(x, route=route)
    torch.cuda.synchronize()
    assert mc.mask_pack.launches == before + 1
    assert torch.equal(got.view(torch.int32), mc.mask_pack_reference(x).view(torch.int32))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("block_len", [33, 1000, 1024])
def test_mask_pack_misaligned_view_takes_the_lane_route(card, dtype, block_len):
    from repro_torch.kernels.mask_compress import ops as mc

    dtype = getattr(torch, dtype)
    base = _pack_operand(torch.Generator().manual_seed(7), 1, 6 * block_len + 1, dtype)
    x = base.to(card).view(-1)[1:].view(6, block_len)  # contiguous, off 16-byte alignment
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    with pytest.raises(ValueError, match="route 'stream'"):
        mc._launch(x, route="stream")
    got = mc.mask_pack(x)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), mc.mask_pack_reference(x).view(torch.int32))


def test_engine_on_the_card_runs_the_kernels(card):
    from repro_torch import kernels
    from repro_torch.launch.serve import serve_session

    kernels.reset_launch_counts()
    out = serve_session("llama3.2-1b", reduced=True, mode="quant_sparse", slots=2,
                        queue=3, prompt_len=8, gen=4, device=card)
    counts = kernels.launch_counts()
    assert out["finite"] and all(r["n_tokens"] == 4 for r in out["per_request"])
    assert counts["masked_matmul"] > 0 and counts["mask_pack"] > 0
    # prompts of 8 and decode ticks of 2 slots: every product on the skinny kernel
    assert counts["masked_matmul_skinny"] == counts["masked_matmul"]
    assert counts["tile_occupancy"] == 0


# -- slice 2: the training kernels ----------------------------------------------


@pytest.mark.parametrize("shape,il,fl", [((333, 17), 4, 16), ((3, 5, 9), 4, 16),
                                         ((256, 64), 2, 6), ((4, 224, 224, 16), 4, 16)])
def test_stochastic_round_kernel_bit_equal_to_plain(card, shape, il, fl):
    from repro_torch.kernels.stochastic_round.ops import sr_reference, stochastic_round

    gen = torch.Generator().manual_seed(len(shape))
    x = (torch.randn(shape, generator=gen) * 3).to(card)
    before = stochastic_round.launches
    got = stochastic_round(x, 9, il=il, fl=fl)
    want = sr_reference(x, 9, il=il, fl=fl)
    torch.cuda.synchronize()
    assert stochastic_round.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("which,m,k,n", [("dx", 300, 576, 64), ("dw", 576, 20000, 64),
                                         ("dw", 100, 70, 50), ("dx", 33, 4096, 513)])
def test_backward_kernels_match_plain_and_repeat(card, which, m, k, n):
    """dx reads w.T and dw reads x.T in place; dw at K = 20000 splits K in
    three chunks.  Within 2K 2^-24 (|a| @ |b|) of the plain fp32 product,
    and bit-identical across two calls."""
    from repro_torch.kernels.masked_matmul.backward import (
        masked_matmul_dw, masked_matmul_dw_reference, masked_matmul_dx,
        masked_matmul_dx_reference)

    gen = torch.Generator().manual_seed(m + k + n)
    if which == "dx":  # g (m, k) @ w.T, w (n, k): out (m, n)
        a = torch.relu(torch.randn(m, k, generator=gen)).to(card)
        b = torch.randn(n, k, generator=gen).to(card)
        fn, ref, absprod = masked_matmul_dx, masked_matmul_dx_reference, a.abs() @ b.abs().T
    else:  # x.T @ g, x (k, m), g (k, n): out (m, n)
        a = torch.relu(torch.randn(k, m, generator=gen)).to(card)
        b = torch.randn(k, n, generator=gen).to(card)
        fn, ref, absprod = masked_matmul_dw, masked_matmul_dw_reference, a.abs().T @ b.abs()
    got, again = fn(a, b), fn(a, b)
    want = ref(a, b)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert bool(((got - want).abs() <= 2 * k * 2.0**-24 * absprod).all())


@pytest.mark.parametrize("chunks,m,n,offset", [
    (5, 70, 130, 0), (1, 70, 130, 0), (2, 33, 64, 0), (7, 9, 50, 0), (196, 576, 64, 0),
    (7, 70, 50, 1), (17, 5, 50, 0), (3, 3, 7, 2)])
def test_splitk_reduce_kernel_matches_plain(card, chunks, m, n, offset):
    """Bit-equal with SR off and on: one to 196 chunks, N = 50 (not a
    multiple of 4), M * N not a multiple of a block's outputs, and a
    partials tensor whose base is ``offset`` floats past 16-byte alignment
    (the kernel reads 16-byte vectors only where every chunk is aligned)."""
    from repro_torch.kernels.masked_matmul.ops import splitk_reduce, splitk_reduce_reference

    gen = torch.Generator().manual_seed(3)
    flat = torch.randn(offset + chunks * m * n, generator=gen).to(card)
    part = flat[offset:].view(chunks, m, n)
    assert part.is_contiguous() and part.data_ptr() % 16 == 4 * offset % 16
    before = splitk_reduce.launches
    for sr in (False, True):
        assert torch.equal(splitk_reduce(part, 11, apply_sr=sr),
                           splitk_reduce_reference(part, 11, apply_sr=sr))
    assert splitk_reduce.launches == before + 2


def test_tiny_cnn_trains_on_the_card_through_the_kernels(card):
    from repro_torch import kernels
    from repro_torch.launch.train import run_arm
    from repro_torch.memstash.config import MemstashConfig

    kernels.reset_launch_counts()
    out = run_arm("t", "tiny_cnn", "quant_sparse", True, 2, 16, 8, card,
                  MemstashConfig(policy="stash"), verbose=False)
    counts = kernels.launch_counts()
    assert out["finite"] and all(out["on_grid"])
    for name in ("masked_matmul", "masked_matmul_dx", "masked_matmul_dw", "stochastic_round"):
        assert counts[name] > 0, counts


def test_spring_matmul_runs_the_kernel_without_the_sparse_backward(card):
    """quant_sparse with backward_sparsity="none" still takes its 2-D
    products on the kernel; the kernel forward has no gradient, so asking
    for one raises instead of falling back to torch.matmul."""
    import dataclasses

    from repro_torch.core.spring_ops import QUANT_SPARSE, spring_matmul
    from repro_torch.kernels.masked_matmul.ops import masked_matmul

    cfg = dataclasses.replace(QUANT_SPARSE, stochastic=False, backward_sparsity="none")
    gen = torch.Generator().manual_seed(5)
    x = torch.relu(torch.randn(64, 300, generator=gen)).to(card)
    w = (torch.randn(300, 40, generator=gen) / 300**0.5).to(card)
    before = masked_matmul.launches
    y = spring_matmul(x, w, cfg)
    torch.cuda.synchronize()
    assert masked_matmul.launches == before + 1
    assert torch.isfinite(y).all()
    with pytest.raises(ValueError, match="no gradient"):
        spring_matmul(x, w.clone().requires_grad_(True), cfg)


# -- slice 3: flash_attention and ssd_scan ----------------------------------------


_FA_CASES = [
    (1, 32, 8, 512, 64, True, None, "float32"), (1, 4, 2, 300, 128, False, None, "float32"),
    (2, 2, 2, 256, 64, True, 128, "float32"), (1, 2, 2, 200, 16, True, None, "bfloat16"),
    # groups 1, 2, 4, 8 (the heads packed into a query tile)
    (1, 4, 4, 200, 64, True, None, "float32"), (2, 4, 2, 200, 32, True, None, "float32"),
    (1, 8, 2, 33, 64, True, None, "float32"), (1, 16, 2, 200, 64, True, None, "float32"),
    # Sq of 1 and 31: below one strip of positions
    (1, 8, 2, 1, 64, True, None, "float32"), (1, 8, 2, 31, 64, True, None, "float32"),
    # windows across a kv tile and the ring's stages
    (1, 8, 2, 300, 64, True, 45, "float32"), (1, 4, 2, 300, 128, True, 70, "bfloat16"),
    # head dims 16 and 128, bf16, non-causal ragged
    (1, 4, 1, 130, 16, True, None, "float32"), (1, 8, 2, 200, 128, True, None, "float32"),
    (1, 8, 2, 200, 64, True, None, "bfloat16"), (1, 8, 8, 300, 32, False, None, "bfloat16"),
    (1, 8, 2, 200, 64, False, None, "float32")]


@pytest.mark.parametrize("b,h,hkv,s,d,causal,window,dtype,rows", [
    (*case, rows) for case in _FA_CASES for rows in (None, 128, 64)
    if not (rows == 128 and case[4] == 128)])
def test_flash_attention_kernel_matches_plain(card, b, h, hkv, s, d, causal, window, dtype, rows):
    """Against the plain version at the registry's compare: atol 2e-5 for
    fp32, 2e-2 for bf16; q/k/v as the model passes them, transposed
    (B,S,H,D) projections read through strides; on the planned query tile
    (rows None) and on each tile forced."""
    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator().manual_seed(s)
    dt = getattr(torch, dtype)
    q = torch.randn(b, s, h, d, generator=gen).to(card, dt).transpose(1, 2)
    k = torch.randn(b, s, hkv, d, generator=gen).to(card, dt).transpose(1, 2)
    v = torch.randn(b, s, hkv, d, generator=gen).to(card, dt).transpose(1, 2)
    before = ops.flash_attention.launches
    if rows is None:
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
    else:
        got = ops._launch(q, k, v, causal, window, rows=rows)
    want = ops.attention_reference(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert got.dtype == dt and got.shape == want.shape
    atol = 2e-2 if dtype == "bfloat16" else 2e-5
    assert float((got.float() - want.float()).abs().max()) <= atol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [0, 1, 2])
@pytest.mark.parametrize("sq,skv,causal", [(50, 77, True), (50, 77, False), (90, 40, True)])
@pytest.mark.parametrize("rows", [128, 64])
def test_flash_attention_kernel_on_unaligned_views_and_other_key_counts(card, dtype, offset, sq,
                                                                        skv, causal, rows):
    """Skv other than Sq (masks by absolute index, as the plain version),
    and q/k/v views whose base is `offset` elements into their storage:
    16-byte copies at 0, 4-byte ones (fp32) or plain loads (bf16, odd
    offset) otherwise."""
    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator().manual_seed(sq + skv + offset)
    dt = getattr(torch, dtype)

    def view(shape):
        flat = torch.randn(int(torch.tensor(shape).prod()) + offset, generator=gen)
        return flat.to(card, dt)[offset:].view(shape)

    q, k, v = view((1, 8, sq, 32)), view((1, 2, skv, 32)), view((1, 2, skv, 32))
    got = ops._launch(q, k, v, causal, None, rows=rows)
    want = ops.attention_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    atol = 2e-2 if dtype == "bfloat16" else 2e-5
    assert float((got.float() - want.float()).abs().max()) <= atol


def test_flash_attention_wrapper_raises_on_the_card(card):
    from repro_torch.kernels.flash_attention.ops import flash_attention

    q = torch.zeros(1, 2, 8, 64, device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention(q, q, q)
    q = torch.zeros(1, 2, 8, 48, device=card)
    with pytest.raises(ValueError):
        flash_attention(q, q, q)
    with pytest.raises(ValueError):
        flash_attention(q, q[:, :, :, :32], q)


def _ssd_operands(card, bsz, s, h, p, g, n, dtype):
    gen = torch.Generator().manual_seed(s)
    dt_ = getattr(torch, dtype)
    x = torch.randn(bsz, s, h, p, generator=gen).to(card, dt_)
    dt = torch.nn.functional.softplus(torch.randn(bsz, s, h, generator=gen)).to(card)
    a = -torch.exp(torch.randn(h, generator=gen) * 0.5).to(card)
    b = (torch.randn(bsz, s, g, n, generator=gen) / n**0.5).to(card, dt_)
    c = (torch.randn(bsz, s, g, n, generator=gen) / n**0.5).to(card, dt_)
    return x, dt, a, b, c


def _rel(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.mark.parametrize("bsz,s,h,p,g,n,dtype", [
    (1, 2000, 48, 64, 1, 128, "float32"), (2, 320, 4, 64, 2, 32, "float32"),
    (1, 300, 4, 32, 1, 16, "bfloat16"), (1, 333, 8, 32, 2, 64, "bfloat16"),
    (2, 200, 6, 32, 2, 256, "float32"), (1, 129, 4, 64, 2, 16, "bfloat16"),
    (1, 77, 2, 32, 1, 200, "float32")])
def test_ssd_scan_kernel_matches_plain(card, bsz, s, h, p, g, n, dtype):
    """y and the final state against the chunked plain version at rel 1e-4
    (the registry's compare; bf16 inputs are up-cast alike, and y is held
    after its one bf16 rounding at rel 1e-2): fp32 and bf16, G = 1 and 2,
    P = 32 and 64, N from 16 to 256, ragged S."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_chunked

    dt_ = getattr(torch, dtype)
    x, dt, a, b, c = _ssd_operands(card, bsz, s, h, p, g, n, dtype)
    before = ssd_scan.launches
    y, state = ssd_scan(x, dt, a, b, c, return_state=True)
    wy, wstate = ssd_scan_chunked(x, dt, a, b, c, return_state=True)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    assert y.dtype == dt_ and state.dtype == torch.float32
    assert _rel(y, wy) <= (1e-2 if dtype == "bfloat16" else 1e-4)
    assert _rel(state, wstate) <= 1e-4


@pytest.mark.parametrize("bsz,s,h,p,g,n,dtype", [
    (1, 2000, 48, 64, 1, 128, "float32"), (2, 333, 8, 32, 2, 64, "float32"),
    (1, 300, 4, 64, 2, 256, "bfloat16")])
def test_ssd_stage_kernels_match_plain_stages(card, bsz, s, h, p, g, n, dtype):
    """Each stage kernel's launcher, on operands ``ssd_scan`` has checked,
    against its plain stage on the same inputs (the plain outputs of the
    stages before it), rel 1e-4; the mamba2-780m prefill's b/c are views
    of one projection, as the model passes them."""
    from repro_torch.kernels.ssd_scan import ops, ref

    x, dt, a, b, c = _ssd_operands(card, bsz, s, h, p, g, n, dtype)
    if g == 1:
        bc = torch.cat([b, c], dim=-1)
        b, c = bc[..., :n], bc[..., n:]
    ops._check_cuda(x, dt, a, b, c)
    x, dt, b, c = ops._rows(x, dt, b, c)
    cb = ref.ssd_chunk_scores(b, c)
    assert _rel(ops._scores(b, c), cb) <= 1e-4
    st, cum = ref.ssd_chunk_state(x, dt, a, b)
    got_st, got_cum = ops._state(x, dt, a, b)
    assert _rel(got_st, st) <= 1e-4 and _rel(got_cum, cum) <= 1e-4
    # the launchers take the stages' fp32 workspaces contiguous
    cb, st, cum = cb.contiguous(), st.contiguous(), cum.contiguous()
    h_prev, final = ref.ssd_state_passing(st, cum)
    got_h, got_final = ops._passing(st, cum)
    assert _rel(got_h[:, 1:], h_prev[:, 1:]) <= 1e-4 and not got_h[:, 0].any()
    assert _rel(got_final, final) <= 1e-4
    got_y = ops._scan(x, dt, c, cb, cum, h_prev.contiguous())
    assert got_y.dtype == x.dtype
    assert _rel(got_y, ref.ssd_chunk_scan(x, dt, c, cb, cum, h_prev)) <= (
        1e-2 if dtype == "bfloat16" else 1e-4)


@pytest.mark.parametrize("kernel", ["flash_attention", "ssd_scan"])
def test_kernels_without_backward_raise_when_a_gradient_is_wanted(card, kernel):
    """On card operands that require a gradient, under grad mode, the
    kernel raises instead of returning an output with no graph; under
    torch.no_grad() it launches."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    if kernel == "flash_attention":
        fn = flash_attention
        args = [torch.randn(1, 2, 64, 32, device=card) for _ in range(3)]
    else:
        fn = ssd_scan
        args = list(_ssd_operands(card, 1, 130, 2, 32, 1, 16, "float32"))
    for i in range(len(args)):
        wanted = [t.clone().requires_grad_(j == i) for j, t in enumerate(args)]
        with pytest.raises(ValueError, match="no gradient"):
            fn(*wanted)
        before = fn.launches
        with torch.no_grad():
            out = fn(*wanted)
        assert fn.launches == before + 1 and not out.requires_grad


def test_engine_on_the_card_sheds_as_on_the_cpu(card):
    """The reduced llama3.2-1b served on the card with admission deadlines
    of one tick: per request the CPU engine's tokens, finished_by, rejected
    and finish_tick, and its n_rejected; requests 2 and 3 wait behind two
    6-token requests and are shed with "deadline"."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serving_config
    from repro_torch.models.lm import lm_init
    from repro_torch.serving.engine import ServingEngine

    cfg = get_arch("llama3.2-1b").resolve(reduced=True)
    params = lm_init(cfg, 0, device="cpu")
    gen = torch.Generator().manual_seed(3)
    prompts = [torch.randint(0, cfg.vocab, (8 + i,), generator=gen).tolist() for i in range(4)]

    def serve(device):
        p = params if device == "cpu" else _to(params, device)
        eng = ServingEngine(cfg, serving_config("quant_sparse"), params=p, n_slots=2,
                            max_len=64, device=device)
        for prompt in prompts:
            eng.submit_prompt(prompt, 6, deadline_ticks=1)
        return eng.run()

    fields = ("tokens", "finished_by", "rejected", "finish_tick")
    want, got = serve("cpu"), serve(torch.device("cuda", torch.cuda.current_device()))
    assert [{f: r[f] for f in fields} for r in got["per_request"]] == \
        [{f: r[f] for f in fields} for r in want["per_request"]]
    assert got["elastic"] == want["elastic"] == {"rejected": {"deadline": 2}, "n_rejected": 2}
    assert [r["tokens"] for r in got["per_request"][2:]] == [[], []]


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def test_ssd_scan_wrapper_raises_on_the_card(card):
    from repro_torch.kernels.ssd_scan.ops import ssd_scan

    x = torch.zeros(1, 8, 4, 32, device=card, dtype=torch.float16)
    dt, a = torch.zeros(1, 8, 4, device=card), torch.zeros(4, device=card)
    b = torch.zeros(1, 8, 1, 16, device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        ssd_scan(x, dt, a, b, b)
    x, b = torch.zeros(1, 8, 4, 48, device=card), torch.zeros(1, 8, 1, 16, device=card)
    with pytest.raises(ValueError):
        ssd_scan(x, dt, a, b, b)
    with pytest.raises(TypeError):
        ssd_scan(torch.zeros(1, 8, 4, 32, device=card), dt.double(), a, b, b)


@pytest.mark.parametrize("arch,kernel", [("llama3.2-1b", "flash_attention"),
                                         ("mamba2-780m", "ssd_scan")])
def test_engine_on_the_card_runs_the_new_kernels(card, arch, kernel):
    from repro_torch import kernels
    from repro_torch.launch.serve import serve_session

    kernels.reset_launch_counts()
    out = serve_session(arch, reduced=True, mode="quant_sparse", slots=2, queue=3,
                        prompt_len=140, gen=4, device=card)
    counts = kernels.launch_counts()
    assert out["finite"] and all(r["n_tokens"] == 4 for r in out["per_request"])
    n_layers = 3 if arch == "llama3.2-1b" else 4
    assert counts[kernel] == 3 * n_layers  # one per layer of each request's prefill
    assert counts["masked_matmul"] > 0


def _filter_operands(gen, n):
    """Half-sparse operands with -0.0, NaN and inf entries."""
    a = torch.randn(n, generator=gen) * (torch.rand(n, generator=gen) > 0.4)
    w = torch.randn(n, generator=gen) * (torch.rand(n, generator=gen) > 0.4)
    a[::5], w[::7] = -0.0, -0.0
    a[1::11], w[2::13] = float("nan"), float("nan")
    a[3::17], w[4::19] = float("inf"), float("-inf")
    return a, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,offset", [(4099, 0), (4099, 1), (3, 0), (1 << 20, 0), (1000, 2)])
def test_dangling_filter_kernel_bit_equal_to_plain(card, dtype, n, offset):
    """Bit for bit (NaN positions too) on -0.0 / NaN / inf entries, with a
    scalar tail (n not a multiple of the vector width) and on unaligned
    views (``offset``), which take the scalar path."""
    from repro_torch.kernels.mask_compress.ops import dangling_filter, dangling_filter_reference

    a, w = _filter_operands(torch.Generator().manual_seed(n + offset), n + offset)
    dt = getattr(torch, dtype)
    a, w = a.to(card, dt)[offset:], w.to(card, dt)[offset:]
    before = dangling_filter.launches
    got, want = dangling_filter(a, w), dangling_filter_reference(a, w)
    torch.cuda.synchronize()
    assert dangling_filter.launches == before + 1
    view = torch.int32 if dt == torch.float32 else torch.int16
    for g, p in zip(got, want):
        assert g.dtype == dt and g.shape == a.shape
        assert torch.equal(g.view(view), p.view(view))


def test_dangling_filter_wrapper_raises_on_the_card(card):
    from repro_torch.kernels.mask_compress.ops import dangling_filter

    a = torch.ones(8, device=card)
    with pytest.raises(TypeError, match="one dtype"):
        dangling_filter(a, a.to(torch.bfloat16))
    with pytest.raises(TypeError, match="fp32 or bf16"):
        dangling_filter(a.double(), a.double())
    with pytest.raises(ValueError, match="differ"):
        dangling_filter(a, torch.ones(9, device=card))


def test_kernel_sweep_passes_on_the_card(card):
    """``bench_kernels --smoke``'s sweep: every op with a kernel holds its
    plain version on every example under the op's compare, on the card."""
    from repro_torch.benchmarks.bench_kernels import smoke_rows
    from repro_torch.kernels import registry

    rows, failures = smoke_rows(card)
    assert not failures, failures
    routes = {name.split(".")[2]: route for name, _, _, route, _ in rows}
    for op in registry.ops():
        assert routes[op] == ("cuda" if registry.op_spec(op).kernel is not None else "plain")


def test_sparsity_probe_runs_the_kernels(card):
    from repro_torch import kernels
    from repro_torch.kernels.masked_matmul.backward import sparsity_probe

    kernels.reset_launch_counts()
    on_card = sparsity_probe(device=card)
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in ("masked_matmul", "masked_matmul_dx", "masked_matmul_dw"))
    assert on_card == sparsity_probe(device="cpu")
