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


@pytest.mark.parametrize("dim", [0, 1])
def test_stochastic_round_strided_counter_bit_equal_to_plain_and_the_whole(card, dim):
    """Tensor parallelism's weight update: each of four column (dim 1) or
    row (dim 0) shards of a (256, 384) leaf, rounded with the whole leaf's
    counters, equals the plain version and the slice of the whole leaf's
    rounding, bit for bit."""
    from repro_torch.kernels.stochastic_round.ops import (shard_counter, sr_reference,
                                                          stochastic_round)

    whole = (torch.randn(256, 384, generator=torch.Generator().manual_seed(dim)) * 3).to(card)
    rounded = stochastic_round(whole, 21)
    size = whole.shape[dim] // 4
    for r in range(4):
        part = whole.narrow(dim, r * size, size).contiguous()
        base, stride = shard_counter(whole.shape, dim, r * size)
        got = stochastic_round(part, 21, base=base, row_stride=stride)
        assert torch.equal(got, sr_reference(part, 21, base=base, row_stride=stride))
        assert torch.equal(got, rounded.narrow(dim, r * size, size))


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


def test_full_width_lm_train_step_runs_the_path_kernels(card):
    """The example train spec at full width (llama3.2-1b, batch 8, seq 128,
    quant_sparse, SR, Q4.16 SR weights, the sparse backward): one step on
    the card, a finite loss, every parameter on the grid, and every kernel
    of the path launched (every product has M = 1024 or K = 1024 and K <=
    8192, so neither the skinny kernel nor the split-K reduce is on it)."""
    import pathlib

    from repro_torch import kernels
    from repro_torch.api import TrainSession, build_spec
    from repro_torch.launch.train import on_grid
    from repro_torch.optim.optimizers import tree_leaves

    example = pathlib.Path(__file__).parent.parent / "examples/specs/train_quant_sparse.json"
    spec = build_spec("train", spec_file=str(example), use_env=False, sets=[
        "arch.reduced=false", "train.steps=1", "train.ckpt_dir="])
    kernels.reset_launch_counts()
    out = TrainSession(spec, device=card).run()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert all(torch.isfinite(torch.tensor(out["losses"])))
    assert on_grid(dict(enumerate(tree_leaves(out["state"].params))))
    for name in ("masked_matmul", "tile_occupancy", "masked_matmul_dx", "masked_matmul_dw",
                 "stochastic_round"):
        assert counts[name] > 0, counts
    assert counts["flash_attention"] == 0, counts


def test_train_spec_pinning_flash_attention_is_refused_on_the_card(card):
    from repro_torch.api import SpecError, TrainSession, build_spec

    for policy in ("flash_attention=pallas", "pallas"):
        spec = build_spec("train", use_env=False, sets=[f"kernels.policy={policy}"])
        with pytest.raises(SpecError, match="kernels.policy"):
            TrainSession(spec, device=card)


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
    (1, 8, 2, 200, 64, False, None, "float32"),
    # D 128 prefills of minitron-4b (a group of 3) and mistral-nemo-12b (4)
    (1, 24, 8, 512, 128, True, None, "float32"), (1, 32, 8, 512, 128, True, None, "float32"),
    (1, 6, 2, 200, 128, True, None, "float32")]


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


# D 256 (recurrentgemma's local attention: 16 heads on one kv head, a
# window): ragged and aligned S, windows inside one kv tile, across tiles and
# longer than S, and no window
_FA_D256_CASES = [(1, 16, 1, s, w, causal) for s, w, causal in (
    (300, 70, True), (256, 128, True), (512, 128, True), (130, 2048, True), (200, None, True),
    (33, 16, True), (200, None, False))] + [(2, 4, 2, 97, 40, True), (1, 8, 8, 64, 20, True)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,hkv,s,window,causal", _FA_D256_CASES)
def test_flash_attention_kernel_at_head_dim_256(card, b, h, hkv, s, window, causal, dtype):
    """The D 256 instantiation (two warp groups, each half of the d axis)
    against the plain version, q/k/v as transposed (B,S,H,D) projections;
    fp32 atol 2e-5, bf16 2e-2."""
    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator().manual_seed(s + h)
    dt = getattr(torch, dtype)
    q = torch.randn(b, s, h, 256, generator=gen).to(card, dt).transpose(1, 2)
    k = torch.randn(b, s, hkv, 256, generator=gen).to(card, dt).transpose(1, 2)
    v = torch.randn(b, s, hkv, 256, generator=gen).to(card, dt).transpose(1, 2)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ops.attention_reference(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert got.dtype == dt and got.shape == want.shape
    atol = 2e-2 if dtype == "bfloat16" else 2e-5
    assert float((got.float() - want.float()).abs().max()) <= atol
    with pytest.raises(RuntimeError):
        ops._launch(q, k, v, causal, window, rows=128)  # D 256 has the 64-row tile only


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("offset", [1, 2])
def test_flash_attention_d256_on_unaligned_views(card, dtype, offset):
    """D 256 through 4-byte copies (fp32) or plain loads (bf16, odd offset)."""
    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator().manual_seed(offset)
    dt = getattr(torch, dtype)

    def view(shape):
        flat = torch.randn(int(torch.tensor(shape).prod()) + offset, generator=gen)
        return flat.to(card, dt)[offset:].view(shape)

    q, k, v = view((1, 16, 150, 256)), view((1, 1, 150, 256)), view((1, 1, 150, 256))
    got = ops.flash_attention(q, k, v, causal=True, window=50)
    want = ops.attention_reference(q, k, v, causal=True, window=50)
    torch.cuda.synchronize()
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
    # every elastic counter equal, but the watchdog's slow_ticks, a timing
    untimed = [{k: v for k, v in out["elastic"].items() if k != "slow_ticks"}
               for out in (got, want)]
    assert untimed[0] == untimed[1]
    assert got["elastic"]["rejected"] == {"deadline": 2} and got["elastic"]["n_rejected"] == 2
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


# -- the MoE family: the MoE FFN, MLA and the latent pool on the card ----------------


def _moe_ctx():
    from repro_torch.launch.serve import serving_config
    from repro_torch.models.layers import SpringContext

    return SpringContext(cfg=serving_config("quant_sparse"))


@pytest.mark.parametrize("shape", [(1, 512, 64), (4, 1, 64)], ids=["prefill", "decode"])
def test_moe_apply_on_the_card_matches_the_cpu(card, shape):
    """A reduced MoE FFN (8 experts, top-2, 2 shared, capacity factor 0.5,
    so a prefill of 512 tokens drops assignments and fills a capacity of
    64 rows: the tile kernel; a decode step of 4 rows: the skinny kernel),
    quant_sparse, on the card against its CPU run: the same experts and
    kept assignments, y within 1e-3 (fp32 sums in another order move a
    quantized activation by one 2**-16 step at most), the aux loss at rel
    1e-5; the experts' products launched masked_matmul."""
    from repro_torch.kernels.masked_matmul.ops import masked_matmul
    from repro_torch.models.moe import MoESpec, moe_apply, moe_init, record_routing

    spec = MoESpec(n_experts=8, top_k=2, d_ff=48, n_shared=2, shared_d_ff=48,
                   capacity_factor=0.5)
    gen = torch.Generator().manual_seed(7)
    params = moe_init(gen, 64, spec, device="cpu")
    x = torch.randn(shape, generator=gen)
    ctx = _moe_ctx()
    with record_routing() as r_cpu:
        want, want_aux = moe_apply(params, x, ctx, spec)
    before = masked_matmul.launches
    with record_routing() as r_gpu:
        got, aux = moe_apply(_to(params, card), x.to(card), ctx, spec)
    torch.cuda.synchronize()
    assert masked_matmul.launches - before >= 3 * spec.n_experts
    assert torch.equal(r_gpu[0]["gate_idx"].cpu(), r_cpu[0]["gate_idx"])
    assert torch.equal(r_gpu[0]["keep"].cpu(), r_cpu[0]["keep"])
    assert bool((~r_cpu[0]["keep"]).any()) == (shape[1] > 1)
    assert float((got.cpu() - want).abs().max()) <= 1e-3
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-5)


def test_mla_apply_on_the_card_matches_the_cpu(card):
    """Reduced MLA, quant_sparse: a prefill of 2 x 40 tokens (the chunked
    attention: flash_attention never launches), then two absorbed decode
    steps at per-row positions, on the card against the CPU: outputs within
    1e-3, the bf16 latent caches within 1 bf16 ulp at their largest
    magnitudes."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.models.attention import MLASpec, mla_apply, mla_init

    spec = MLASpec(n_heads=4, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)
    gen = torch.Generator().manual_seed(8)
    params = mla_init(gen, 64, spec, device="cpu")
    ctx = _moe_ctx()
    x = torch.randn(2, 40, 64, generator=gen)
    positions = torch.arange(40).expand(2, 40)

    def close_caches(got, want):
        for name in ("ckv", "krope"):
            w = want[name].float()
            ulp = 2.0 ** (torch.floor(torch.log2(w.abs().max())) - 7)
            assert float((got[name].float().cpu() - w).abs().max()) <= float(ulp), name

    before = flash_attention.launches
    want, c_cpu = mla_apply(params, x, ctx, spec, positions, return_cache=True)
    got, c_gpu = mla_apply(_to(params, card), x.to(card), ctx, spec, positions.to(card),
                           return_cache=True)
    assert flash_attention.launches == before
    assert float((got.cpu() - want).abs().max()) <= 1e-3
    close_caches(c_gpu, c_cpu)
    cache = {n: torch.nn.functional.pad(c, (0, 0, 0, 4)) for n, c in c_cpu.items()}
    pos = torch.tensor([40, 37])
    for i in range(2):
        xs = torch.randn(2, 1, 64, generator=gen)
        want, c_cpu = mla_apply(params, xs, ctx, spec, pos[:, None], cache=cache, pos=pos)
        got, c_gpu = mla_apply(_to(params, card), xs.to(card), ctx, spec, pos[:, None].to(card),
                               cache=_to(cache, card), pos=pos.to(card))
        assert float((got.cpu() - want).abs().max()) <= 1e-3
        close_caches(c_gpu, c_cpu)
        cache, pos = c_cpu, pos + 1


def test_latent_pool_packs_on_the_card_as_on_the_cpu(card):
    """Reduced deepseek-v2-lite-16b's packed pool (the ckv / krope leaves
    under prefix_0, slot axis 0, and unit_0, slot axis 1): one prefill
    cache installed in slot 1 on the card and on the CPU gives the same
    values, mask words and nnz, bit for bit; the card's pool unpacks to
    the cache's bits, and a slot payload moved to slot 2 reads back the
    same."""
    from repro_torch.configs import get_arch
    from repro_torch.models.lm import lm_init, lm_prefill
    from repro_torch.serving import kvpool

    cfg = get_arch("deepseek-v2-lite-16b").resolve(reduced=True)
    params = lm_init(cfg, 0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (1, 21), generator=torch.Generator().manual_seed(9))
    _, pc = lm_prefill(params, cfg, toks, _moe_ctx())
    pools = {}
    for device in ("cpu", card):
        pools[str(device)] = pool = kvpool.init_pool(cfg, 3, 32, device=device)
        kvpool.install_packed(pool, _to(pc, device), 1, 21)
    cpu_pool, card_pool = pools["cpu"], pools[str(card)]
    for key in ("prefix_0", "unit_0"):
        for name in ("ckv", "krope"):
            for part in ("values", "mask", "nnz"):
                a = kvpool.word_view(getattr(card_pool[key][name], part)).cpu()
                b = kvpool.word_view(getattr(cpu_pool[key][name], part))
                assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                                   b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
    kvpool.restore_slot_packed(card_pool, kvpool.extract_slot_packed(card_pool, 1), 2)
    dense = kvpool.unpack_cache(card_pool)
    for key, ax in (("prefix_0", 0), ("unit_0", 1)):
        for name in ("ckv", "krope"):
            for slot in (1, 2):
                row = dense[key][name].select(ax, slot).cpu()
                want = pc[key][name].select(ax, 0)
                assert torch.equal(row.narrow(-2, 0, 21).view(torch.int16),
                                   want.view(torch.int16))
                assert not row.narrow(-2, 21, 11).any()


# -- slice 15: internvl2-26b's GQA group of 6, whisper-medium ---------------------------


@pytest.mark.parametrize("s", [768, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_at_internvl2s_group_of_6(card, s, dtype):
    """internvl2-26b's prefill attention (48 heads on 8 kv heads, D 128; S
    768 = its 256 image positions + 512 text, and a ragged S): the plan
    packs 2 heads of a group into each 64-row tile; against the plain
    version at the registry's compare, on the planned tile and forced."""
    from repro_torch.kernels.flash_attention import ops

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    p = ops.plan(1, 48, 8, s, 128, n_sms)
    assert (p.rows, p.heads_per_cta) == (64, 2)
    gen = torch.Generator().manual_seed(s)
    dt = getattr(torch, dtype)
    q = torch.randn(1, s, 48, 128, generator=gen).to(card, dt).transpose(1, 2)
    k = torch.randn(1, s, 8, 128, generator=gen).to(card, dt).transpose(1, 2)
    v = torch.randn(1, s, 8, 128, generator=gen).to(card, dt).transpose(1, 2)
    want = ops.attention_reference(q, k, v, causal=True)
    atol = 2e-2 if dtype == "bfloat16" else 2e-5
    for got in (ops.flash_attention(q, k, v, causal=True),
                ops._launch(q, k, v, True, None, rows=64)):
        torch.cuda.synchronize()
        assert got.dtype == dt and float((got.float() - want.float()).abs().max()) <= atol


def test_reduced_whisper_static_run_on_the_card(card):
    """The reduced whisper-medium's static session from one CPU init: the
    card's greedy tokens equal the CPU's, every decode product on the
    skinny kernel; the first decode step from the CPU's cache within 1e-3
    of the CPU's logits (the dense encoder's bf16 roundings flip under
    another sum order, so each device's own cache is held to rel 3e-2)."""
    from repro_torch import kernels
    from repro_torch.api import ServeSession, build_spec
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serving_config
    from repro_torch.models.encdec import encdec_decode_step, encdec_init, encdec_init_cache
    from repro_torch.models.layers import SpringContext

    cfg = get_arch("whisper-medium").resolve(reduced=True)
    params = encdec_init(cfg, 0, device="cpu")
    spec = build_spec("serve", sets=["arch.id=whisper-medium", "numerics.mode=quant_sparse",
                                     "shape.batch=3", "shape.prompt_len=6", "shape.gen=8"],
                      use_env=False)
    want = ServeSession(spec, params=params, device="cpu").run()
    kernels.reset_launch_counts()
    got = ServeSession(spec, params=_to(params, card), device=card).run()
    launches = kernels.launch_counts()
    assert got["finite"] and got["generated"].tolist() == want["generated"].tolist()
    assert launches["masked_matmul_skinny"] == launches["masked_matmul"] == 8 * 2 * 8
    gen = torch.Generator().manual_seed(3)
    frames = torch.randn(2, cfg.enc_seq, cfg.d_model, generator=gen).to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab, (2,), generator=gen)
    ctx = SpringContext(cfg=serving_config("quant_sparse"))
    caches = [encdec_init_cache(_to(params, d), cfg, frames.to(d), SpringContext(), 4)
              for d in ("cpu", card)]
    for n in ("k", "v"):
        want = caches[0]["cross"][n].float()
        got = caches[1]["cross"][n].float().cpu()
        assert float((got - want).abs().max()) <= 3e-2 * float(want.abs().max())
    logits = [encdec_decode_step(_to(params, d), cfg, toks.to(d), _to(caches[0], d), ctx)[0].cpu()
              for d in ("cpu", card)]
    assert float((logits[1] - logits[0]).abs().max()) <= 1e-3


def test_ssd_scan_trainable_on_the_card_at_mamba2s_shapes(card):
    """The SSD scan's autograd Function at mamba2-780m's training shapes
    (batch 8, S 128, H 48, P 64, N 128, one group): its forward is the
    kernel's (one counted launch, y and the state equal to ``ssd_scan``'s
    under no_grad), its gradients are autograd's through the chunked plain
    version on the same card operands (the backward recomputes that form:
    rel 1e-5, fp32 sums of the same ops), and the bare wrapper still raises
    when a gradient is wanted."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_chunked, ssd_scan_trainable

    ops = _ssd_operands(card, 8, 128, 48, 64, 1, 128, "float32")
    gen = torch.Generator().manual_seed(9)
    gy = torch.randn(8, 128, 48, 64, generator=gen).to(card)
    gs = torch.randn(8, 48, 128, 64, generator=gen).to(card)

    def run(fn):
        ins = [t.clone().requires_grad_(True) for t in ops]
        y, state = fn(*ins, return_state=True)
        grads = torch.autograd.grad((y * gy).sum() + (state * gs).sum(), ins)
        return y.detach(), state.detach(), grads

    before = ssd_scan.launches
    y, state, grads = run(ssd_scan_trainable)
    torch.cuda.synchronize()
    assert ssd_scan.launches == before + 1
    with torch.no_grad():
        want_y, want_state = ssd_scan(*ops, return_state=True)
    assert torch.equal(y, want_y) and torch.equal(state, want_state)
    _, _, want = run(ssd_scan_chunked)
    for got, w in zip(grads, want):
        assert _rel(got, w) <= 1e-5
    with pytest.raises(ValueError, match="no gradient"):
        ssd_scan(*(t.clone().requires_grad_(True) for t in ops))


def _train_lm_grads(params, cfg, tokens, spring):
    from repro_torch.models.layers import SpringContext
    from repro_torch.models.lm import lm_loss
    from repro_torch.optim.optimizers import tree_leaves, tree_map

    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    loss, _ = lm_loss(p, cfg, tokens, SpringContext(cfg=spring, attention="chunked"))
    return float(loss.detach()), [g.cpu() for g in torch.autograd.grad(loss, tree_leaves(p))]


def test_reduced_olmoe_train_step_on_the_card_matches_the_cpu(card):
    """Reduced olmoe-1b-7b, quant_sparse with nearest rounding on Q16.60
    (where rounding is the identity, so the card's fp32 sum order moves no
    value by a grid step): one make_train_step step (AdamW) on the card and
    on the CPU from the same weights, losses rel 1e-4, the experts' products
    and their dx / dw on the kernels; lm_loss's gradients within DESIGN.md
    §8's contract (rtol 1e-5, floor 1e-5 x (max + 1))."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.core.fixedpoint import FixedPointFormat
    from repro_torch.core.spring_ops import QUANT_SPARSE
    from repro_torch.optim.optimizers import tree_map
    from repro_torch.runtime.train import StepConfig, init_train_state, make_train_step

    view = get_arch("olmoe-1b-7b").view(reduced=True)
    spring = dataclasses.replace(QUANT_SPARSE, stochastic=False,
                                 fmt=FixedPointFormat(il=16, fl=60))
    step_cfg = StepConfig(spring=spring)
    params = init_train_state(view, step_cfg, 0, device="cpu").params
    tokens = torch.randint(0, view.config.vocab, (4, 33), generator=torch.Generator()
                           .manual_seed(2))
    loss_c, grads_c = _train_lm_grads(params, view.config, tokens, spring)
    loss_g, grads_g = _train_lm_grads(_to(params, card), view.config, tokens.to(card), spring)
    # the step updates its state in place: each device starts from a copy
    _, want = make_train_step(view, step_cfg)(
        init_train_state(tree_map(torch.clone, params), step_cfg, 0), {"tokens": tokens})
    kernels.reset_launch_counts()
    _, got = make_train_step(view, step_cfg)(init_train_state(_to(params, card), step_cfg, 0),
                                             {"tokens": tokens.to(card)})
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-4)
    for name in ("masked_matmul", "masked_matmul_dx", "masked_matmul_dw"):
        assert counts[name] > 0, counts
    assert loss_g == pytest.approx(loss_c, rel=1e-4)
    for g, w in zip(grads_g, grads_c):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * (float(w.abs().max()) + 1.0))


# -- magnitude pruning and the lossy stash ------------------------------------------


def test_reduced_pruned_llama_train_step_on_the_card_matches_the_cpu(card):
    """Reduced llama3.2-1b with every dense projection pruned at 0.5,
    quant_sparse with nearest rounding on Q16.60: the pruned masks equal on
    both devices (the card's std sums in another order; a weight within an
    ulp of the threshold would be named), lm_loss rel 1e-4 and its
    gradients within the contract; one make_train_step step with
    StepConfig(prune_ratio=0.5) on the kernels, loss rel 1e-4."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.core.fixedpoint import FixedPointFormat
    from repro_torch.core.spring_ops import QUANT_SPARSE
    from repro_torch.models.layers import SpringContext
    from repro_torch.models.lm import lm_loss
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    from repro_torch.runtime.train import StepConfig, init_train_state, make_train_step

    view = get_arch("llama3.2-1b").view(reduced=True)
    spring = dataclasses.replace(QUANT_SPARSE, stochastic=False,
                                 fmt=FixedPointFormat(il=16, fl=60))
    step_cfg = StepConfig(spring=spring, prune_ratio=0.5)
    params = init_train_state(view, step_cfg, 0, device="cpu").params
    prune = SpringContext(prune_ratio=0.5).maybe_prune
    for w in tree_leaves(params):
        if w.ndim == 2 and w.shape[0] != view.config.vocab:
            assert torch.equal(prune(w) == 0, (prune(w.to(card)) == 0).cpu())
    tokens = torch.randint(0, view.config.vocab, (4, 33), generator=torch.Generator()
                           .manual_seed(2))
    res = {}
    for d in ("cpu", card):
        p = tree_map(lambda t: t.detach().to(d).clone().requires_grad_(True), params)
        loss, _ = lm_loss(p, view.config, tokens.to(d),
                          SpringContext(cfg=spring, prune_ratio=0.5, attention="chunked"))
        res[str(d)] = (float(loss.detach()),
                       [g.cpu() for g in torch.autograd.grad(loss, tree_leaves(p))])
    (loss_c, grads_c), (loss_g, grads_g) = res["cpu"], res[str(card)]
    assert loss_g == pytest.approx(loss_c, rel=1e-4)
    for g, w in zip(grads_g, grads_c):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5 * (float(w.abs().max()) + 1.0))
    _, want = make_train_step(view, step_cfg)(
        init_train_state(tree_map(torch.clone, params), step_cfg, 0), {"tokens": tokens})
    kernels.reset_launch_counts()
    _, got = make_train_step(view, step_cfg)(init_train_state(_to(params, card), step_cfg, 0),
                                             {"tokens": tokens.to(card)})
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-4)
    for name in ("masked_matmul", "masked_matmul_dx", "masked_matmul_dw"):
        assert counts[name] > 0, counts


def _tiny_cnn(store, ctx, x):
    from repro_torch.models import cnn

    x = cnn.conv(store, ctx, "c1", x, 16, k=3, stride=2)
    x = cnn.conv(store, ctx, "c2", x, 32, k=3, stride=2)
    x = cnn.conv(store, ctx, "c3", x, 32, k=3)
    return cnn.fc(store, ctx, "head", cnn.gap(x), 10)


@pytest.mark.parametrize("capacity", [0.6, 0.25])
def test_lossy_stash_record_and_gradients_on_the_card_match_the_cpu(card, capacity):
    """A lossy record on the card is the CPU's bit for bit (values, mask,
    nnz, overflow); the tiny CNN's gradients with every point stashed at
    ``capacity`` (quant_sparse, nearest, Q16.60, the sparse backward) on
    the card within the contract of the CPU's, the first conv's input
    overflowing on both."""
    import dataclasses

    from repro_torch.core.fixedpoint import FixedPointFormat
    from repro_torch.core.spring_ops import QUANT_SPARSE, KeyGen
    from repro_torch.memstash import format as fmt
    from repro_torch.memstash.config import MemstashConfig
    from repro_torch.memstash.instrument import record_stash_traffic
    from repro_torch.models.cnn import ParamStore
    from repro_torch.models.layers import SpringContext
    from repro_torch.runtime.train import cross_entropy

    gen = torch.Generator().manual_seed(4)
    x = torch.relu(torch.randn(8, 33, 17, generator=gen)) * (torch.rand(8, 33, 17, generator=gen)
                                                              > 0.2)
    a, b = fmt.compress(x, capacity), fmt.compress(x.to(card), capacity)
    for f in ("values", "mask", "nnz", "overflow"):
        assert torch.equal(getattr(a, f), getattr(b, f).cpu()), f
    assert torch.equal(fmt.decompress(a), fmt.decompress(b).cpu())

    spring = dataclasses.replace(QUANT_SPARSE, stochastic=False,
                                 fmt=FixedPointFormat(il=16, fl=60))
    scfg = MemstashConfig(policy="stash", min_elems=1, capacity=capacity)
    store = ParamStore(0)
    _tiny_cnn(store, SpringContext(), torch.zeros(1, 16, 16, 3))
    params = store.params
    img = torch.randn(8, 16, 16, 3, generator=gen)
    y = torch.arange(8) % 10
    res = {}
    for d in ("cpu", card):
        p = {k: v.to(d).clone().requires_grad_(True) for k, v in params.items()}
        ctx = SpringContext(cfg=spring, keys=KeyGen(0), memstash=scfg)
        with record_stash_traffic() as rows:
            loss = cross_entropy(_tiny_cnn(ParamStore(0, p), ctx, img.to(d)), y.to(d))
        loss.backward()
        res[str(d)] = (float(loss.detach()), {k: v.grad.cpu() for k, v in p.items()}, rows)
    (loss_c, grads_c, rows_c), (loss_g, grads_g, rows_g) = res["cpu"], res[str(card)]
    assert rows_c == rows_g and rows_c[0]["overflow"] > 0
    assert loss_g == pytest.approx(loss_c, rel=1e-4)
    for k in grads_c:
        torch.testing.assert_close(grads_g[k], grads_c[k], rtol=1e-5,
                                   atol=1e-5 * (float(grads_c[k].abs().max()) + 1.0))


def test_apply_pruning_past_2_24_elements_on_the_card_matches_the_cpu(card):
    """A (4099, 4097) weight, 16.8 M elements, past torch.quantile's limit
    and where jax's fp32 index ``q * (n - 1)`` rounds: the card's sort
    prunes the same entries as the CPU's, and the threshold is the same."""
    from repro_torch.runtime.pruning import PruneSchedule, apply_pruning, quantile_f32

    w = torch.randn(4099, 4097, generator=torch.Generator().manual_seed(0))
    assert w.numel() > 2**24
    sched = PruneSchedule(final_sparsity=0.5, start_step=0, ramp_steps=3)
    for step in (1, 3):
        got = apply_pruning({"w": w.to(card)}, step, sched)["w"]
        want = apply_pruning({"w": w}, step, sched)["w"]
        assert torch.equal(got.cpu(), want)
    assert torch.equal(quantile_f32(w.to(card).abs(), 0.3).cpu(), quantile_f32(w.abs(), 0.3))


def test_two_gloo_ranks_on_one_card_train_as_the_unsharded_step(card, tmp_path):
    """Phase 8's layout: two gloo ranks sharing cuda:0 (card tensors staged
    through the host at each hop) train the reduced llama3.2-1b at
    shape.mesh.data=2 (quant_sparse, nearest); every rank's losses and
    parameters are the unsharded run's bits, and the packed exchange took
    its mask words from the mask_pack kernel."""
    import _torch_mesh_ranks as R
    from repro_torch.api.sessions import TrainSession
    from repro_torch.api.spec import build_spec
    from repro_torch.dist import launch
    from repro_torch.kernels import cuda
    from repro_torch.optim.optimizers import tree_leaves

    cuda.build()  # the ranks only load the libraries
    ranks = launch.run(R.card_train, 2, timeout_s=300, store_dir=str(tmp_path))
    want = TrainSession(build_spec("train", sets=R.TRAIN_SETS, use_env=False), device=card).run()
    params = torch.cat([p.reshape(-1) for p in tree_leaves(want["state"].params)]).cpu()
    for r in ranks:
        assert r["backend"] == "gloo" and r["staged_hops"] > 0, (r["backend"], r["staged_hops"])
        assert r["losses"] == want["losses"], (r["losses"], want["losses"])
        diff = (r["params"] != params).nonzero()
        assert diff.numel() == 0, (diff[:8].tolist(), int(diff.numel()))
        assert r["launches"]["mask_pack"] > 0 and r["launches"]["masked_matmul"] > 0, r["launches"]


def test_two_gloo_ranks_on_one_card_serve_tensor_parallel_as_the_cpu(card, tmp_path):
    """Tensor parallelism on the card: two gloo ranks sharing cuda:0 serve
    the reduced llama3.2-1b static at shape.mesh.model=2 (quant_sparse),
    each on its shards of one CPU init's weights, every hop staged through
    the host; both ranks' tokens are the CPU's unsharded tokens from the
    same weights, and the kernels ran at the shard shapes."""
    import _torch_mesh_ranks as R
    import _torch_tp_ranks as T
    from repro_torch.api.sessions import ServeSession
    from repro_torch.api.spec import build_spec
    from repro_torch.dist import launch
    from repro_torch.kernels import cuda

    from repro_torch.configs import get_arch
    from repro_torch.models.lm import lm_init

    cuda.build()  # the ranks only load the libraries
    params = lm_init(get_arch("llama3.2-1b").reduced(), 0, device="cpu")
    ranks = launch.run(T.card_tp_serve, 2, (params,), timeout_s=300, store_dir=str(tmp_path))
    want = ServeSession(build_spec("serve", sets=R.SERVE_SETS + ["numerics.mode=quant_sparse"],
                                   use_env=False), device="cpu",
                        params=params).run()["generated"].tolist()
    for r in ranks:
        assert r["backend"] == "gloo" and r["report"]["staged_hops"] > 0, r["report"]
        assert r["generated"] == want, (r["generated"], want)
        for name in ("masked_matmul", "masked_matmul_skinny", "flash_attention"):
            assert r["launches"][name] > 0, r["launches"]


def test_two_gloo_ranks_on_one_card_serve_expert_parallel_as_the_cpu(card, tmp_path):
    """Expert parallelism on the card: two gloo ranks sharing cuda:0 serve
    the reduced olmoe-1b-7b at shape.mesh.model=2 (quant_sparse), static
    and through the engine, each on its shards (4 of the 8 experts, its
    heads and vocabulary) of one CPU init's weights; both ranks' tokens
    are the CPU's unsharded tokens from the same weights, and the expert
    products ran on the masked_matmul kernels."""
    import _torch_ep_ranks as P
    from repro_torch.api.sessions import ServeSession
    from repro_torch.configs import get_arch
    from repro_torch.dist import launch
    from repro_torch.kernels import cuda
    from repro_torch.models.lm import lm_init

    cuda.build()  # the ranks only load the libraries
    params = lm_init(get_arch(P.CKPT_ARCH).reduced(), 0, device="cpu")
    ranks = launch.run(P.card_ep_serve, 2, (params,), timeout_s=300, store_dir=str(tmp_path))
    for name, sets in (("static", P.STATIC_SETS), ("engine", P.ENGINE_SETS)):
        want = P._tokens(ServeSession(P.spec("serve", P.CKPT_ARCH,
                                             sets + ["numerics.mode=quant_sparse"]),
                                      device="cpu", params=params).run())
        for r in ranks:
            assert r["backend"] == "gloo" and r["report"]["staged_hops"] > 0, r["report"]
            assert r[name] == want, (name, r[name], want)
    for r in ranks:
        for kname in ("masked_matmul", "masked_matmul_skinny", "flash_attention"):
            assert r["launches"][kname] > 0, r["launches"]


def test_two_gloo_ranks_on_one_card_serve_the_ssm_and_rglru_blocks_as_the_cpu(card, tmp_path):
    """The SSM and RG-LRU blocks over model on the card: two gloo ranks
    sharing cuda:0 serve the reduced mamba2-780m (2 of its 4 SSM heads a
    rank) and recurrentgemma-9b (32 of its 64 RG-LRU channels, 2 of its 4
    local heads on the one kv head) at shape.mesh.model=2 (quant_sparse),
    static and through the engine, each on its shards of one CPU init's
    weights; both ranks' tokens are the CPU's unsharded tokens from the
    same weights, and the blocks ran on the ssd_scan, masked_matmul and
    flash_attention kernels."""
    import _torch_ssm_tp_ranks as P
    from repro_torch.api.sessions import ServeSession
    from repro_torch.configs import get_arch
    from repro_torch.dist import launch
    from repro_torch.kernels import cuda
    from repro_torch.models.lm import lm_init

    cuda.build()  # the ranks only load the libraries
    params = {arch: lm_init(get_arch(arch).reduced(), 0, device="cpu") for arch in P.ARCHS}
    ranks = launch.run(P.card_ssm_serve, 2, (params,), timeout_s=300, store_dir=str(tmp_path))
    for arch in P.ARCHS:
        for name, sets in (("static", P.STATIC_SETS), ("engine", P.ENGINE_SETS)):
            want = P._tokens(ServeSession(P.spec("serve", arch,
                                                 sets + ["numerics.mode=quant_sparse"]),
                                          device="cpu", params=params[arch]).run())
            for r in ranks:
                report = r[f"{arch}/report"]
                assert r["backend"] == "gloo" and report["staged_hops"] > 0, report
                assert r[f"{arch}/{name}"] == want, (arch, name, r[f"{arch}/{name}"], want)
    for r in ranks:
        for kname in ("masked_matmul", "masked_matmul_skinny", "flash_attention", "ssd_scan"):
            assert r["launches"][kname] > 0, r["launches"]


def test_two_gloo_ranks_on_one_card_serve_their_card_init_as_the_card_unsharded(card, tmp_path):
    """Two model=2 ranks on cuda:0 drawing the session's own seeded init on
    the card serve the unsharded card session's tokens from that init.
    The card's generator is not the CPU's, so a card init is not the CPU
    init of the same seed: a comparison with the CPU's tokens takes the
    CPU's weights (the test above)."""
    import _torch_mesh_ranks as R
    import _torch_tp_ranks as T
    from repro_torch.api.sessions import ServeSession
    from repro_torch.api.spec import build_spec
    from repro_torch.configs import get_arch
    from repro_torch.dist import launch
    from repro_torch.kernels import cuda
    from repro_torch.models.lm import lm_init
    from repro_torch.optim.optimizers import tree_leaves

    cuda.build()  # the ranks only load the libraries
    cfg = get_arch("llama3.2-1b").reduced()
    assert not all(torch.equal(a.cpu(), b) for a, b in zip(
        tree_leaves(lm_init(cfg, 0, device=card)), tree_leaves(lm_init(cfg, 0, device="cpu"))))
    ranks = launch.run(T.card_tp_serve, 2, (None,), timeout_s=300, store_dir=str(tmp_path))
    want = ServeSession(build_spec("serve", sets=R.SERVE_SETS + ["numerics.mode=quant_sparse"],
                                   use_env=False), device=card).run()["generated"].tolist()
    for r in ranks:
        assert r["generated"] == want, (r["generated"], want)
