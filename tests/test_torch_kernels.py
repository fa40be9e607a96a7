"""Port parity, kernel level: ``repro_torch`` against ``repro`` on the CPU.

The same numpy inputs go through the JAX function (its plain reference,
and the Pallas kernel in interpret mode where there is one) and through
the port's counterpart, which on CPU tensors is the kernel's plain
version.  Everything here is exact: counter hashing, rounding and mask
words are integer or correctly-rounded operations, and the matmul cases
use coarse-grid operands whose products and sums are exact in fp32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import fixedpoint as jfp  # noqa: E402
from repro.core import masking as jmask  # noqa: E402
from repro.kernels import prng as jprng  # noqa: E402
from repro.kernels import registry  # noqa: E402
from repro.kernels.kv_cache import ops as jkv  # noqa: E402
from repro.kernels.kv_cache.ref import kv_pack_reference, kv_unpack_reference  # noqa: E402
from repro.kernels.mask_compress import ops as jmc  # noqa: E402
from repro.kernels.mask_compress.ref import mask_pack_reference as np_mask_pack  # noqa: E402
from repro.kernels.masked_matmul import ops as jmm  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.core import fixedpoint as tfp  # noqa: E402
from repro_torch.core import masking as tmask  # noqa: E402
from repro_torch.kernels import prng as tprng  # noqa: E402
from repro_torch.kernels.kv_cache import ops as tkv  # noqa: E402
from repro_torch.kernels.mask_compress import ops as tmc  # noqa: E402
from repro_torch.kernels.masked_matmul import ops as tmm  # noqa: E402


def to_torch(a) -> "torch.Tensor":
    """numpy / jax array -> torch tensor with the same bits (bf16 too)."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def to_numpy(t: "torch.Tensor") -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view(jnp.bfloat16)
    return t.numpy()


# -- (a) prng, fixed point, masking: bit-exact --------------------------------


@pytest.mark.parametrize("seed", [0, 1, 5, 0x9E3779B9, 2**32 - 1])
def test_hash_and_uniform_bit_exact(seed):
    rng = np.random.default_rng(seed % 1000)
    counters = np.concatenate([
        rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32),
        np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)])
    want = np.asarray(jprng.hash_uint32(jnp.asarray(counters), jnp.uint32(seed)))
    got = tprng.hash_uint32(torch.from_numpy(counters.astype(np.int64)), seed)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    u_want = np.asarray(jprng.uniform_from_bits(jnp.asarray(want)))
    np.testing.assert_array_equal(tprng.uniform_from_bits(got).numpy(), u_want)


@pytest.mark.parametrize("il,fl", [(4, 16), (2, 6)])
def test_quantize_nearest_bit_exact(il, fl):
    rng = np.random.default_rng(il * 100 + fl)
    eps = 2.0**-fl
    x = np.concatenate([
        rng.standard_normal(20000).astype(np.float32) * 4,
        rng.uniform(-40, 40, 1000).astype(np.float32),       # clipped both ways
        ((np.arange(-600, 600) + 0.5) * eps).astype(np.float32),  # exact ties: half to even
        np.array([0.0, -0.0, 2**il, -(2**il), 2**il - eps / 2], np.float32)])
    fmt_j, fmt_t = jfp.FixedPointFormat(il, fl), tfp.FixedPointFormat(il, fl)
    want = np.asarray(jfp.quantize_nearest(jnp.asarray(x), fmt_j))
    got = tfp.quantize_nearest(torch.from_numpy(x), fmt_t).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_quantize_stochastic_from_bits_bit_exact():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(30000) * 6).astype(np.float32)
    bits = rng.integers(0, 2**32, x.shape, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jfp.quantize_stochastic_from_bits(jnp.asarray(bits), jnp.asarray(x)))
    got = tfp.quantize_stochastic_from_bits(torch.from_numpy(bits.astype(np.int64)),
                                            torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n,density", [(1, 1.0), (31, 0.5), (32, 0.3), (1000, 0.6),
                                       (4096, 0.0), (777, 1.0)])
def test_masking_functions_bit_exact(n, density):
    rng = np.random.default_rng(n)
    bits = rng.random(n) < density
    vals = rng.standard_normal(n).astype(np.float32) * bits
    words_j = np.asarray(jmask.pack_mask_bits(jnp.asarray(bits)))
    words_t = tmask.pack_mask_bits(torch.from_numpy(bits))
    assert words_t.dtype == torch.uint32
    np.testing.assert_array_equal(words_t.numpy(), words_j)
    np.testing.assert_array_equal(
        tmask.unpack_mask_bits(words_t, n).numpy(),
        np.asarray(jmask.unpack_mask_bits(jnp.asarray(words_j), n)))
    for cap in (n, max(1, n // 2)):  # capacity < nnz drops the overflow
        col_j = np.asarray(jmask.collapse_to_front(jnp.asarray(vals), jnp.asarray(bits), cap))
        col_t = tmask.collapse_to_front(torch.from_numpy(vals), torch.from_numpy(bits), cap)
        np.testing.assert_array_equal(col_t.numpy(), col_j)
        exp_j = np.asarray(jmask.expand_from_mask(jnp.asarray(col_j), jnp.asarray(bits)))
        exp_t = tmask.expand_from_mask(col_t, torch.from_numpy(bits))
        np.testing.assert_array_equal(exp_t.numpy(), exp_j)


def test_masking_batched_rows_equal_per_row():
    """The port's functions take a leading batch of blocks; each row must be
    what the reference computes for that block alone."""
    rng = np.random.default_rng(3)
    vals = (rng.standard_normal((5, 70)) * (rng.random((5, 70)) < 0.5)).astype(np.float32)
    bits = vals != 0
    words = tmask.pack_mask_bits(torch.from_numpy(bits))
    col = tmask.collapse_to_front(torch.from_numpy(vals), torch.from_numpy(bits), 70)
    for r in range(5):
        np.testing.assert_array_equal(words[r].numpy(),
                                      np.asarray(jmask.pack_mask_bits(jnp.asarray(bits[r]))))
        np.testing.assert_array_equal(col[r].numpy(), np.asarray(jmask.collapse_to_front(
            jnp.asarray(vals[r]), jnp.asarray(bits[r]), 70)))


# -- (b) masked_matmul: plain version vs _mm_ref and the interpret kernel ------


MM_CASES = jmm._examples()


@pytest.mark.parametrize("case", range(len(MM_CASES)))
def test_masked_matmul_plain_matches_reference_and_interpret(case):
    """Exact on the reference's registry examples (coarse-grid operands), SR
    on and off; the CPU wrapper counts no kernel launch."""
    (x, w, seed), kw = MM_CASES[case][0], MM_CASES[case][1]
    want_ref = np.asarray(jmm._mm_ref(x, w, seed, **kw))
    want_int = np.asarray(registry.impls("masked_matmul")["interpret"].fn(x, w, seed, **kw))
    kernels.reset_launch_counts()
    got = tmm.masked_matmul(to_torch(x), to_torch(w), int(seed), **kw).numpy()
    counts = kernels.launch_counts()
    assert {"masked_matmul", "tile_occupancy", "mask_pack"} <= set(counts)
    assert not any(counts.values()), counts
    np.testing.assert_array_equal(got, want_ref)
    np.testing.assert_array_equal(got, want_int)
    assert tmm.tile_skip_fraction(to_torch(x), to_torch(w)) == pytest.approx(
        float(jmm.tile_skip_fraction(x, w)), abs=1e-12)


def test_masked_matmul_counter_uses_reference_n_pad():
    """N=50 pads to 128 in the reference: the SR counter of (row 1, col 0)
    is 128, not 50 or 64."""
    x = torch.full((2, 1), 2.0**-17)  # products land mid-grid: SR decides
    w = torch.ones((1, 50))
    got = tmm.masked_matmul(x, w, 9)
    u = tprng.uniform_from_bits(tprng.hash_uint32(torch.tensor([128]), 9))
    assert float(got[1, 0]) == (2.0**-16 if float(u) < 0.5 else 0.0)
    want = np.asarray(jmm._mm_ref(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                                  jnp.uint32(9)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_masked_matmul_rejects_bad_shapes():
    with pytest.raises(ValueError, match="bad shapes"):
        tmm.masked_matmul(torch.zeros(3, 4), torch.zeros(5, 2))


# -- (c) mask_pack, kv_pack / kv_unpack ----------------------------------------


@pytest.mark.parametrize("case", range(len(jmc._pack_examples())))
def test_mask_pack_plain_matches_reference_interpret_and_oracle(case):
    (x,), _ = jmc._pack_examples()[case]
    flat = np.asarray(x).reshape(-1)
    n_words = -(-flat.size // 32)
    want_ref = np.asarray(jmc._pack_ref(x))
    want_int = np.asarray(registry.impls("mask_pack")["interpret"].fn(x))
    got = tmc.mask_pack(to_torch(flat)).numpy()
    # the JAX op pads to whole (8, 1024) kernel blocks; the extra words are 0
    np.testing.assert_array_equal(got, want_ref[:n_words])
    np.testing.assert_array_equal(got, want_int[:n_words])
    assert not want_ref[n_words:].any()
    padded = np.pad(flat, (0, n_words * 32 - flat.size)).reshape(1, -1)
    np.testing.assert_array_equal(got, np_mask_pack(padded)[0])
    np.testing.assert_array_equal(tmc.mask_unpack(torch.from_numpy(got), flat.size).numpy(),
                                  flat != 0)


def test_mask_pack_bf16_negative_zero_and_tail_bits():
    x = torch.tensor([[0.0, -0.0, 1.0, -2.5] * 9 + [3.0]] * 3, dtype=torch.bfloat16)
    words = tmc.mask_pack(x)  # 37 elements: 2 words, 27 tail bits zero
    assert words.shape == (3, 2) and words.dtype == torch.uint32
    bits = (x.float() != 0).numpy()
    for r in range(3):
        np.testing.assert_array_equal(words[r].numpy(),
                                      np_mask_pack(np.pad(bits[r], (0, 27))[None])[0])
    # word 1 holds elements 32..36: 0.0, -0.0, 1.0, -2.5, 3.0 -> bits 2, 3, 4
    assert int(words[0, 1]) == 0b11100


KV_CASES = jkv._pack_examples()


@pytest.mark.parametrize("case", range(len(KV_CASES)))
def test_kv_pack_matches_reference_interpret_and_serial_oracle(case):
    (x,), _ = KV_CASES[case]
    got = tkv.kv_pack(to_torch(x))
    for impl in ("ref", "interpret"):
        want = registry.impls("kv_pack")[impl].fn(x)
        np.testing.assert_array_equal(to_numpy(got["values"]).view(np.uint8),
                                      np.asarray(want["values"]).view(np.uint8))
        np.testing.assert_array_equal(got["mask"].numpy(), np.asarray(want["mask"]))
        assert int(got["nnz"]) == int(want["nnz"])
    values, words, nnz = kv_pack_reference(np.asarray(x))
    np.testing.assert_array_equal(to_numpy(got["values"]).view(np.uint8), values.view(np.uint8))
    np.testing.assert_array_equal(got["mask"].numpy(), words)
    assert int(got["nnz"]) == nnz
    n = int(np.asarray(x).size)
    assert tkv.kv_wire_bits(nnz, n) == jkv.kv_wire_bits(nnz, n)


@pytest.mark.parametrize("case", range(len(KV_CASES)))
def test_kv_unpack_matches_reference_and_serial_oracle(case):
    (x,), _ = KV_CASES[case]
    packed = jkv._pack_ref(x)
    n = int(np.asarray(x).size)
    got = tkv.kv_unpack(to_torch(packed["values"]), to_torch(packed["mask"]), n)
    want = np.asarray(jkv.kv_unpack(packed["values"], packed["mask"], n, impl="ref"))
    np.testing.assert_array_equal(to_numpy(got).view(np.uint8), want.view(np.uint8))
    oracle = kv_unpack_reference(np.asarray(packed["values"]), np.asarray(packed["mask"]), n)
    np.testing.assert_array_equal(to_numpy(got).view(np.uint8), oracle.view(np.uint8))


def test_kv_pack_batched_blocks_equal_per_block():
    """One call over (layers, slots, block) equals the reference's vmapped
    per-block pack (serving/kvpool.py:97-99)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 2, 200)).astype(np.float32)
    x[..., 120:] = 0.0
    x[0, 1] = 0.0
    got = tkv.kv_pack(torch.from_numpy(x).to(torch.bfloat16))
    want = jax.vmap(jkv._pack_ref)(jnp.asarray(x.reshape(6, 200)).astype(jnp.bfloat16))
    np.testing.assert_array_equal(got["mask"].reshape(6, -1).numpy(), np.asarray(want["mask"]))
    np.testing.assert_array_equal(got["nnz"].reshape(6).numpy(), np.asarray(want["nnz"]))
    np.testing.assert_array_equal(to_numpy(got["values"].reshape(6, 200)).view(np.uint8),
                                  np.asarray(want["values"]).view(np.uint8))


@pytest.mark.parametrize("case", range(len(MM_CASES)))
@pytest.mark.parametrize("tiles", [(128, 128), (64, 32), (32, 64)])
def test_tile_occupancy_plain_matches_reference(case, tiles):
    """The port's occupancy flags (CPU: the plain version) equal the JAX
    wrapper's ``_occupancy`` of the zero-padded operand, at the reference's
    128 tiles and at the CUDA kernel's own."""
    tr, tc = tiles
    for a in MM_CASES[case][0][:2]:
        a = np.array(a, np.float32)  # a writable copy for torch.from_numpy
        rows, cols = a.shape
        padded = np.pad(a, ((0, -(-rows // tr) * tr - rows), (0, -(-cols // tc) * tc - cols)))
        want = np.asarray(jmm._occupancy(jnp.asarray(padded), tr, tc))
        np.testing.assert_array_equal(tmm.tile_occupancy(torch.from_numpy(a), tr, tc).numpy(),
                                      want)
