"""Port parity, the Fig. 5-7 sparsity modules: ``repro_torch.core``
(``masking``'s compressed form, ``sparsity``) and the plain version of the
``dangling_filter`` kernel, against ``repro`` on the CPU.

The cases are those of ``tests/test_masking_sparsity.py`` (there drawn by
hypothesis, here from fixed numpy seeds), fed to both packages as the same
numpy arrays.  Everything is exact (bit for bit, or equal integers) except
``sparse_dot``: both packages take a float32 dot of the same matched
streams, whose sums may differ in order, so it is held at rel 1e-6 with a
1e-6 floor.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import masking as jmask  # noqa: E402
from repro.core import sparsity as jsp  # noqa: E402
from repro.kernels.mask_compress import ops as jmc  # noqa: E402
from repro.kernels.mask_compress import ref as jref  # noqa: E402

from repro_torch.core import masking as tmask  # noqa: E402
from repro_torch.core import sparsity as tsp  # noqa: E402
from repro_torch.kernels.mask_compress import ops as tmc  # noqa: E402
from repro_torch.kernels.mask_compress import ref as tref  # noqa: E402


def sparse_vec(seed: int, n: int, sparsity: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * (rng.random(n) > sparsity)).astype(np.float32)


def encoded(x: np.ndarray):
    return jmask.mask_encode(jnp.asarray(x)), tmask.mask_encode(torch.from_numpy(x))


def assert_same_vector(t_mv, j_mv) -> None:
    np.testing.assert_array_equal(t_mv.values.numpy(), np.asarray(j_mv.values))
    np.testing.assert_array_equal(t_mv.mask.numpy(), np.asarray(j_mv.mask))
    assert int(t_mv.nnz) == int(j_mv.nnz) and t_mv.length == j_mv.length


@pytest.mark.parametrize("seed,n,sparsity", [(0, 1, 0.0), (1, 31, 0.5), (2, 32, 1.0),
                                             (3, 300, 0.7), (4, 257, 0.2)])
def test_mask_encode_decode_match_reference(seed, n, sparsity):
    x = sparse_vec(seed, n, sparsity)
    j_mv, t_mv = encoded(x)
    assert_same_vector(t_mv, j_mv)
    np.testing.assert_array_equal(tmask.mask_decode(t_mv).numpy(),
                                  np.asarray(jmask.mask_decode(j_mv)))
    np.testing.assert_array_equal(tmask.mask_decode(t_mv).numpy(), x)
    for bits in (16, 20, 21):
        assert int(tmask.compressed_bits(t_mv, bits)) == int(jmask.compressed_bits(j_mv, bits))
        assert float(tmask.compression_ratio(t_mv, bits)) == float(
            jmask.compression_ratio(j_mv, bits))


def test_fig5_worked_example():
    """Paper Fig. 5: 16 elements, 6 non-zero, 16-bit values -> 112 bits,
    256 / 112 = 2.29x, as the reference computes it."""
    x = np.zeros(16, np.float32)
    x[[0, 2, 5, 9, 11, 14]] = 3.0
    j_mv, t_mv = encoded(x)
    assert int(t_mv.nnz) == 6 and int(tmask.compressed_bits(t_mv, 16)) == 112
    ratio = float(tmask.compression_ratio(t_mv, 16))
    assert ratio == float(jmask.compression_ratio(j_mv, 16))
    assert abs(ratio - 256 / 112) < 1e-5 and round(ratio, 2) == 2.29


@pytest.mark.parametrize("seed,n,sa,sw", [(0, 1, 0.2, 0.2), (1, 64, 0.5, 0.5),
                                          (2, 128, 0.9, 0.2), (3, 100, 0.3, 0.8),
                                          (4, 33, 0.5, 0.6)])
def test_precompute_sparsity_matches_reference_and_algorithm1(seed, n, sa, sw):
    a, w = sparse_vec(seed, n, sa), sparse_vec(seed + 1, n, sw)
    (ja, ta), (jw, tw) = encoded(a), encoded(w)
    got, want = tsp.precompute_sparsity(ta, tw), jsp.precompute_sparsity(ja, jw)
    np.testing.assert_array_equal(got.a_values.numpy(), np.asarray(want.a_values))
    np.testing.assert_array_equal(got.w_values.numpy(), np.asarray(want.w_values))
    np.testing.assert_array_equal(got.out_mask.numpy(), np.asarray(want.out_mask))
    assert int(got.n_matched) == int(want.n_matched)
    a_ref, w_ref, out_bits = tref.precompute_module_reference(a, w)
    np.testing.assert_array_equal(got.a_values.numpy(), a_ref)
    np.testing.assert_array_equal(got.w_values.numpy(), w_ref)
    assert int(got.n_matched) == int(out_bits.sum())
    for t_words, j_words in zip(tsp.generate_masks(ta.mask, tw.mask),
                                jsp.generate_masks(ja.mask, jw.mask)):
        np.testing.assert_array_equal(t_words.numpy(), np.asarray(j_words))


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 64), (2, 256), (3, 255)])
def test_sparse_dot_matches_reference_and_dense(seed, n):
    a, w = sparse_vec(seed, n, 0.6), sparse_vec(seed + 7, n, 0.5)
    (ja, ta), (jw, tw) = encoded(a), encoded(w)
    got = float(tsp.sparse_dot(ta, tw))
    want = float(jsp.sparse_dot(ja, jw))
    dense = float(np.dot(a.astype(np.float64), w.astype(np.float64)))
    for ref in (want, dense):
        assert abs(got - ref) <= 1e-6 * max(1.0, abs(ref))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_joint_mask_and_post_compute_match_reference(seed):
    a, w = sparse_vec(seed, 64, 0.5), sparse_vec(seed + 3, 64, 0.5)
    a[::9] = -0.0
    got = tsp.apply_joint_mask(torch.from_numpy(a), torch.from_numpy(w))
    want = jsp.apply_joint_mask(jnp.asarray(a), jnp.asarray(w))
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g.numpy().view(np.uint32), np.asarray(wv).view(np.uint32))
    np.testing.assert_array_equal((got[0] * got[1]).numpy(), a * w)
    y = np.random.default_rng(seed).standard_normal(100).astype(np.float32)
    assert_same_vector(tsp.relu_then_encode(torch.from_numpy(y)),
                       jsp.relu_then_encode(jnp.asarray(y)))
    np.testing.assert_array_equal(tsp.mask_words_from_dense(torch.from_numpy(a)).numpy(),
                                  np.asarray(jsp.mask_words_from_dense(jnp.asarray(a))))


def test_apply_joint_mask_is_the_dangling_filter_plain_version():
    assert tsp.apply_joint_mask is tmc.dangling_filter_reference


def test_tile_occupancy_and_density_match_reference():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((8, 12)) * (rng.random((8, 12)) > 0.8)).astype(np.float32)
    x[:4, :4] = 0.0
    for tm, tn in ((2, 4), (4, 4), (8, 12)):
        np.testing.assert_array_equal(tmask.tile_occupancy(torch.from_numpy(x), tm, tn).numpy(),
                                      np.asarray(jmask.tile_occupancy(jnp.asarray(x), tm, tn)))
    assert float(tmask.density(torch.from_numpy(x))) == float(jmask.density(jnp.asarray(x)))
    with pytest.raises(ValueError, match="divisible"):
        tmask.tile_occupancy(torch.from_numpy(x), 3, 4)


@pytest.mark.parametrize("case", range(len(jmc._dangling_examples())))
def test_dangling_filter_plain_matches_reference_interpret_and_oracle(case):
    """The reference's own examples, through its Pallas kernel in interpret
    mode and its numpy oracle: exact; the CPU wrapper counts no launch."""
    (a, w), _ = jmc._dangling_examples()[case]
    a, w = np.array(a), np.array(w)  # writable copies for torch.from_numpy
    before = tmc.dangling_filter.launches
    got = tmc.dangling_filter(torch.from_numpy(a), torch.from_numpy(w))
    assert tmc.dangling_filter.launches == before
    want_int = jmc.dangling_filter(jnp.asarray(a), jnp.asarray(w), impl="interpret")
    want_ref = jmc.dangling_filter(jnp.asarray(a), jnp.asarray(w), impl="ref")
    oracle = tref.dangling_filter_reference(a, w)
    for i, g in enumerate(got):
        assert g.shape == a.shape and g.dtype == torch.float32
        for want in (want_int[i], want_ref[i], oracle[i]):
            np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                          np.asarray(want).view(np.uint32))


def test_dangling_filter_plain_nan_negative_zero_and_bf16():
    """NaN counts as non-zero and -0.0 as zero (as ``!= 0``); a dropped
    entry is +0.0; bf16 stays bf16 (the reference's oracle keeps the dtype)."""
    a = torch.tensor([float("nan"), -0.0, 1.0, 2.0, float("nan"), 3.0])
    w = torch.tensor([1.0, 5.0, -0.0, float("nan"), 0.0, 4.0])
    af, wf = tmc.dangling_filter(a, w)
    ja, jw = jmc.dangling_filter(jnp.asarray(a.numpy()), jnp.asarray(w.numpy()), impl="ref")
    np.testing.assert_array_equal(af.numpy().view(np.uint32), np.asarray(ja).view(np.uint32))
    np.testing.assert_array_equal(wf.numpy().view(np.uint32), np.asarray(jw).view(np.uint32))
    assert not np.signbit(af.numpy()[1:3]).any() and not np.signbit(wf.numpy()[1:3]).any()
    bf = tmc.dangling_filter(a.to(torch.bfloat16), w.to(torch.bfloat16))
    assert all(t.dtype == torch.bfloat16 for t in bf)
    with pytest.raises(ValueError, match="differ"):
        tmc.dangling_filter(a, w[:3])


@pytest.mark.parametrize("fn,args", [
    ("algorithm1_filter", (np.array([1.0, 2.0, 3.0, 0.0], np.float32),
                           np.array([1, 0, 0, 1]), np.array([0, 1, 0, 0]))),
    ("collapse_zeros", (np.array([0.0, 2.0, 0.0, 3.0], np.float32),)),
    ("mask_pack_reference", (sparse_vec(9, 64, 0.5).reshape(2, 32),)),
    ("mask_unpack_reference", (np.array([5, 2**31], np.uint32), 40)),
    ("stash_roundtrip_reference", (sparse_vec(10, 50, 0.5).reshape(5, 10),)),
])
def test_numpy_oracles_are_the_reference_s(fn, args):
    np.testing.assert_array_equal(getattr(tref, fn)(*args), getattr(jref, fn)(*args))
