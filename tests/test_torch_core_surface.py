"""The rest of the reference's public core surface in the port:
``spring_einsum``, ``apply_joint_mask``, ``pytree_quantize_stochastic``,
``quantization_noise_bound`` and the ``repro_torch.core`` export names,
against the reference on the CPU from numpy inputs drawn from a seed.

Tolerances, and why:
  einsum dense     bit-equal bf16: both take bf16 operands, fp32 products
                   and sums, one rounding of the result.
  einsum quant     on Q4.16 within one grid step (2**-16) of the reference,
                   at least 95% of the elements equal: the products lie on
                   a 2**-32 grid, an fp32 partial sum near 4 rounds at
                   2**-21, so a sum in another order lands on the other
                   side of a rounding tie for about 2 x 2**-21 / 2**-16,
                   3%, of the outputs (measured: 2.5-3.3%).  On the Q16.60
                   grid, where rounding is the identity, rel 1e-5.
  joint mask       exact.
  pytree SR        the SR statistics contract (``tests/test_sr_statistics.py``)
                   with float64 means: each leaf unbiased within 5 sigma
                   of the CLT bound, every draw on one of the two
                   neighbouring grid points; the leaves' streams differ.
                   The port draws from ``torch.Generator`` seeds, not
                   threefry, so the draws themselves are not compared.
"""

from __future__ import annotations

import dataclasses
import importlib
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.core import fixedpoint as jfp  # noqa: E402
from repro.core import spring_ops as jops  # noqa: E402

import repro_torch.core as tcore  # noqa: E402
from repro_torch.core import fixedpoint as tfp  # noqa: E402
from repro_torch.core import spring_ops as tops  # noqa: E402

N_DRAWS = 20_000
SIGMAS = 5.0


def _bf16_bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def test_core_exports_the_reference_names():
    """The reference's ``core/__init__`` names, each the port's object of
    that name in its module."""
    def public(mod):
        return sorted(n for n in dir(mod) if not n.startswith("_")
                      and not isinstance(getattr(mod, n), types.ModuleType))

    assert public(tcore) == public(jcore) == sorted(tcore.__all__)
    for name in tcore.__all__:
        where = getattr(jcore, name).__module__.rsplit(".", 1)[-1]
        assert tcore._WHERE[name] == where, name
        assert getattr(tcore, name) is getattr(
            importlib.import_module(f"repro_torch.core.{where}"), name)


def test_formats_and_noise_bound_equal_the_reference():
    for name in ("SPRING_FORMAT", "SPRING_ACCUM_FORMAT"):
        j, t = getattr(jfp, name), getattr(tfp, name)
        assert (t.il, t.fl, t.eps, t.bits) == (j.il, j.fl, j.eps, j.bits)
    for il, fl in ((4, 16), (8, 32), (2, 6)):
        assert tfp.quantization_noise_bound(tfp.FixedPointFormat(il, fl)) == \
            jfp.quantization_noise_bound(jfp.FixedPointFormat(il, fl))


@pytest.mark.parametrize("first", ["repro_torch.kernels.mask_compress.ops",
                                   "repro_torch.kernels", "repro_torch.models.lm",
                                   "repro_torch.core.sparsity", "repro_torch.core"])
def test_the_port_imports_in_any_order(first):
    """A fresh interpreter imports any module first, then the core's names."""
    code = (f"import {first}; from repro_torch.core import apply_joint_mask, spring_einsum, "
            "QUANT_SPARSE; import repro_torch.runtime.train")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


# -- spring_einsum ---------------------------------------------------------------------


SPECS = [
    ("bqhd,bkhd->bhqk", (2, 5, 3, 16), (2, 7, 3, 16)),
    ("bhqk,bkhd->bqhd", (2, 3, 5, 7), (2, 7, 3, 16)),
    ("ij,jk->ik", (33, 48), (48, 20)),
    ("btd,ed->bte", (3, 9, 24), (6, 24)),
]


def _operands(spec_i: int):
    _, sa, sb = SPECS[spec_i]
    rng = np.random.default_rng(spec_i)
    a = rng.standard_normal(sa).astype(np.float32)
    b = (rng.standard_normal(sb) * (rng.random(sb) > 0.3)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_spring_einsum_dense_is_bit_equal(i):
    spec = SPECS[i][0]
    a, b = _operands(i)
    want = jax.jit(lambda x, y: jops.spring_einsum(spec, x, y, jops.DENSE))(a, b)
    got = tops.spring_einsum(spec, torch.from_numpy(a), torch.from_numpy(b), tops.DENSE)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(_bf16_bits(got), _bf16_bits(want))


@pytest.mark.parametrize("mode", ["quant", "quant_sparse"])
@pytest.mark.parametrize("i", range(len(SPECS)))
def test_spring_einsum_quantized_matches_within_a_grid_step(i, mode):
    spec = SPECS[i][0]
    a, b = _operands(i)
    jc = dataclasses.replace(jops.MODES[mode], stochastic=False)
    tc = dataclasses.replace(tops.MODES[mode], stochastic=False)
    want = np.asarray(jax.jit(lambda x, y: jops.spring_einsum(spec, x, y, jc))(a, b))
    got = tops.spring_einsum(spec, torch.from_numpy(a), torch.from_numpy(b), tc).numpy()
    eps = tc.fmt.eps
    assert got.dtype == np.float32
    assert np.all(np.round(got / eps) * eps == got)  # on the grid
    assert float(np.max(np.abs(got - want))) <= eps
    assert float(np.mean(got == want)) >= 0.95
    fine = dict(fmt=tfp.FixedPointFormat(16, 60))
    want = np.asarray(jax.jit(lambda x, y: jops.spring_einsum(
        spec, x, y, dataclasses.replace(jc, fmt=jfp.FixedPointFormat(16, 60))))(a, b))
    got = tops.spring_einsum(spec, torch.from_numpy(a), torch.from_numpy(b),
                             dataclasses.replace(tc, **fine)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


def test_spring_einsum_gradient_is_straight_through():
    a = torch.randn((4, 8), generator=torch.Generator().manual_seed(0), requires_grad=True)
    b = torch.randn((8, 3), generator=torch.Generator().manual_seed(1), requires_grad=True)
    cfg = dataclasses.replace(tops.QUANT, stochastic=False)
    tops.spring_einsum("ij,jk->ik", a, b, cfg).sum().backward()
    want_a = torch.ones((4, 3)) @ tfp.quantize_nearest(b.detach()).t()
    torch.testing.assert_close(a.grad, want_a)


def test_spring_einsum_stochastic_draws_from_the_keygen():
    a = torch.full((64, 32), 0.3 + 0.5 * 2**-16)
    b = torch.full((32, 16), 0.25)
    cfg = tops.QUANT
    y1 = tops.spring_einsum("ij,jk->ik", a, b, cfg, tops.KeyGen(1))
    y2 = tops.spring_einsum("ij,jk->ik", a, b, cfg, tops.KeyGen(1))
    y3 = tops.spring_einsum("ij,jk->ik", a, b, cfg, tops.KeyGen(2))
    assert torch.equal(y1, y2) and not torch.equal(y1, y3)


# -- apply_joint_mask ------------------------------------------------------------------


@pytest.mark.parametrize("shape_a,shape_w", [((64,), (64,)), ((8, 33), (8, 33)),
                                             ((4, 1, 16), (1, 5, 16))])
def test_apply_joint_mask_is_exact(shape_a, shape_w):
    rng = np.random.default_rng(len(shape_a))
    a = (rng.standard_normal(shape_a) * (rng.random(shape_a) > 0.4)).astype(np.float32)
    w = (rng.standard_normal(shape_w) * (rng.random(shape_w) > 0.5)).astype(np.float32)
    a[..., 0] = -0.0  # a signed zero counts as zero in both
    ja, jw = jcore.apply_joint_mask(jnp.asarray(a), jnp.asarray(w))
    ta, tw = tcore.apply_joint_mask(torch.from_numpy(a), torch.from_numpy(w))
    np.testing.assert_array_equal(ta.numpy().view(np.uint32), np.asarray(ja).view(np.uint32))
    np.testing.assert_array_equal(tw.numpy().view(np.uint32), np.asarray(jw).view(np.uint32))


# -- pytree_quantize_stochastic --------------------------------------------------------


def _clt_bound(frac: float, eps: float, n: int) -> float:
    return SIGMAS * eps * np.sqrt(max(frac * (1.0 - frac), 1e-12) / n)


def test_pytree_quantize_stochastic_is_unbiased_per_leaf():
    eps = tfp.SPRING_FORMAT.eps
    def leaf(f):
        return torch.full((N_DRAWS,), 0.5 + f * eps)

    tree = {"a": leaf(0.3), "b": [leaf(0.5), leaf(0.77)], "c": (leaf(0.05),)}
    out = tfp.pytree_quantize_stochastic(torch.Generator().manual_seed(0), tree,
                                         tfp.SPRING_FORMAT)
    assert isinstance(out["b"], list) and isinstance(out["c"], tuple)
    pairs = [(out["a"], 0.3), (out["b"][0], 0.5), (out["b"][1], 0.77),
             (out["c"][0], 0.05)]
    for q, frac in pairs:
        x = 0.5 + frac * eps
        bias = float(q.numpy().astype(np.float64).mean() - np.float64(np.float32(x)))
        assert abs(bias) <= _clt_bound(frac, eps, N_DRAWS), (frac, bias)
        lo = np.floor(0.5 / eps + frac) * eps
        assert set(np.unique(q.numpy())) <= {np.float32(lo), np.float32(lo + eps)}


def test_pytree_quantize_stochastic_gives_each_leaf_its_own_stream():
    eps = tfp.SPRING_FORMAT.eps
    x = torch.full((N_DRAWS,), 1.0 + 0.5 * eps)
    q = tfp.pytree_quantize_stochastic(torch.Generator().manual_seed(3), [x, x, x],
                                       tfp.SPRING_FORMAT)
    ups = [(t > x).numpy().astype(np.float64) for t in q]
    for i in range(3):
        for j in range(i + 1, 3):
            assert not np.array_equal(ups[i], ups[j])
            # independent draws: the up/down indicators are uncorrelated
            assert abs(np.corrcoef(ups[i], ups[j])[0, 1]) <= SIGMAS / np.sqrt(N_DRAWS)
    again = tfp.pytree_quantize_stochastic(torch.Generator().manual_seed(3), [x, x, x],
                                           tfp.SPRING_FORMAT)
    assert all(torch.equal(a, b) for a, b in zip(q, again))


def test_pytree_quantize_stochastic_matches_the_reference_on_grid_values():
    """Values already on the grid round to themselves in both packages."""
    rng = np.random.default_rng(0)
    grid = (np.round(rng.standard_normal((3, 40)) * 2**16) / 2**16).astype(np.float32)
    tree = {"w": grid, "v": [grid[0], grid[1:]]}
    want = jfp.pytree_quantize_stochastic(jax.random.PRNGKey(0),
                                          jax.tree_util.tree_map(jnp.asarray, tree),
                                          jfp.SPRING_FORMAT)
    got = tfp.pytree_quantize_stochastic(
        torch.Generator().manual_seed(0),
        {"w": torch.from_numpy(grid), "v": [torch.from_numpy(grid[0]),
                                            torch.from_numpy(grid[1:])]},
        tfp.SPRING_FORMAT)
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
    for g, w in zip(got["v"], want["v"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
