"""The lossy activation stash (``MemstashConfig.capacity < 1``) and the
stash accounting at other value widths, in the port against the
reference, on the CPU at reduced sizes from numpy inputs drawn from a seed.

Tolerances, and why:
  format     bit-equal: values, mask words, nnz, overflow and wire bits
             at value_bits 16 and 20 (the same cumsum-scatter layout).
  gradients  quant_sparse with nearest rounding, the sparse backward:
             loss rel 1e-5 and every gradient rtol 1e-5 with an absolute
             floor of 1e-5 x (max|grad| + 1), as ``tests/test_torch_train.py``
             holds the exact stash.  The contract is the reference's lossy
             gradient (the backward recomputes from the decompressed input,
             overflow decoded as zero), not the unstashed one.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api.spec import build_spec as jbuild  # noqa: E402
from repro.core import spring_ops as jops  # noqa: E402
from repro.memstash import format as jfmt  # noqa: E402
from repro.memstash import instrument as jinst  # noqa: E402
from repro.memstash.config import MemstashConfig as JMemstash  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models.layers import SpringContext as JContext  # noqa: E402

from repro_torch.api.spec import SpecError, build_spec as tbuild  # noqa: E402
from repro_torch.convert import cnn_params_from_jax  # noqa: E402
from repro_torch.core import spring_ops as tops  # noqa: E402
from repro_torch.memstash import format as tfmt  # noqa: E402
from repro_torch.memstash import instrument as tinst  # noqa: E402
from repro_torch.memstash.config import MemstashConfig as TMemstash  # noqa: E402
from repro_torch.memstash.stash import stash_apply  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.models.layers import SpringContext as TContext  # noqa: E402
from repro_torch.runtime import train as ttrain  # noqa: E402


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy().view(np.uint32) if t.dtype == torch.float32 else t.numpy()
    a = np.asarray(t)
    if a.dtype == jnp.bfloat16:
        return a.view(np.uint16)
    return a.view(np.uint32) if a.dtype == np.float32 else a


# -- the format --------------------------------------------------------------------


@pytest.mark.parametrize("capacity", [0.25, 0.6, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,sparsity", [((7,), 0.0), ((3, 5, 9), 0.5), ((8, 128), 0.3),
                                            ((4, 33, 17), 0.9), ((1000,), 0.45)])
def test_compress_at_capacity_is_bit_equal_to_the_reference(capacity, dtype, shape, sparsity):
    rng = np.random.default_rng(len(shape) * 100 + int(sparsity * 100))
    x = rng.standard_normal(shape).astype(np.float32) * (rng.random(shape) >= sparsity)
    xj = jnp.asarray(x).astype(dtype)
    want = jfmt.compress(xj, capacity=capacity)
    got = tfmt.compress(_to_torch(np.asarray(xj)), capacity=capacity)
    assert got.capacity_len == want.capacity_len
    np.testing.assert_array_equal(_bits(got.values), _bits(want.values))
    np.testing.assert_array_equal(got.mask.to(torch.int64).numpy(),
                                  np.asarray(want.mask).astype(np.int64))
    assert int(got.nnz) == int(want.nnz) and got.nnz.dtype == torch.int32
    assert int(got.overflow) == int(want.overflow)
    assert float(got.density) == float(want.density)
    np.testing.assert_array_equal(_bits(tfmt.decompress(got)), _bits(jfmt.decompress(want)))
    for vb in (16, 20):
        assert float(tfmt.wire_bits(got, vb)) == float(jfmt.wire_bits(want, vb)), vb
        assert float(tfmt.wire_bytes(got, vb)) == float(jfmt.wire_bytes(want, vb)), vb


def test_lossy_record_drops_the_overflow_and_is_exact_below_it():
    x = torch.arange(1, 101, dtype=torch.float32)  # 100 live values
    sv = tfmt.compress(x, capacity=0.6)
    assert sv.capacity_len == 60 and int(sv.overflow) == 40
    back = tfmt.decompress(sv)
    assert torch.equal(back[:60], x[:60]) and bool((back[60:] == 0).all())
    full = tfmt.compress(x)
    assert full.capacity_len == 100 and int(full.overflow) == 0
    assert torch.equal(tfmt.decompress(full), x)
    # a capacity the dense length rounds up from, and the smallest buffer
    assert tfmt.compress(x, capacity=0.001).capacity_len == 1
    assert tfmt.compress(torch.ones(7), capacity=0.5).capacity_len == 4


@pytest.mark.parametrize("capacity", [0.0, -0.5, 1.5])
def test_memstash_config_refuses_a_capacity_outside_0_1_as_the_reference(capacity):
    with pytest.raises(ValueError) as want:
        JMemstash(capacity=capacity)
    with pytest.raises(ValueError) as got:
        TMemstash(capacity=capacity)
    assert str(got.value) == str(want.value)


def test_instrument_rows_carry_overflow_and_value_bits():
    """Rows of one lossy stash point at value_bits 16: the reference's
    layout, wire and formula bytes at 16 bits, the overflow counted."""
    rng = np.random.default_rng(3)
    x = np.maximum(rng.standard_normal((4, 64)).astype(np.float32), 0)
    x[0] = np.abs(x[0]) + 1.0  # a dense row: overflow at capacity 0.3
    j, t = JMemstash(policy="stash", capacity=0.3, value_bits=16), \
        TMemstash(policy="stash", capacity=0.3, value_bits=16)
    with jinst.record_stash_traffic() as want:
        jinst.maybe_record("p", jnp.asarray(x), j)
    with tinst.record_stash_traffic() as got:
        assert tinst.recording()
        tinst.maybe_record("p", torch.from_numpy(x), t)
    assert not tinst.recording()
    assert got == want
    assert got[0]["overflow"] > 0
    assert tinst.summarize(got) == jinst.summarize(want)


# -- the stashed call's lossy gradients ---------------------------------------------


def _tiny_cnn(store, ctx, x):
    """The example's tiny_cnn (examples/sr_accuracy_parity.py)."""
    m = tcnn if isinstance(store, tcnn.ParamStore) else jcnn
    x = m.conv(store, ctx, "c1", x, 16, k=3, stride=2)
    x = m.conv(store, ctx, "c2", x, 32, k=3, stride=2)
    x = m.conv(store, ctx, "c3", x, 32, k=3)
    return m.fc(store, ctx, "head", m.gap(x), 10)


def _cfgs():
    j = dataclasses.replace(jops.MODES["quant_sparse"], stochastic=False)
    t = dataclasses.replace(tops.MODES["quant_sparse"], stochastic=False)
    return j, t


def _jloss_and_grads(params, x, y, spring, memstash):
    key = jax.random.PRNGKey(5)

    def loss_fn(p):
        ctx = JContext(cfg=spring, keys=jops.KeyGen(key), memstash=memstash)
        logits = _tiny_cnn(jcnn.ParamStore(key, p), ctx, x).astype(jnp.float32)
        lse = jax.scipy.special.logsumexp(logits, -1)
        gold = jnp.take_along_axis(logits, y[:, None], 1)[:, 0]
        return (lse - gold).mean()

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


def _tloss_and_grads(params, x, y, spring, memstash):
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    ctx = TContext(cfg=spring, keys=tops.KeyGen(0), memstash=memstash)
    loss = ttrain.cross_entropy(_tiny_cnn(tcnn.ParamStore(0, p), ctx, x), y)
    loss.backward()
    return float(loss.detach()), {k: v.grad for k, v in p.items()}


def _assert_grads_close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * (float(np.max(np.abs(want))) + 1.0))


@pytest.mark.parametrize("capacity", [0.6, 0.25])
def test_lossy_stash_gradients_match_the_reference(capacity):
    """The reduced CNN (tiny_cnn, 16 x 16, batch 8) with every conv input
    stashed at ``capacity``: the image (density 1) overflows, so the first
    conv's dW reads a lossy input in both packages."""
    store = jcnn.ParamStore(jax.random.PRNGKey(1))
    _tiny_cnn(store, JContext(), jnp.zeros((1, 16, 16, 3)))
    jp = {k: jnp.asarray(v) for k, v in store.params.items()}
    tp = cnn_params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    rng = np.random.default_rng(16)
    x = rng.standard_normal((8, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, 8)
    jc, tc = _cfgs()
    jm = JMemstash(policy="stash", min_elems=1, capacity=capacity)
    tm = TMemstash(policy="stash", min_elems=1, capacity=capacity)
    want, jgrads = _jloss_and_grads(jp, jnp.asarray(x), jnp.asarray(y), jc, jm)
    with tinst.record_stash_traffic() as rows:
        got, grads = _tloss_and_grads(tp, torch.from_numpy(x), torch.from_numpy(y), tc, tm)
    assert got == pytest.approx(want, rel=1e-5)
    for k in jp:
        _assert_grads_close(grads[k], jgrads[k])
    assert {r["layer"]: r["overflow"] > 0 for r in rows}["c1"]
    # the exact stash gives other gradients: the lossy path really ran
    _, exact = _tloss_and_grads(tp, torch.from_numpy(x), torch.from_numpy(y), tc,
                                TMemstash(policy="stash", min_elems=1))
    assert not torch.equal(exact["c1"], grads["c1"])


def test_stash_saves_the_capacity_buffer_only():
    """The saved record holds ``ceil(n * capacity)`` values: what the card
    keeps for the backward pass shrinks with the capacity."""
    x = torch.relu(torch.randn((4, 1000), generator=torch.Generator().manual_seed(0)))
    x.requires_grad_(True)
    w = torch.randn((1000, 8), generator=torch.Generator().manual_seed(1), requires_grad=True)
    saved = {}
    for cap in (1.0, 0.3):
        sizes = []

        def pack(t, sizes=sizes):
            sizes.append(t.numel())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            y = stash_apply(lambda h, aux: h @ aux[0], TMemstash(policy="stash", capacity=cap),
                            "p", x, (w,))
        y.sum().backward()
        saved[cap] = sizes
    assert saved[1.0][0] == 4000 and saved[0.3][0] == 1200


# -- the spec ------------------------------------------------------------------------


@pytest.mark.parametrize("sets", [
    ["memstash.capacity=0.6", "memstash.policy=stash"],
    ["memstash.value_bits=16"],
    ["memstash.capacity=0.25", "memstash.value_bits=12", "memstash.min_elems=64"],
])
@pytest.mark.parametrize("run", ["train", "serve"])
def test_spec_resolves_value_bits_and_capacity_as_the_reference(sets, run):
    want = jbuild(run, sets=sets, use_env=False).resolve()
    got = tbuild(run, sets=sets, use_env=False).resolve()
    for f in ("policy", "value_bits", "capacity", "min_elems"):
        assert getattr(got.memstash, f) == getattr(want.memstash, f), f
    if run == "train":
        for f in ("policy", "value_bits", "capacity", "min_elems"):
            assert getattr(got.step.memstash, f) == getattr(want.step.memstash, f), f


@pytest.mark.parametrize("capacity", ["0", "1.5"])
def test_spec_refuses_a_bad_capacity_with_the_reference_text(capacity):
    sets = [f"memstash.capacity={capacity}"]
    with pytest.raises(Exception) as want:
        jbuild("train", sets=sets, use_env=False).resolve()
    with pytest.raises(SpecError) as got:
        tbuild("train", sets=sets, use_env=False).resolve()
    assert str(got.value) == str(want.value)
