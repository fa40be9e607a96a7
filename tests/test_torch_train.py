"""Port parity, training slice: ``repro_torch`` against ``repro`` on the CPU.

The same numpy inputs go through the JAX function (its plain reference,
and the Pallas kernel in interpret mode where there is one) and through
the port's counterpart, which on CPU tensors runs the kernels' plain
versions.  Tolerances, and why:

  exact      stochastic_round, memstash compress/decompress, cnn_layer_table:
             integer or copy-only arithmetic.
  rel 1e-5   masked_matmul_dx/_dw (max-abs error over max-abs oracle, the
             reference registry's own contract): fp32 sums in another order.
  grads      rtol 1e-5 with an absolute floor of 1e-5 x max|grad|
             (the reference's own conv-gradient contract,
             tests/test_backward_sparsity.py:203-207): fp32 sums in
             another order; at model level a conv output that lies within
             an ulp of a rounding midpoint can round to the other
             neighbour, one 2^-16 grid step, which moves every gradient
             downstream of it by that much.
  SR         model-level SR draws from torch.Generator seeds, not the
             reference's threefry: held statistically (means within a
             5-sigma CLT bound, computed in float64).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import fixedpoint as jfp  # noqa: E402
from repro.core import spring_ops as jops  # noqa: E402
from repro.kernels import registry  # noqa: E402
from repro.kernels.masked_matmul import backward as jbw  # noqa: E402
from repro.kernels.masked_matmul import ops as jmm  # noqa: E402
from repro.kernels.stochastic_round import ops as jsr  # noqa: E402
from repro.kernels.stochastic_round.ref import sr_reference as jsr_reference  # noqa: E402
from repro.kernels.stochastic_round.sr_kernel import sr_pallas  # noqa: E402
from repro.memstash import format as jfmt  # noqa: E402
from repro.memstash.config import MemstashConfig as JMemstash  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro.models.layers import SpringContext as JContext  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.convert import cnn_params_from_jax  # noqa: E402
from repro_torch.core import fixedpoint as tfp  # noqa: E402
from repro_torch.core import spring_ops as tops  # noqa: E402
from repro_torch.kernels.masked_matmul import backward as tbw  # noqa: E402
from repro_torch.kernels.masked_matmul import ops as tmm  # noqa: E402
from repro_torch.kernels.stochastic_round.ops import stochastic_round  # noqa: E402
from repro_torch.memstash import format as tfmt  # noqa: E402
from repro_torch.memstash.config import MemstashConfig as TMemstash  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.models.layers import SpringContext as TContext  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.runtime import train as ttrain  # noqa: E402


def to_torch(a) -> "torch.Tensor":
    """numpy / jax array -> torch tensor with the same bits (bf16 too)."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def bits(t) -> np.ndarray:
    """The raw bits of a torch tensor or an array, for exact comparison."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        a = t.numpy()
    else:
        a = np.asarray(t)
        if a.dtype == jnp.bfloat16:
            return a.view(np.uint16)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_grads_close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * (float(np.max(np.abs(want))) + 1.0))


# -- (a) stochastic_round: exact --------------------------------------------------


SR_CASES = jsr._examples()


@pytest.mark.parametrize("case", range(len(SR_CASES)))
def test_stochastic_round_plain_bit_exact_vs_reference_and_interpret(case):
    (x, seed), kw = SR_CASES[case]
    want = np.asarray(jsr_reference(x, seed, **kw))
    want_int = np.asarray(sr_pallas(x, seed, interpret=True, **kw))
    kernels.reset_launch_counts()
    got = stochastic_round(to_torch(x), int(seed), **kw)
    assert stochastic_round.launches == 0  # CPU: the plain version
    np.testing.assert_array_equal(bits(got), want.view(np.uint32))
    np.testing.assert_array_equal(bits(got), want_int.view(np.uint32))


# -- (b) model-level SR: statistics in float64 ------------------------------------

N_DRAWS, SIGMAS = 20_000, 5.0


@pytest.mark.parametrize("frac,seed", [(0.05, 3), (0.3, 0), (0.5, 1), (0.77, 2)])
def test_quantize_stochastic_unbiased_and_rounds_up_with_probability_frac(frac, seed):
    """E[Round(x)] = x within 5 sigma of the CLT and P(up) = frac within 5
    sigma, means taken in float64 (an fp32 mean of 20,000 draws near 0.5
    resolves only 2^-8 eps: the reference's own CLT test fails on that)."""
    fmt = tfp.SPRING_FORMAT
    eps = fmt.eps
    x = torch.full((N_DRAWS,), 0.5 + frac * eps, dtype=torch.float32)
    q = tfp.quantize_stochastic(torch.Generator().manual_seed(seed), x, fmt)
    lo = np.floor(0.5 / eps + frac) * eps
    assert set(np.unique(q.numpy()).tolist()) <= {np.float32(lo), np.float32(lo + eps)}
    bias = float(q.double().mean()) - float(x[0].double())
    sigma = np.sqrt(frac * (1 - frac) / N_DRAWS)
    assert abs(bias) <= SIGMAS * eps * sigma, (frac, bias)
    up = float((q > x[0]).double().mean())
    assert abs(up - frac) <= SIGMAS * sigma


def test_quantize_stochastic_deterministic_per_seed():
    x = torch.randn(4096, generator=torch.Generator().manual_seed(7)) * 2
    a = tfp.quantize_stochastic(torch.Generator().manual_seed(3), x)
    b = tfp.quantize_stochastic(torch.Generator().manual_seed(3), x)
    c = tfp.quantize_stochastic(torch.Generator().manual_seed(4), x)
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("il,fl", [(4, 16), (2, 6)])
def test_ste_wrappers_and_int_conversion_match_reference(il, fl):
    """Nearest STE forward is bit-exact and both STE gradients are the
    in-range mask; to_int/from_int round-trip like the reference's."""
    rng = np.random.default_rng(il + fl)
    x = np.concatenate([rng.standard_normal(500).astype(np.float32) * 2**il,
                        np.array([2**il, -(2**il), 2**il + 1, -(2**il) - 1], np.float32)])
    jf, tf = jfp.FixedPointFormat(il, fl), tfp.FixedPointFormat(il, fl)
    g = rng.standard_normal(x.shape).astype(np.float32)
    want_y, vjp = jax.vjp(lambda v: jfp.ste_quantize_nearest(v, jf), jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(g))
    for fn in (lambda v: tfp.ste_quantize_nearest(v, tf),
               lambda v: tfp.ste_quantize_stochastic(torch.Generator().manual_seed(0), v, tf)):
        xt = torch.from_numpy(x).requires_grad_(True)
        y = fn(xt)
        y.backward(torch.from_numpy(g))
        np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want_g))
    y = tfp.ste_quantize_nearest(torch.from_numpy(x), tf)
    np.testing.assert_array_equal(bits(y), np.asarray(want_y).view(np.uint32))
    q = tfp.to_int(y, tf)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jfp.to_int(want_y, jf)))
    np.testing.assert_array_equal(bits(tfp.from_int(q, tf)), bits(jfp.from_int(jnp.asarray(
        q.numpy()), jf)))


# -- (c) dx / dw: rel 1e-5 -------------------------------------------------------


def _rel(got, want) -> float:
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want))) / (float(np.max(np.abs(want))) + 1e-12)


@pytest.mark.parametrize("op,case", [("dx", i) for i in range(len(jbw._dx_examples()))]
                         + [("dw", i) for i in range(len(jbw._dw_examples()))])
def test_dx_dw_plain_vs_reference_and_interpret(op, case):
    (a, b), _ = (jbw._dx_examples() if op == "dx" else jbw._dw_examples())[case]
    name = f"masked_matmul_{op}"
    want_ref = registry.impls(name)["ref"].fn(a, b)
    want_int = registry.impls(name)["interpret"].fn(a, b)
    fn = tbw.masked_matmul_dx if op == "dx" else tbw.masked_matmul_dw
    kernels.reset_launch_counts()
    got = fn(to_torch(a), to_torch(b)).numpy()
    assert not any(kernels.launch_counts().values())
    assert _rel(got, want_ref) <= 1e-5
    assert _rel(got, want_int) <= 1e-5


def test_split_k_depends_on_k_alone():
    assert tmm.split_k(8192) == (256, 1)
    assert tmm.split_k(8193) == (256, 2)
    assert tmm.split_k(1_605_632) == (256, 196)
    assert tmm.split_k(100) == (4, 1)
    part = torch.randn(3, 5, 7, generator=torch.Generator().manual_seed(0))
    want = (part[0] + part[1]) + part[2]
    assert torch.equal(tmm.splitk_reduce(part), want)


def test_record_tile_skip_counts_skipped_backward_tiles():
    """A block-pruned cotangent skips whole tile steps of dx and dw, counted
    at the kernel's tiles; dense operands skip nothing."""
    g = torch.randn(256, 128)
    g[:128] = 0.0
    w, x = torch.randn(64, 128), torch.randn(256, 64)
    with tmm.record_tile_skip() as skip:
        tbw.masked_matmul_dx(g, w)
        tbw.masked_matmul_dw(x, g)
        tmm.masked_matmul(x, w, apply_sr=False)
    frac = {op: 1.0 - v[0] / v[1] for op, v in skip.items()}
    assert frac["masked_matmul_dx"] == pytest.approx(0.5)
    assert frac["masked_matmul_dw"] == pytest.approx(0.5)
    assert frac["masked_matmul"] == 0.0


# -- (d) autograd through the port against jax.grad ------------------------------


def _sparse(rng, shape, density, scale=0.1):
    v = rng.standard_normal(shape).astype(np.float32) * scale
    return v * (rng.random(shape) < density)


def test_masked_matmul_backward_auto_matches_reference_grad():
    rng = np.random.default_rng(0)
    x = np.maximum(_sparse(rng, (100, 70), 0.5, 1.0), 0)
    w = _sparse(rng, (70, 50), 0.7)

    def jloss(x, w):
        y = jmm.masked_matmul(x, w, apply_sr=False, backward="auto")
        return jnp.sum(jax.nn.relu(y) ** 2)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    y = tmm.masked_matmul(xt, wt, apply_sr=False, backward="auto")
    torch.sum(torch.relu(y) ** 2).backward()
    assert_grads_close(xt.grad, want[0])
    assert_grads_close(wt.grad, want[1])
    with pytest.raises(ValueError, match="backward"):
        tmm.masked_matmul(xt, wt, backward="pallas")


def _cfgs(mode="quant_sparse", bwd="auto"):
    j = dataclasses.replace(jops.MODES[mode], stochastic=False, backward_sparsity=bwd)
    t = dataclasses.replace(tops.MODES[mode], stochastic=False, backward_sparsity=bwd)
    return j, t


@pytest.mark.parametrize("bwd", ["auto", "none"])
def test_spring_matmul_grads_match_reference(bwd):
    jc, tc = _cfgs(bwd=bwd)
    rng = np.random.default_rng(1)
    x = np.maximum(_sparse(rng, (64, 48), 0.5, 1.0), 0)
    w = _sparse(rng, (48, 32), 1.0)

    def jloss(x, w):
        return jnp.sum(jax.nn.relu(jops.spring_matmul(x, w, jc, None)) ** 2)

    want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    y = tops.spring_matmul(xt, wt, tc, None)
    # fp32 sums in another order, then nearest rounding: one grid step at most
    jy = np.asarray(jops.spring_matmul(jnp.asarray(x), jnp.asarray(w), jc, None))
    assert float(np.max(np.abs(y.detach().numpy() - jy))) <= 2.0**-16
    torch.sum(torch.relu(y) ** 2).backward()
    assert_grads_close(xt.grad, want[0])
    assert_grads_close(wt.grad, want[1])


@pytest.mark.parametrize("bwd", ["auto", "none"])
def test_spring_matmul_quant_sparse_takes_masked_matmul(bwd):
    """Every 2-D quant_sparse product goes through masked_matmul whatever
    backward_sparsity says (the reference's Pallas forward runs either way);
    "auto" adds the dx/dw products of the sparse backward."""
    _, tc = _cfgs(bwd=bwd)
    gen = torch.Generator().manual_seed(2)
    x = torch.relu(torch.randn(40, 72, generator=gen)).requires_grad_(True)
    w = (torch.randn(72, 24, generator=gen) / 72**0.5).requires_grad_(True)
    with tmm.record_tile_skip() as rec:
        tops.spring_matmul(x, w, tc, None).sum().backward()
    want = {"masked_matmul"} | ({"masked_matmul_dx", "masked_matmul_dw"} if bwd == "auto"
                                else set())
    assert set(rec) == want
@pytest.mark.parametrize("stride,padding,groups,cin", [
    ((1, 1), "SAME", 1, 8), ((2, 2), "SAME", 1, 8), ((1, 1), "VALID", 1, 8),
    ((2, 2), "VALID", 1, 8), ((1, 1), "SAME", 8, 8), ((2, 2), "SAME", 1, 3)])
def test_spring_conv2d_grads_match_reference(stride, padding, groups, cin):
    """The sparse custom backward (dW on im2col patches, dX on dilated
    cotangent patches against rot180 weights, the reference's bwd_pads) and
    the grouped conv's dense autograd, against jax.grad of the reference."""
    jc, tc = _cfgs()
    rng = np.random.default_rng(stride[0] * 10 + groups + cin)
    x = np.maximum(_sparse(rng, (2, 11, 12, cin), 0.5, 10.0), 0)
    cout = 8 if groups > 1 else 16
    w = _sparse(rng, (3, 3, cin // groups, cout), 1.0)

    def jloss(x, w):
        y = jops.spring_conv2d(x, w, jc, None, stride=stride, padding=padding,
                               feature_group_count=groups)
        return jnp.sum(jax.nn.relu(y) ** 2), y

    (_, jy), want = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(w))
    xt, wt = (torch.from_numpy(a).requires_grad_(True) for a in (x, w))
    y = tops.spring_conv2d(xt, wt, tc, None, stride=stride, padding=padding,
                           feature_group_count=groups)
    assert tuple(y.shape) == jy.shape
    # forward: fp32 sums in another order, then nearest rounding: at most
    # one 2^-16 grid step apart
    assert float(np.max(np.abs(y.detach().numpy() - np.asarray(jy)))) <= 2.0**-16
    torch.sum(torch.relu(y) ** 2).backward()
    assert_grads_close(xt.grad, want[0])
    assert_grads_close(wt.grad, want[1])


# -- (e) memstash: bit-exact format, bit-identical dense-mode gradients -----------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(7,), (3, 5, 9), (8, 128)])
@pytest.mark.parametrize("sparsity", [0.0, 0.5, 0.95])
def test_memstash_compress_bit_exact_vs_reference(dtype, shape, sparsity):
    rng = np.random.default_rng(len(shape) * 100 + int(sparsity * 100))
    x = rng.standard_normal(shape).astype(np.float32) * (rng.random(shape) >= sparsity)
    xj = jnp.asarray(x).astype(dtype)
    want = jfmt.compress(xj)
    got = tfmt.compress(to_torch(np.asarray(xj)))
    np.testing.assert_array_equal(bits(got.values), bits(want.values))
    np.testing.assert_array_equal(got.mask.to(torch.int64).numpy(),
                                  np.asarray(want.mask).astype(np.int64))
    assert int(got.nnz) == int(want.nnz) and got.nnz.dtype == torch.int32
    back = tfmt.decompress(got)
    assert back.dtype == to_torch(np.asarray(xj)).dtype
    np.testing.assert_array_equal(bits(back), bits(jfmt.decompress(want)))
    assert float(tfmt.wire_bytes(got)) == float(jfmt.wire_bytes(want))


def _reduced_model(store, ctx, x):
    """The conv+fc model of tests/test_backward_sparsity.py:260-265."""
    m = tcnn if isinstance(store, tcnn.ParamStore) else jcnn
    h = m.conv(store, ctx, "c1", x, 8, k=3)
    h = m.conv(store, ctx, "c2", h, 8, k=3, stride=2)
    h = h.reshape(h.shape[0], -1)
    h = m.fc(store, ctx, "f1", h, 32, relu=True)
    return m.fc(store, ctx, "f2", h, 10)


def _tiny_cnn(store, ctx, x):
    """The example's tiny_cnn (examples/sr_accuracy_parity.py)."""
    m = tcnn if isinstance(store, tcnn.ParamStore) else jcnn
    x = m.conv(store, ctx, "c1", x, 16, k=3, stride=2)
    x = m.conv(store, ctx, "c2", x, 32, k=3, stride=2)
    x = m.conv(store, ctx, "c3", x, 32, k=3)
    return m.fc(store, ctx, "head", m.gap(x), 10)


def _jparams(model, hw, seed=1):
    store = jcnn.ParamStore(jax.random.PRNGKey(seed))
    model(store, JContext(), jnp.zeros((1, hw, hw, 3)))
    return {k: np.asarray(v) for k, v in store.params.items()}


@pytest.mark.parametrize("policy", ["stash", "remat"])
def test_stashed_dense_grads_bit_identical_to_unstashed(policy):
    params = cnn_params_from_jax(_jparams(_reduced_model, 8))
    x = torch.relu(torch.randn(2, 8, 8, 3, generator=torch.Generator().manual_seed(0)))

    def grads(memstash):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        ctx = TContext(cfg=tops.DENSE, memstash=memstash)
        y = _reduced_model(tcnn.ParamStore(0, p), ctx, x)
        torch.mean(y.float() ** 2).backward()
        return {k: v.grad for k, v in p.items()}

    ref = grads(None)
    got = grads(TMemstash(policy=policy, min_elems=1))
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


# -- (f) the seven CNNs -----------------------------------------------------------


@pytest.mark.parametrize("name", sorted(jcnn.PAPER_CNNS))
def test_cnn_layer_table_equals_reference(name):
    want = [dataclasses.astuple(r) for r in jcnn.cnn_layer_table(jcnn.PAPER_CNNS[name])]
    got = [dataclasses.astuple(r) for r in tcnn.cnn_layer_table(tcnn.PAPER_CNNS[name])]
    assert got == want


def test_cnn_params_convert_and_forward_match_reference():
    """vgg19's parameter names and shapes match; a small-input quant_sparse
    forward of the converted parameters agrees with the reference."""
    hw = 32
    store = jcnn.ParamStore(jax.random.PRNGKey(0))
    jcnn.vgg19(store, JContext(), jnp.zeros((1, hw, hw, 3)))
    jp = {k: np.asarray(v) for k, v in store.params.items()}
    tp = cnn_params_from_jax(jp)
    own = tcnn.cnn_init(0, tcnn.PAPER_CNNS["vgg19"], hw)
    assert {k: tuple(v.shape) for k, v in own.items()} == {k: v.shape for k, v in jp.items()}
    jc, tc = _cfgs()
    x = np.abs(np.random.default_rng(0).standard_normal((2, hw, hw, 3)).astype(np.float32))
    want = jax.jit(lambda p, x: jcnn.cnn_apply(p, jcnn.PAPER_CNNS["vgg19"], x,
                                               JContext(cfg=jc)))(store.params, jnp.asarray(x))
    got = tcnn.cnn_apply(tp, tcnn.PAPER_CNNS["vgg19"], torch.from_numpy(x), TContext(cfg=tc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3 * (float(np.max(np.abs(np.asarray(want)))) + 1))


# -- (g) one train step against the reference -------------------------------------


def _jstep(model, params, x, y, spring, opt_cfg, memstash):
    key = jax.random.PRNGKey(5)

    def loss_fn(p):
        ctx = JContext(cfg=spring, keys=jops.KeyGen(key), memstash=memstash)
        logits = model(jcnn.ParamStore(key, p), ctx, x).astype(jnp.float32)
        lse = jax.scipy.special.logsumexp(logits, -1)
        gold = jnp.take_along_axis(logits, y[:, None], 1)[:, 0]
        return (lse - gold).mean()

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    new_p, _, _ = jopt.sgdm_update(opt_cfg, grads, jopt.sgdm_init(params), params, key)
    return float(loss), grads, new_p


@pytest.mark.parametrize("model,hw,batch", [(_reduced_model, 8, 2), (_tiny_cnn, 16, 8)])
def test_train_step_matches_reference(model, hw, batch):
    """quant_sparse with nearest rounding, the sparse backward and the
    compressed stash, fp32 master weights: loss at rel 1e-5, grads at the
    stated gradient tolerance, updated params within lr x that."""
    jp = {k: jnp.asarray(v) for k, v in _jparams(model, hw).items()}
    rng = np.random.default_rng(hw)
    x = rng.standard_normal((batch, hw, hw, 3)).astype(np.float32)
    y = rng.integers(0, 10, batch)
    jc, tc = _cfgs()
    jo = jopt.OptimizerConfig(kind="sgdm", lr=0.05, momentum=0.9)
    to = topt.OptimizerConfig(kind="sgdm", lr=0.05, momentum=0.9)
    jloss, jgrads, jnew = _jstep(model, jp, jnp.asarray(x), jnp.asarray(y), jc, jo,
                                 JMemstash(policy="stash", min_elems=1))

    step_cfg = ttrain.StepConfig(spring=tc, optimizer=to,
                                 memstash=TMemstash(policy="stash", min_elems=1))
    tp = cnn_params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    state = ttrain.init_train_state(tp, step_cfg, seed=5)
    params = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    ctx = TContext(cfg=tc, keys=tops.KeyGen(0), memstash=step_cfg.memstash)
    loss = ttrain.cross_entropy(model(tcnn.ParamStore(0, params), ctx, torch.from_numpy(x)),
                                torch.from_numpy(y))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(jloss, rel=1e-5)
    for k in jp:
        assert_grads_close(params[k].grad, jgrads[k])
    new_state, metrics = ttrain.make_cnn_train_step(model, step_cfg)(
        state, torch.from_numpy(x), torch.from_numpy(y))
    assert float(metrics["loss"]) == pytest.approx(jloss, rel=1e-5)
    assert new_state.step == 1
    for k in jp:
        assert_grads_close(new_state.params[k], jnew[k])


def test_train_step_with_sr_weights_stays_on_grid():
    """One quant_sparse SR step with Q4.16 SR master weights: every
    parameter is a Q4.16 grid point inside the range."""
    from repro_torch.launch.train import on_grid

    tp = cnn_params_from_jax(_jparams(_tiny_cnn, 16))
    tp["c1"] = tp["c1"] * 40.0  # some weights leave the range and must be clipped
    step_cfg = ttrain.StepConfig(
        spring=tops.QUANT_SPARSE,
        optimizer=topt.OptimizerConfig(kind="sgdm", lr=0.05, weight_format=tfp.SPRING_FORMAT))
    state = ttrain.init_train_state(tp, step_cfg, seed=3)
    x = torch.randn(8, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    state, m = ttrain.make_cnn_train_step(_tiny_cnn, step_cfg)(state, x, torch.arange(8) % 10)
    assert np.isfinite(float(m["loss"])) and on_grid(state.params)
    assert not on_grid(tp)


# -- (h) entry point without a card -----------------------------------------------


def test_run_arm_without_a_card_raises(monkeypatch):
    from repro_torch.launch.train import run_arm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_arm("t", "tiny_cnn", "quant_sparse", True, 1, 16, 2)
    out = run_arm("t", "tiny_cnn", "quant_sparse", True, 1, 16, 2, device="cpu",
                  verbose=False)
    assert out["device"] == "cpu" and out["finite"] and out["on_grid"] == [True]


def test_relu_sparsity_probe_matches_reference():
    from repro.core import activation_stats as jstats

    from repro_torch.core import activation_stats as tstats

    x = np.random.default_rng(0).standard_normal((4, 300)).astype(np.float32)

    def apply(relu, x):
        return relu(relu(x) - 0.5)

    want = jstats.relu_sparsity_probe(apply, jnp.asarray(x))
    got = tstats.relu_sparsity_probe(apply, torch.from_numpy(x))
    for k in ("mean_sparsity", "min_sparsity", "max_sparsity", "layers"):
        assert got[k] == pytest.approx(want[k], abs=1e-7), k
    assert tstats.tensor_sparsity(torch.from_numpy(x)) == pytest.approx(
        jstats.tensor_sparsity(jnp.asarray(x)), abs=1e-7)
