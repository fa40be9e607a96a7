"""Port parity for the encoder-decoder (whisper-medium): ``models/encdec.py``,
LayerNorm and the GELU MLP (``models/layers.py``), the encoder-decoder
serving steps and the static ``ServeSession``, and the synthetic frames'
``threefry.normal_bf16``, ``repro_torch`` against ``repro`` on the CPU at
the reduced whisper-medium, from the reference's ``encdec_init`` carried
across by ``convert.encdec_params_from_jax``.

The reference's functions run under ``jax.jit``, as its steps run them.

Tolerances:

  * ``layernorm_apply`` rel 1e-6 of the largest output (fp32 mean and
    variance summed in another order), ``gelu_mlp_apply`` rel 1e-5 in fp32
    and exact-grid modes (the fp32 sums of the two products), 2e-2 in
    dense mode (bf16 activations: one bf16 rounding flips);
  * ``encode`` / ``decode_hidden`` and the prefill step's logits: rel 1e-4
    of the largest magnitude in quant_sparse (tanh, exp, the sinusoid table
    and LayerNorm's sums differ in their last fp32 bits, which moves an
    activation across a 2**-16 rounding boundary now and then; measured
    1.3e-5 through 2 + 2 layers) and rel 3e-2 in dense (bf16 activations;
    XLA also keeps excess precision in the jitted dense program: measured
    1.2e-2);
  * the cross K/V projection of ``encdec_init_cache`` from the reference's
    encoder states bit for bit in bf16, in both modes (the static path
    builds them dense); end to end, within ``encode``'s tolerance or one
    bf16 ulp at the leaf's largest magnitude (rel 2**-7), the larger;
  * eight ``encdec_decode_step``s from the reference's cache: logits rel
    1e-4 (quant_sparse, measured 2.2e-5) and 2e-2 (dense, measured
    6.4e-3) of their largest magnitude, greedy tokens exact;
  * ``encdec_loss`` and every gradient: loss rel 1e-5, gradients rtol
    1e-5 with a 1e-5 x (max|grad| + 1) floor (DESIGN.md §8, nearest
    rounding);
  * the static session's tokens exact; ``threefry.normal_bf16`` bit for
    bit: 0 of 3,145,728 draws differ from ``jax.random.normal``'s bf16
    (every one of its 128 possible values is drawn).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import sessions as jsessions  # noqa: E402
from repro.api.spec import build_spec as jbuild  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import spring_ops as jops  # noqa: E402
from repro.models import encdec as jed  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.layers import SpringContext as JContext  # noqa: E402
from repro.optim.optimizers import OptimizerConfig  # noqa: E402
from repro.runtime.train import StepConfig  # noqa: E402
from repro.serving import steps as jsteps  # noqa: E402

from repro_torch.api import sessions as tsessions  # noqa: E402
from repro_torch.api import threefry  # noqa: E402
from repro_torch.api.spec import build_spec as tbuild  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import encdec_params_from_jax  # noqa: E402
from repro_torch.core import spring_ops as tops  # noqa: E402
from repro_torch.models import encdec as ted  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.layers import SpringContext as TContext  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves, tree_map  # noqa: E402
from repro_torch.serving import steps as tsteps  # noqa: E402

ARCH = "whisper-medium"
MODES = ("dense", "quant_sparse")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """The reduced config, the reference's parameters (numpy) and the port's
    copy, stub frames (bf16 values) and tokens from a seed."""
    jcfg, tcfg = jget_arch(ARCH).reduced(), get_arch(ARCH).resolve(reduced=True)
    jp = jax.tree_util.tree_map(np.asarray, jed.encdec_init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((2, jcfg.enc_seq, jcfg.d_model)).astype(np.float32)
    frames = np.array(jnp.asarray(frames, jnp.bfloat16).astype(jnp.float32))
    tokens = rng.integers(0, jcfg.vocab, (2, 9)).astype(np.int32)
    return jcfg, tcfg, jp, encdec_params_from_jax(jp), frames, tokens


#: rel tolerance of the hidden states and the prefill logits, by mode (above)
HIDDEN_TOL = {"dense": 3e-2, "quant_sparse": 1e-4}
#: of a bf16 cache leaf: one bf16 ulp at its largest magnitude at least
CACHE_TOL = {mode: max(tol, 2.0**-7) for mode, tol in HIDDEN_TOL.items()}


def _spring(pkg, mode):
    return dataclasses.replace(pkg.MODES[mode], stochastic=False)


def _frames(frames, pkg):
    if pkg == "jax":
        return jnp.asarray(frames, jnp.bfloat16)
    return torch.from_numpy(frames).to(torch.bfloat16)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict) else {prefix + k: v})
    return out


def _np(t) -> np.ndarray:
    return t.detach().to(torch.float32).numpy()


# -- configs, registry, conversion ---------------------------------------------------


def test_config_and_arch_are_the_references():
    port, ref = get_arch(ARCH), jget_arch(ARCH)
    assert dataclasses.asdict(port.config) == dataclasses.asdict(ref.config)
    assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(ref.reduced())
    assert (port.arch_id, port.family, port.source, port.is_encdec) == \
        (ref.arch_id, ref.family, ref.source, True)
    assert port.view(reduced=True).is_encdec and port.config.head_dim == 64
    assert port.config.attn == ted.AttnSpec(16, 16, 64, causal=True)


def test_converted_tree_keeps_the_references_layout(model):
    jcfg, tcfg, jp, tp, _, _ = model
    want = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = tree_leaves(tp)
    assert len(got) == len(want)
    for (path, w), g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=jax.tree_util.keystr(path))
    fresh = _flat(ted.encdec_init(tcfg, 0, device="cpu"))
    assert {k: t.shape for k, t in fresh.items()} == {k: t.shape for k, t in _flat(tp).items()}
    assert fresh["enc_layers/attn/wq/kernel"].shape == (2, 64, 64)


# -- layers -------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 1, 96), (1, 33, 128)])
def test_layernorm_matches_the_reference(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    bias = rng.standard_normal(shape[-1]).astype(np.float32)
    jp = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    tp = {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)}
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        want = jax.jit(jlayers.layernorm_apply)(jp, jnp.asarray(x, jdt))
        got = tlayers.layernorm_apply(tp, torch.from_numpy(x).to(tdt))
        assert got.dtype == tdt
        tol = 1e-6 if tdt == torch.float32 else 8e-3  # bf16: one rounding at the output
        assert _rel(_np(got), np.asarray(want.astype(jnp.float32))) <= tol
    init = tlayers.layernorm_init(7)
    assert init["scale"].tolist() == [1.0] * 7 and init["bias"].tolist() == [0.0] * 7


@pytest.mark.parametrize("mode", ["dense", "quant", "quant_sparse"])
def test_gelu_mlp_matches_the_reference(mode):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 64)).astype(np.float32)
    p = {"fc1": {"kernel": (rng.standard_normal((64, 128)) / 8).astype(np.float32),
                 "bias": (rng.standard_normal(128) / 4).astype(np.float32)},
         "fc2": {"kernel": (rng.standard_normal((128, 64)) / 11).astype(np.float32),
                 "bias": (rng.standard_normal(64) / 4).astype(np.float32)}}
    jctx, tctx = JContext(cfg=_spring(jops, mode)), TContext(cfg=_spring(tops, mode))
    jx = jnp.asarray(x, jnp.bfloat16 if mode == "dense" else jnp.float32)
    want = jax.jit(lambda p_, x_: jlayers.gelu_mlp_apply(p_, x_, jctx))(p, jx)
    tp = tree_map(torch.from_numpy, p)
    got = tlayers.gelu_mlp_apply(tp, torch.from_numpy(x).to(
        torch.bfloat16 if mode == "dense" else torch.float32), tctx)
    assert _rel(_np(got), np.asarray(want.astype(jnp.float32))) <= (
        2e-2 if mode == "dense" else 1e-5)
    # the tanh form, as jax.nn.gelu's default
    h = torch.linspace(-4, 4, 101)
    np.testing.assert_allclose(
        torch.nn.functional.gelu(h, approximate="tanh").numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(h.numpy()))), rtol=0, atol=1e-6)


# -- the model --------------------------------------------------------------------


def _jit_encode(jp, jcfg, frames, spring):
    return jax.jit(lambda p, f: jed.encode(p, jcfg, f, JContext(cfg=spring)))(jp, frames)


@pytest.mark.parametrize("mode", MODES)
def test_encode_and_decode_hidden_match_the_reference(model, mode):
    jcfg, tcfg, jp, tp, frames, tokens = model
    js, ts = _spring(jops, mode), _spring(tops, mode)
    jenc = _jit_encode(jp, jcfg, _frames(frames, "jax"), js)
    tenc = ted.encode(tp, tcfg, _frames(frames, "torch"), TContext(cfg=ts))
    tol = HIDDEN_TOL[mode]
    assert tenc.shape == (2, jcfg.enc_seq, jcfg.d_model)
    assert _rel(_np(tenc), np.asarray(jenc.astype(jnp.float32))) <= tol
    # the decoder from the reference's encoder states: the decoder's own error
    jh = jax.jit(lambda p, t, e: jed.decode_hidden(p, jcfg, t, e, JContext(cfg=js)))(
        jp, jnp.asarray(tokens), jenc)
    th = ted.decode_hidden(tp, tcfg, torch.from_numpy(tokens).long(),
                           torch.from_numpy(np.array(jenc.astype(jnp.float32))).to(tenc.dtype),
                           TContext(cfg=ts))
    assert _rel(_np(th), np.asarray(jh.astype(jnp.float32))) <= tol


@pytest.mark.parametrize("mode", MODES)
def test_init_cache_cross_kv_bit_equal(model, mode):
    """The cross K/V under a context in ``mode`` (the static path's is the
    default, dense): projected from the reference's encoder states, bf16
    bit for bit; from the port's own encoder, within its tolerance; the
    self K/V empty at ``max_len`` rows."""
    jcfg, tcfg, jp, tp, frames, _ = model
    jctx, tctx = JContext(cfg=_spring(jops, mode)), TContext(cfg=_spring(tops, mode))
    jc = jax.jit(lambda p, f: jed.encdec_init_cache(p, jcfg, f, jctx, max_len=11))(
        jp, _frames(frames, "jax"))
    jenc = _jit_encode(jp, jcfg, _frames(frames, "jax"), jctx.cfg)
    from_ref = ted.cross_cache(tp, tcfg, torch.from_numpy(np.array(jenc.astype(jnp.float32))).to(
        torch.bfloat16 if mode == "dense" else torch.float32), tctx, max_len=11)
    own = ted.encdec_init_cache(tp, tcfg, _frames(frames, "torch"), tctx, max_len=11)
    for tc in (from_ref, own):
        assert int(tc["pos"]) == int(jc["pos"]) == 0
        assert tc["self"]["k"].shape == (2, 2, 11, 4, 16)
        assert not tc["self"]["v"].any()
    for name in ("k", "v"):
        want = np.asarray(jc["cross"][name])
        got = from_ref["cross"][name]
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape == (2, 2, 32, 4, 16)
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16),
                                      err_msg=name)
        assert _rel(_np(own["cross"][name]), want.astype(np.float32)) <= CACHE_TOL[mode]


@pytest.mark.parametrize("mode", MODES)
def test_eight_decode_steps_match_the_reference(model, mode):
    """From one cache (the reference's, carried across), eight greedy
    decode steps: each step's logits, then the tokens exact."""
    jcfg, tcfg, jp, tp, frames, tokens = model
    jc = jed.encdec_init_cache(jp, jcfg, _frames(frames, "jax"), JContext(), max_len=12)
    tc = {"pos": torch.tensor(0), "cross": tree_map(
        lambda a: torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16),
        jc["cross"]), "self": tree_map(
        lambda a: torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16),
        jc["self"])}
    jstep = jax.jit(lambda p, t, c: jed.encdec_decode_step(
        p, jcfg, t, c, JContext(cfg=_spring(jops, mode))))
    tctx = TContext(cfg=_spring(tops, mode))
    jt, tt = jnp.asarray(tokens[:, 0]), torch.from_numpy(tokens[:, 0]).long()
    jtoks, ttoks = [], []
    for _ in range(8):
        jl, jc = jstep(jp, jt, jc)
        tl, tc = ted.encdec_decode_step(tp, tcfg, tt, tc, tctx)
        assert tl.dtype == torch.float32 and tl.shape == (2, jcfg.vocab)
        assert _rel(tl.numpy(), np.asarray(jl)) <= (2e-2 if mode == "dense" else 1e-4)
        jt, tt = jnp.argmax(jl, -1), tl.argmax(-1)
        jtoks.append(np.asarray(jt).tolist())
        ttoks.append(tt.tolist())
    assert ttoks == jtoks and int(tc["pos"]) == 8
    np.testing.assert_array_equal(tc["self"]["k"].view(torch.int16).numpy()[:, :, 8:],
                                  np.zeros((2, 2, 4, 4, 16), np.int16))


@pytest.mark.parametrize("mode", MODES)
def test_prefill_step_matches_the_references(model, mode):
    """The encoder-decoder prefill step (the dry run's prefill; the static
    path never calls it): last-position logits and the cache."""
    jcfg, tcfg, jp, tp, frames, tokens = model
    step_cfg = StepConfig(spring=_spring(jops, mode), optimizer=OptimizerConfig())
    jl, jc = jax.jit(jsteps.make_prefill_step(jget_arch(ARCH).view(reduced=True), step_cfg,
                                              reduced=True))(
        jp, {"frames": _frames(frames, "jax"), "tokens": jnp.asarray(tokens)},
        jax.random.PRNGKey(0))
    tl, tc = tsteps.make_prefill_step(tcfg, _spring(tops, mode))(
        tp, torch.from_numpy(tokens).long(), frames=_frames(frames, "torch"))
    assert _rel(_np(tl), np.asarray(jl.astype(jnp.float32))) <= HIDDEN_TOL[mode]
    assert tc["self"]["k"].shape == np.asarray(jc["self"]["k"]).shape == (2, 2, 9, 4, 16)
    assert _rel(_np(tc["cross"]["v"]), np.asarray(jc["cross"]["v"]).astype(np.float32)) <= \
        CACHE_TOL[mode]


@pytest.mark.parametrize("mode", ["quant", "quant_sparse"])
def test_encdec_loss_and_every_gradient_match_the_reference(model, mode):
    jcfg, tcfg, jp, tp, frames, tokens = model
    (want, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jed.encdec_loss(p, jcfg, _frames(frames, "jax"), jnp.asarray(tokens),
                                  JContext(cfg=_spring(jops, mode))), has_aux=True))(jp)
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), tp)
    got, aux = ted.encdec_loss(p, tcfg, _frames(frames, "torch"), torch.from_numpy(tokens).long(),
                               TContext(cfg=_spring(tops, mode)))
    grads = torch.autograd.grad(got, tree_leaves(p))
    assert float(aux["ce"].detach()) == float(got.detach())
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    want_grads = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(want_grads) == 36
    for g, w in zip(grads, want_grads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * (float(np.abs(w).max()) + 1.0))


# -- serving --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_static_session_tokens_equal_the_references(model, mode):
    """The static path from one spec in each package (the encoder-decoder
    never takes the engine): the reference's frames, its cache built under
    a default context, decode from the prompt's first token."""
    jcfg, tcfg, jp, tp, _, _ = model
    sets = [f"arch.id={ARCH}", "shape.batch=3", "shape.prompt_len=5", "shape.gen=6",
            f"numerics.mode={mode}"]
    jspec, tspec = jbuild("serve", sets=sets, use_env=False), tbuild("serve", sets=sets,
                                                                     use_env=False)
    assert jspec.to_json() == tspec.to_json()
    jout = jsessions.ServeSession(jspec, params=jax.tree_util.tree_map(jnp.asarray, jp)).run()
    tout = tsessions.ServeSession(tspec, params=tp, device="cpu").run()
    assert tout["engine"] is False and tout["finite"]
    assert tout["generated"].tolist() == np.asarray(jout["generated"]).tolist()
    assert tout["generated"].shape == (3, 6)


def test_synthetic_frames_are_the_references():
    key = jax.random.PRNGKey(4)
    cfg = get_arch(ARCH).resolve(reduced=True)
    want = jsessions.synthetic_batch(jget_arch(ARCH), jget_arch(ARCH).reduced(), 3, 7, key)
    got = tsessions.synthetic_batch(get_arch(ARCH), cfg, 3, 7, threefry.prng_key(4))
    assert sorted(got) == sorted(want) == ["frames", "tokens"]
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
    assert got["frames"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["frames"].view(torch.int16).numpy(),
                                  np.asarray(want["frames"]).view(np.int16))


@pytest.mark.parametrize("seed,shape", [(0, (4, 8, 96)), (3, (1000, 1000)),
                                        (-7, (2, 256, 6144))])
def test_threefry_normal_bf16_bit_equal(seed, shape):
    """Every draw's bits equal jax's bf16 normal; the count that differ is
    0 (it is asserted, and printed on failure)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
    want = np.asarray(jax.random.normal(key, shape, jnp.bfloat16)).view(np.uint16)
    got = threefry.normal_bf16(threefry.fold_in(threefry.prng_key(seed), 1), shape)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    differ = int((got.view(torch.int16).numpy().view(np.uint16) != want).sum())
    assert differ == 0, f"{differ} of {want.size} bf16 draws differ"
    if want.size >= 10**6:
        assert len(np.unique(want)) == 128  # every value the draw can take
