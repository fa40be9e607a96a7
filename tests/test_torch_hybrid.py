"""Port parity for the hybrid family and the qkv bias: recurrentgemma-9b
(RG-LRU blocks, sliding-window local attention with ring caches, unrolled
suffix layers) and qwen2-7b (attention with a qkv bias), ``repro_torch``
against ``repro`` on the CPU, from the same numpy inputs and
``convert.params_from_jax``.

Tolerances:

  * block arithmetic runs on a fixed-point grid far below fp32's
    resolution (Q16.60, :data:`FINE`): both packages' rounding steps are
    then the identity on every value the block sees, so the comparison is
    of the fp32 arithmetic alone, held at rel 1e-5 (max-abs error over the
    reference's max-abs: sums and transcendentals in another order); bf16
    cache leaves hold one rounding of values that agree to that, so at
    most 1 bf16 ulp apart;
  * the decode state is bf16-equal step by step;
  * rings after a prefill are bit-equal (dense mode on a coarse grid,
    where every projection is exact and rope rounds alike);
  * the plain ``flash_attention`` against the reference's Pallas kernel
    in interpret mode at the registry's fp32 compare, atol 2e-5;
  * logits at the model tests' atol 1e-3 (quantized); served greedy
    tokens, ``finished_by`` and ``finish_tick`` exact; a snapshot's pool
    bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import spring_ops as jops  # noqa: E402
from repro.core.fixedpoint import FixedPointFormat as JFormat  # noqa: E402
from repro.kernels.flash_attention import ops as jfa  # noqa: E402
from repro.launch.serve import serving_config as jserving_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import recurrent as jrec  # noqa: E402
from repro.models.layers import SpringContext as JContext  # noqa: E402
from repro.optim.optimizers import OptimizerConfig  # noqa: E402
from repro.runtime.train import StepConfig  # noqa: E402
from repro.serving import elastic as jelastic  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402

from repro_torch.api import sessions as tsessions  # noqa: E402
from repro_torch.api.spec import SpecError, build_spec  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import spring_ops as tops  # noqa: E402
from repro_torch.core.fixedpoint import FixedPointFormat as TFormat  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.launch.serve import serving_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import recurrent as trec  # noqa: E402
from repro_torch.models.layers import SpringContext as TContext  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves, tree_map  # noqa: E402
from repro_torch.serving import elastic as telastic  # noqa: E402
from repro_torch.serving.elastic.snapshot import _storable  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.paging import PagedServingEngine  # noqa: E402

RG, QWEN = "recurrentgemma-9b", "qwen2-7b"
FIELDS = ("tokens", "finished_by", "finish_tick")
REL = 1e-5
#: Q16.60: nearest rounding on this grid leaves every value above 2**-36
#: unchanged in fp32 (x * 2**60 is then an integer), in both packages
FINE = (16, 60)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / (np.abs(want).max() + 1e-30))


def _bf16_bits(x) -> np.ndarray:
    """bf16 values (a torch tensor or a jax array) as int32 bit patterns."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.bfloat16).view(torch.int16).numpy().astype(np.int32)
    return np.asarray(x).astype(jnp.bfloat16).view(np.int16).astype(np.int32)


def _fine_ctx():
    """The quant mode on the :data:`FINE` grid in both packages."""
    il, fl = FINE
    j = dataclasses.replace(jserving_config("quant"), fmt=JFormat(il=il, fl=fl))
    t = dataclasses.replace(serving_config("quant"), fmt=TFormat(il=il, fl=fl))
    return JContext(cfg=j), TContext(cfg=t)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


# -- configs ----------------------------------------------------------------------


def _same_config(port, ref) -> None:
    """Every field of the port's config (and of its nested specs) equals
    the reference's; the reference's other fields hold their defaults."""
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == dataclasses.asdict(b), f.name
        else:
            assert a == b, f.name
    mine = {f.name for f in dataclasses.fields(port)}
    for f in dataclasses.fields(ref):
        if f.name not in mine:
            assert getattr(ref, f.name) == f.default, f.name


@pytest.mark.parametrize("arch", [RG, QWEN])
def test_configs_equal_the_reference(arch):
    port, ref = get_arch(arch), jget_arch(arch)
    _same_config(port.config, ref.config)
    _same_config(port.reduced(), ref.reduced())
    assert (port.arch_id, port.family, port.source) == (ref.arch_id, ref.family, ref.source)
    port.config.check_supported()
    port.reduced().check_supported()


def test_layer_plan_is_the_references_layer_order():
    """38 layers: 12 repeats of (rglru, rglru, local), then the 2-layer
    suffix; parameters cross in that order."""
    cfg = get_arch(RG).config
    plan = cfg.layer_plan
    assert len(plan) == 38
    assert plan[:3] == [("unit_0", 0, ("rglru", "swiglu")), ("unit_1", 0, ("rglru", "swiglu")),
                        ("unit_2", 0, ("local", "swiglu"))]
    assert plan[-2:] == [("suffix_0", None, ("rglru", "swiglu")),
                         ("suffix_1", None, ("rglru", "swiglu"))]
    rcfg = get_arch(RG).reduced()
    jp = _np(jlm.lm_init(jax.random.PRNGKey(1), jget_arch(RG).reduced()))
    tp = params_from_jax(jp, rcfg)
    np.testing.assert_array_equal(tp["layers"][3]["mixer"]["lam"].numpy(),
                                  jp["suffix_0"]["mixer"]["lam"])
    np.testing.assert_array_equal(tp["layers"][2]["mixer"]["wq"]["kernel"].numpy(),
                                  jp["unit_2"]["mixer"]["wq"]["kernel"][0])
    assert set(tp["layers"][0]["mixer"]) == {"wx", "wy", "conv_w", "conv_b", "w_r", "w_i",
                                             "lam", "wo"}


# -- the RG-LRU block ---------------------------------------------------------------


def _rglru_params(d: int = 32, dr: int = 48, seed: int = 0):
    spec = jrec.RGLRUSpec(d_rnn=dr)
    jp = _np(jrec.rglru_block_init(jax.random.PRNGKey(seed), d, spec))
    jp["conv_b"] = np.random.default_rng(seed).standard_normal(dr).astype(np.float32) * 0.1
    return spec, trec.RGLRUSpec(d_rnn=dr), jp, _t(jp)


@pytest.mark.parametrize("s", [1, 7, 40, 129])
def test_rglru_prefill_output_and_cache_match_the_reference(s):
    """The associative scan over odd and even lengths (one position, a
    recursion that ends odd, a long one): output rel 1e-5, the conv window
    and final state within 1 bf16 ulp (most equal)."""
    jspec, tspec, jp, tp = _rglru_params()
    x = np.random.default_rng(s).standard_normal((2, s, 32)).astype(np.float32)
    jctx, tctx = _fine_ctx()
    jout, jc = jrec.rglru_block_apply(jp, jnp.asarray(x), jctx, jspec, return_cache=True)
    tout, tc = trec.rglru_block_apply(tp, torch.from_numpy(x), tctx, tspec, return_cache=True)
    assert tuple(tout.shape) == jout.shape and tout.dtype == torch.float32
    assert _rel(tout.numpy(), jout) <= REL
    for name in ("conv", "h"):
        assert tuple(tc[name].shape) == jc[name].shape and tc[name].dtype == torch.bfloat16
        ulps = np.abs(_bf16_bits(tc[name]) - _bf16_bits(jc[name]))
        assert ulps.max() <= 1 and ulps.mean() <= 0.01, name


def test_rglru_scan_matches_the_reference_scan():
    """The scan alone, on the gates of one layer: rel 1e-5."""
    rng = np.random.default_rng(3)
    u, r, i = (rng.standard_normal((2, 301, 24)).astype(np.float32) for _ in range(3))
    r, i = 1 / (1 + np.exp(-r)), 1 / (1 + np.exp(-i))
    lam = np.log(np.expm1(np.linspace(0.9, 4.0, 24))).astype(np.float32)
    want = jrec._rglru_scan(*(jnp.asarray(a) for a in (u, r, i, lam)))
    got = trec._rglru_scan(*(torch.from_numpy(a) for a in (u, r, i, lam)))
    assert _rel(got.numpy(), want) <= REL


def test_rglru_decode_state_is_bf16_equal_over_eight_steps():
    """From one shared cache (a prefill's, the reference's bits), eight
    decode steps in each package on the same inputs: every step's conv
    window and state bf16-equal, every output rel 1e-5."""
    jspec, tspec, jp, tp = _rglru_params(seed=2)
    rng = np.random.default_rng(9)
    jctx, tctx = _fine_ctx()
    x0 = rng.standard_normal((3, 11, 32)).astype(np.float32)
    _, jc = jrec.rglru_block_apply(jp, jnp.asarray(x0), jctx, jspec, return_cache=True)
    tc = _cache_to_torch(jc)
    for step in range(8):
        x = rng.standard_normal((3, 1, 32)).astype(np.float32)
        jout, jc = jrec.rglru_block_apply(jp, jnp.asarray(x), jctx, jspec, cache=jc)
        tout, tc = trec.rglru_block_apply(tp, torch.from_numpy(x), tctx, tspec, cache=tc)
        assert _rel(tout.numpy(), jout) <= REL, step
        for name in ("conv", "h"):
            assert tc[name].dtype == torch.bfloat16
            np.testing.assert_array_equal(_bf16_bits(tc[name]), _bf16_bits(jc[name]),
                                          err_msg=f"{name} at step {step}")


# -- sliding-window attention: rings ---------------------------------------------------


def _attn(window: int = 16, h: int = 4, kv: int = 1, hd: int = 16, d: int = 64,
          bias: bool = False):
    """Both packages' AttnSpec and one parameter set on a coarse grid
    (multiples of 2**-6 below 1: every projection sum is exact in fp32)."""
    kw = dict(n_heads=h, n_kv_heads=kv, head_dim=hd, window=window, qkv_bias=bias)
    jspec, tspec = jattn.AttnSpec(**kw), tattn.AttnSpec(**kw)
    jp = _np(jattn.gqa_init(jax.random.PRNGKey(4), d, jspec))
    rng = np.random.default_rng(4)
    for name in jp:
        jp[name]["kernel"] = (np.round(rng.standard_normal(jp[name]["kernel"].shape) * 4)
                              / 64).astype(np.float32)
        if "bias" in jp[name]:
            jp[name]["bias"] = (np.round(rng.standard_normal(jp[name]["bias"].shape) * 4)
                                / 64).astype(np.float32)
    return jspec, tspec, jp, _t(jp)


def _coarse_x(rng, shape):
    return (np.round(rng.standard_normal(shape) * 4) / 64).astype(np.float32)


@pytest.mark.parametrize("s", [9, 16, 37])
def test_ring_prefill_is_bit_equal_to_the_references(s):
    """s < w (zero-padded), s = w and s > w (the last w rows scattered to
    p % w): k_ring / v_ring bit for bit."""
    jspec, tspec, jp, tp = _attn()
    x = _coarse_x(np.random.default_rng(s), (2, s, 64))
    pos = np.broadcast_to(np.arange(s), (2, s))
    jctx, tctx = JContext(cfg=jserving_config("dense")), TContext(cfg=serving_config("dense"))
    _, jc = jattn.gqa_apply(jp, jnp.asarray(x, jnp.bfloat16), jctx, jspec, jnp.asarray(pos),
                            return_cache=True)
    _, tc = tattn.gqa_apply(tp, torch.from_numpy(x).to(torch.bfloat16), tctx, tspec,
                            torch.from_numpy(pos.copy()), return_cache=True)
    assert set(tc) == set(jc) == {"k_ring", "v_ring"}
    for name in tc:
        assert tuple(tc[name].shape) == jc[name].shape == (2, 16, 1, 16)
        np.testing.assert_array_equal(_bf16_bits(tc[name]), _bf16_bits(jc[name]), err_msg=name)
    if s < 16:
        assert not tc["k_ring"][:, s:].any()


def test_windowed_decode_across_a_ring_wrap():
    """Prefill 12 positions of a window-8 ring (it wraps at once), then 10
    decode steps in each package from its own cache, each row at its own
    position: outputs rel 1e-5 (the fine grid), rings within 1 bf16 ulp."""
    jspec, tspec, jp, tp = _attn(window=8, h=4, kv=2)
    rng = np.random.default_rng(0)
    jctx, tctx = _fine_ctx()
    x = rng.standard_normal((2, 12, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(12), (2, 12))
    _, jc = jattn.gqa_apply(jp, jnp.asarray(x), jctx, jspec, jnp.asarray(pos), return_cache=True)
    _, tc = tattn.gqa_apply(tp, torch.from_numpy(x), tctx, tspec,
                            torch.from_numpy(pos.copy()), return_cache=True)
    p = np.array([12, 5], np.int32)  # row 1 as if its prompt were 5 long
    for step in range(10):
        x1 = rng.standard_normal((2, 1, 64)).astype(np.float32)
        jout, jc = jattn.gqa_apply(jp, jnp.asarray(x1), jctx, jspec, jnp.asarray(p[:, None]),
                                   cache=jc, pos=jnp.asarray(p))
        tout, tc = tattn.gqa_apply(tp, torch.from_numpy(x1), tctx, tspec,
                                   torch.from_numpy(p[:, None].astype(np.int64)), cache=tc,
                                   pos=torch.from_numpy(p.astype(np.int64)))
        assert _rel(tout.numpy(), jout) <= REL, step
        for name in ("k_ring", "v_ring"):
            assert np.abs(_bf16_bits(tc[name]) - _bf16_bits(jc[name])).max() <= 1, (name, step)
        p = p + 1


def test_ring_decode_mask_is_the_references():
    """The live slots of a ring at positions before, at and after the
    wrap, for windows shorter than and equal to the ring."""
    pos = torch.arange(0, 40)
    for window in (5, 8):
        got = tattn._valid(pos, 8, window).numpy()
        idx = np.arange(8)[None, :]
        p = pos.numpy()[:, None]
        abs_pos = p - np.mod(p - idx, 8)
        np.testing.assert_array_equal(got, (abs_pos >= 0) & (abs_pos > p - window))
        assert (got.sum(-1) == np.minimum(pos.numpy() + 1, window)).all()


# -- flash attention at D 256 with a window --------------------------------------------


@pytest.mark.parametrize("s,window", [(300, 128), (256, 40), (130, 2048)])
def test_flash_attention_d256_window_plain_matches_the_reference_kernel(s, window):
    """The port's plain version against the reference's Pallas kernel in
    interpret mode (as its own tests run it): D 256, 4 heads on one kv
    head, ragged and aligned S, atol 2e-5."""
    rng = np.random.default_rng(s)
    q = rng.standard_normal((1, 4, s, 256)).astype(np.float32)
    k, v = (rng.standard_normal((1, 1, s, 256)).astype(np.float32) for _ in range(2))
    want = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=True, window=window, impl="interpret"))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


# -- the models through the engines ---------------------------------------------------


def _model(arch: str, biased: bool = False):
    """Reference config and parameters (qwen2's biases random, non-zero),
    the port's config and copy."""
    jview = jget_arch(arch).view(reduced=True)
    jp = _np(jlm.lm_init(jax.random.PRNGKey(0), jview.config))
    if biased:
        rng = np.random.default_rng(11)
        for name in ("wq", "wk", "wv"):
            b = jp["unit_0"]["mixer"][name]["bias"]
            jp["unit_0"]["mixer"][name]["bias"] = (rng.standard_normal(b.shape) * 0.5
                                                   ).astype(np.float32)
    cfg = get_arch(arch).resolve(reduced=True)
    return jview, jp, cfg, params_from_jax(jp, cfg)


def _serve(eng, prompts, gen):
    for i, p in enumerate(prompts):
        eng.submit_prompt(p, gen, seed=100 + i)
    return eng.run()


#: recurrentgemma: 5 prompts of 8-40 tokens across the window of 16 on 3
#: slots (a slot is reused), 9 tokens each: decode crosses the ring
RG_PROMPTS, RG_GEN, RG_SLOTS, RG_MAX_LEN = (8, 13, 16, 23, 40), 9, 3, 64


@pytest.mark.parametrize("arch,lens,gen,slots", [
    (RG, RG_PROMPTS, RG_GEN, RG_SLOTS), (QWEN, (8, 9, 10, 11), 6, 3)])
def test_engine_serves_the_reference_engines_tokens(arch, lens, gen, slots):
    jview, jp, cfg, tp = _model(arch, biased=arch == QWEN)
    if arch == QWEN:
        assert all(bool(tp["layers"][0]["mixer"][n]["bias"].abs().min() > 0)
                   for n in ("wq", "wk", "wv"))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lens]
    step_cfg = StepConfig(spring=jserving_config("quant_sparse"), optimizer=OptimizerConfig())
    kw = dict(n_slots=slots, max_len=RG_MAX_LEN)
    want = _serve(JEngine(jview, step_cfg, params=jp, **kw), prompts, gen)
    got = _serve(ServingEngine(cfg, serving_config("quant_sparse"), params=tp, device="cpu",
                               **kw), prompts, gen)
    assert got["finite"]
    for w, g in zip(want["per_request"], got["per_request"]):
        assert {f: g[f] for f in FIELDS} == {f: w[f] for f in FIELDS}, g["rid"]
        assert g["n_tokens"] == gen
    if arch == QWEN:  # the paged pool too
        paged = _serve(PagedServingEngine(cfg, serving_config("quant_sparse"), params=tp,
                                          device="cpu", page_tokens=8, **kw), prompts, gen)
        assert [r["tokens"] for r in paged["per_request"]] == \
            [r["tokens"] for r in want["per_request"]]


def _cache_to_torch(tree):
    """A reference cache tree as the port's: bf16 leaves bit for bit, pos
    as int64."""
    if isinstance(tree, dict):
        return {k: _cache_to_torch(v) for k, v in tree.items()}
    t = torch.from_numpy(np.array(jnp.asarray(tree, jnp.float32)))
    return t.to(torch.bfloat16) if tree.dtype == jnp.bfloat16 else t.to(torch.int64)


def _close_caches(tc, jc) -> None:
    """The same tree; every bf16 leaf within one bf16 ulp at its largest
    magnitude of the reference's (``tests/test_torch_model.py``'s bound:
    a quantized activation one Q4.16 step off is many ulps of a small
    value)."""
    assert set(tc) == set(jc)
    for key in (k for k in jc if k != "pos"):
        assert set(tc[key]) == set(jc[key]), key
        for name in jc[key]:
            want = np.asarray(jc[key][name]).astype(np.float32)
            assert tuple(tc[key][name].shape) == want.shape, (key, name)
            ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
            np.testing.assert_allclose(tc[key][name].float().numpy(), want, rtol=0, atol=ulp,
                                       err_msg=f"{key}/{name}")


def test_prefill_and_decode_logits_match_the_reference():
    """recurrentgemma reduced, prompt 20 (past the window of 16), then 6
    decode steps, each from the reference's cache of the step before (the
    bf16 state would otherwise carry one rounding's difference into every
    later step): logits atol 1e-3 (quant_sparse), every cache leaf (rings,
    RG-LRU states, the suffix subtrees, keyed as the reference's) within 1
    bf16 ulp at its largest magnitude."""
    jview, jp, cfg, tp = _model(RG)
    jctx = JContext(cfg=jserving_config("quant_sparse"))
    tctx = TContext(cfg=serving_config("quant_sparse"))
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 20)).astype(np.int32)
    jl, jc = jlm.lm_prefill(jp, jview.config, jnp.asarray(tokens), jctx)
    tl, tc = tlm.lm_prefill(tp, cfg, torch.from_numpy(tokens).long(), tctx)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-3)
    _close_caches(tc, jc)
    assert set(jc) == {"pos", "unit_0", "unit_1", "unit_2", "suffix_0", "suffix_1"}
    jc, tc = jlm.pad_cache(jc, 6), tlm.pad_cache(tc, 6)
    assert tc["unit_2"]["k_ring"].shape[-3] == 16  # rings are not padded
    nxt = np.asarray(jl).argmax(-1).astype(np.int32)
    for _ in range(6):
        tl, tc = tlm.lm_decode_step(tp, cfg, torch.from_numpy(nxt).long(), _cache_to_torch(jc),
                                    tctx)
        jl, jc = jlm.lm_decode_step(jp, jview.config, jnp.asarray(nxt), jc, jctx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-3)
        _close_caches(tc, jc)
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)


# -- snapshots ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rg_runs():
    """Both engines on recurrentgemma reduced: 3 requests on 2 slots, a
    snapshot after 3 ticks (rings, RG-LRU state and suffix leaves in the
    pool), then the rest of the run; (snapshot, summary, engine) per
    package."""
    jview, jp, cfg, tp = _model(RG)
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (10, 18, 21)]
    step_cfg = StepConfig(spring=jserving_config("quant_sparse"), optimizer=OptimizerConfig())
    kw = dict(n_slots=2, max_len=40, spec_hash="feedbeefcafe0123")
    makers = {"ref": lambda: JEngine(jview, step_cfg, params=jp, **kw),
              "port": lambda: ServingEngine(cfg, serving_config("quant_sparse"), params=tp,
                                            device="cpu", **kw)}
    out = {}
    for name, make in makers.items():
        eng = make()
        for i, p in enumerate(prompts):
            eng.submit_prompt(p, 6, seed=100 + i)
        for _ in range(3):
            eng.step()
        snap = eng.snapshot()
        out[name] = (snap, eng.run(), make())
    return out


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return _storable(x)[0]
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_recurrentgemma_snapshot_crosses_packages_bit_for_bit(rg_runs, writer, tmp_path):
    """Saved by one package, loaded by the other into a fresh engine, which
    snapshots at once: every pool leaf (pos by value) bit for bit; run on,
    the writer's tokens."""
    snap, want, _ = rg_runs[writer]
    reader_name = "port" if writer == "ref" else "ref"
    reader = rg_runs[reader_name][2]
    path = str(tmp_path / "rg.npz")
    {"ref": jelastic, "port": telastic}[writer].save_snapshot(snap, path)
    loaded = {"ref": jelastic, "port": telastic}[reader_name].load_snapshot(path)
    reader.restore(loaded)
    again = reader.snapshot()
    pool, pool_again = snap["backend"]["pool"], again["backend"]["pool"]
    # pos, suffix_0/1 (conv, h), unit_0/1 (conv, h), unit_2's rings (3 parts each)
    assert len(pool) == len(pool_again) == 1 + 2 * 2 + 2 * 2 + 2 * 3
    for i, (a, b) in enumerate(zip(pool, pool_again)):
        a, b = _bits(a), _bits(b)
        assert a.shape == b.shape, i
        if i == 0:
            assert a.astype(np.int64).tolist() == b.astype(np.int64).tolist()
        else:
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), i
    got = reader.run()
    assert [r["tokens"] for r in got["per_request"]] == [r["tokens"] for r in want["per_request"]]


def test_the_two_runs_serve_the_same_tokens_and_snapshot_alike(rg_runs):
    (jsnap, jout, _), (tsnap, tout, _) = rg_runs["ref"], rg_runs["port"]
    for w, g in zip(jout["per_request"], tout["per_request"]):
        assert {f: g[f] for f in FIELDS} == {f: w[f] for f in FIELDS}, g["rid"]
    for i, (a, b) in enumerate(zip(jsnap["backend"]["pool"], tsnap["backend"]["pool"])):
        a, b = _bits(a), _bits(b)
        assert a.shape == b.shape, i


# -- what the port refuses ---------------------------------------------------------------


def test_paged_recurrentgemma_is_refused():
    cfg = get_arch(RG).resolve(reduced=True)
    with pytest.raises(ValueError, match="recurrentgemma-9b.*no pageable cache leaves"):
        PagedServingEngine(cfg, serving_config("quant_sparse"), device="cpu", n_slots=2,
                           max_len=32, page_tokens=8)
    spec = build_spec("serve", sets=[f"arch.id={RG}", "serving.pages=true"], use_env=False)
    with pytest.raises(SpecError, match=r"serving\.pages.*recurrentgemma-9b"):
        spec.resolve()
    with pytest.raises(SpecError, match=r"serving\.pages"):
        tsessions.ServeSession(spec, device="cpu")


def test_hybrid_training_is_refused_and_serving_resolves():
    """A train spec of recurrentgemma-9b resolves (hybrid training is
    ported), and so does one with a stash value width other than Q4.16's:
    ``value_bits`` and ``capacity`` reach the resolved MemstashConfig as
    in the reference's resolve."""
    from repro.api.spec import build_spec as jbuild_spec

    assert build_spec("train", sets=[f"arch.id={RG}"], use_env=False).resolve().step
    sets = [f"arch.id={RG}", "memstash.value_bits=16", "memstash.policy=stash"]
    got = build_spec("train", sets=sets, use_env=False).resolve()
    want = jbuild_spec("train", sets=sets, use_env=False).resolve()
    assert got.step is not None
    for field in ("policy", "value_bits", "capacity", "min_elems"):
        assert getattr(got.memstash, field) == getattr(want.memstash, field), field
        assert getattr(got.step.memstash, field) == getattr(want.step.memstash, field), field
    assert got.memstash.value_bits == 16
    for arch in (RG, QWEN):
        r = build_spec("serve", sets=[f"arch.id={arch}"], use_env=False).resolve()
        assert r.config.name == f"{arch}-reduced"
    assert build_spec("train", sets=[f"arch.id={QWEN}"], use_env=False).resolve().step


def test_session_serves_recurrentgemma_from_a_spec():
    spec = build_spec("serve", sets=[f"arch.id={RG}", "shape.prompt_len=20", "shape.gen=4",
                                     "serving.queue=3"], use_env=False)
    out = tsessions.ServeSession(spec, device="cpu").run()
    assert out["finite"] and all(r["n_tokens"] == 4 for r in out["per_request"])


def test_qwen2_loss_and_every_gradient_match_the_reference():
    """qwen2-7b trains (resolve() allows it): reduced, random non-zero
    biases, quant mode with SR off; loss rel 1e-5, every gradient (the
    biases' among them) within 1e-5 of the reference's."""
    jview, jp, cfg, tp = _model(QWEN, biased=True)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, (2, 17)).astype(np.int32)
    jspring = dataclasses.replace(jops.MODES["quant"], stochastic=False)
    (want, _), jgrads = jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jview.config, jnp.asarray(tokens), JContext(cfg=jspring)),
        has_aux=True)(jp)
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), tp)
    loss, _ = tlm.lm_loss(p, cfg, torch.from_numpy(tokens).long(),
                          TContext(cfg=dataclasses.replace(tops.MODES["quant"],
                                                           stochastic=False),
                                   attention="chunked"))
    grads = torch.autograd.grad(loss, tree_leaves(p))
    want_grads = tree_leaves(params_from_jax(_np(jgrads), cfg))
    assert len(grads) == len(want_grads) == 3 * 12 + 3
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    for g, w in zip(grads, want_grads):
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * (float(np.abs(w).max()) + 1.0))
