"""Port parity for the MoE family: the MoE FFN (``models/moe.py``), MLA
(``models/attention.py``), olmoe-1b-7b and deepseek-v2-lite-16b, and the
pool's ``ckv`` / ``krope`` leaves, ``repro_torch`` against ``repro`` on
the CPU from the same numpy inputs and ``convert.params_from_jax``.

The reference's functions are run under ``jax.jit``, as its engine runs
them: XLA drops some bf16 round trips in the dense mode (the gate
product into silu, the residual sum into the second norm), so its eager
and jitted results differ there, and the port follows the jitted program.

Tolerances:

  * ``moe_apply``: the routing exactly (each token's experts, which
    assignments are kept, the capacity), ``y`` at rel 1e-5 (max-abs error
    over the reference's max-abs), the aux loss at rel 1e-6 (a mean of
    softmax outputs, whose exp differs in the last bit between the
    libraries);
  * MLA on a fixed-point grid far below fp32's resolution (Q16.60, where
    both packages' rounding is the identity): outputs at rel 1e-5, the
    bf16 caches within 1 bf16 ulp at each leaf's largest magnitude;
  * served greedy tokens, ``finished_by`` and ``finish_tick`` exact, in
    the three modes; a paged snapshot's store bit for bit.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core.fixedpoint import FixedPointFormat as JFormat  # noqa: E402
from repro.launch.serve import serving_config as jserving_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.layers import SpringContext as JContext  # noqa: E402
from repro.optim.optimizers import OptimizerConfig  # noqa: E402
from repro.runtime.train import StepConfig  # noqa: E402
from repro.serving import elastic as jelastic  # noqa: E402
from repro.serving import kvpool as jkvpool  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro.serving.paging import PagedServingEngine as JPaged  # noqa: E402
from repro.serving.paging import store as jstore  # noqa: E402

from repro_torch.api.spec import SpecError, build_spec  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.fixedpoint import FixedPointFormat as TFormat  # noqa: E402
from repro_torch.launch.serve import serving_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.layers import SpringContext as TContext  # noqa: E402
from repro_torch.optim.optimizers import tree_map  # noqa: E402
from repro_torch.serving import elastic as telastic  # noqa: E402
from repro_torch.serving import kvpool as tkvpool  # noqa: E402
from repro_torch.serving.elastic.snapshot import _storable  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.paging import PagedServingEngine  # noqa: E402
from repro_torch.serving.paging import store as tstore  # noqa: E402

OLMOE, DEEPSEEK = "olmoe-1b-7b", "deepseek-v2-lite-16b"
ARCHS = (OLMOE, DEEPSEEK)
MODES = ("dense", "quant", "quant_sparse")
FIELDS = ("tokens", "finished_by", "finish_tick")
#: Q16.60: nearest rounding on this grid leaves every value above 2**-36
#: unchanged in fp32, in both packages
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


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


def _ctx(mode: str, fine: bool = False):
    """The serving numerics of ``mode`` in both packages (on :data:`FINE`)."""
    j, t = jserving_config(mode), serving_config(mode)
    if fine:
        il, fl = FINE
        j = dataclasses.replace(j, fmt=JFormat(il=il, fl=fl))
        t = dataclasses.replace(t, fmt=TFormat(il=il, fl=fl))
    return JContext(cfg=j), TContext(cfg=t)


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


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    port, ref = get_arch(arch), jget_arch(arch)
    _same_config(port.config, ref.config)
    _same_config(port.reduced(), ref.reduced())
    assert (port.arch_id, port.family, port.source) == (ref.arch_id, ref.family, ref.source)
    port.config.check_supported()
    port.reduced().check_supported()
    assert port.family == "moe" and port.config.moe.n_experts == 64


def test_deepseek_layer_plan_has_the_dense_mla_prefix():
    cfg = get_arch(DEEPSEEK).config
    plan = cfg.layer_plan
    assert plan[0] == ("prefix_0", None, ("mla", "swiglu"))
    assert plan[1:] == [("unit_0", i, ("mla", "moe")) for i in range(26)]
    assert cfg.mla.kv_lora_rank == 512 and cfg.moe.n_shared == 2


# -- moe_apply ----------------------------------------------------------------------


def _moe(spec_kw: dict, d: int, shape: tuple, mode: str, seed: int = 0):
    """Both packages' ``moe_apply`` on the same parameters and input (the
    reference jitted; bf16 input in the dense mode, fp32 otherwise):
    (reference (y, aux, routing), port (y, aux, routing record))."""
    jspec = jmoe.MoESpec(**spec_kw)
    tspec = tmoe.MoESpec(**spec_kw)
    jp = _np(jmoe.moe_init(jax.random.PRNGKey(seed), d, jspec))
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jctx, tctx = _ctx(mode)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if mode == "dense":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    jy, ja = jax.jit(lambda p, v: jmoe.moe_apply(p, v, jctx, jspec))(jp, jx)
    with tmoe.record_routing() as rec:
        ty, ta = tmoe.moe_apply(_t(jp), tx, tctx, tspec)
    return (np.asarray(jy.astype(jnp.float32)), float(ja), _reference_routing(jp, jx, jspec),
            ty.float().numpy(), float(ta), rec)


def _reference_routing(jp, jx, spec):
    """The reference's routing of ``jx`` (``moe.py:104-137``, its own
    softmax and ``jax.lax.top_k``): (gate_idx, keep, capacity)."""
    b, s, d = jx.shape
    t, e, k = b * s, spec.n_experts, spec.top_k
    cap = max(int((t * k / e) * spec.capacity_factor + 0.999), 4)
    probs = jax.nn.softmax(jnp.einsum("td,de->te", jx.reshape(t, d).astype(jnp.float32),
                                      jp["router"]["kernel"]), axis=-1)
    idx = np.asarray(jax.lax.top_k(probs, k)[1])
    seen, keep = np.zeros(e, int), np.zeros(idx.shape, bool)
    for i in range(t):
        for j in range(k):
            keep[i, j] = seen[idx[i, j]] < cap
            seen[idx[i, j]] += 1
    return idx, keep, cap


def _same_routing(want, rec) -> None:
    idx, keep, cap = want
    assert [r["capacity"] for r in rec] == [cap]
    assert rec[0]["gate_idx"].numpy().tolist() == idx.tolist()
    assert rec[0]["keep"].numpy().tolist() == keep.tolist()


#: the reference's own case (``tests/test_models.py:110-118``): 8 experts,
#: top-2, capacity factor 1.25 over 48 tokens (cap 15: no drop needed),
#: and one at capacity factor 0.5 (cap 6: a third of the assignments drop)
MOE_CASES = {"reference": dict(n_experts=8, top_k=2, d_ff=32),
             "drops": dict(n_experts=8, top_k=2, d_ff=32, capacity_factor=0.5)}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_matches_the_reference(case, mode):
    jy, ja, want, ty, ta, rec = _moe(MOE_CASES[case], 16, (2, 24, 16), mode)
    _same_routing(want, rec)
    dropped = int((~want[1]).sum())
    assert (dropped > 0) == (case == "drops"), dropped
    assert _rel(ty, jy) <= 1e-5
    assert ta == pytest.approx(ja, rel=1e-6) and ta >= 1.0 - 1e-3
    if mode == "quant_sparse":  # the experts' products on masked_matmul
        issued, total = rec[0]["tile_steps"]
        assert 0 < issued <= total


@pytest.mark.parametrize("mode", MODES)
def test_shared_experts_match_the_reference(mode):
    """deepseek's two always-on experts (one SwiGLU of 2 x 48) on top."""
    kw = dict(n_experts=8, top_k=2, d_ff=48, n_shared=2, shared_d_ff=48, capacity_factor=1.0)
    jy, ja, want, ty, ta, rec = _moe(kw, 64, (1, 20, 64), mode, seed=3)
    _same_routing(want, rec)
    assert _rel(ty, jy) <= 1e-5
    assert ta == pytest.approx(ja, rel=1e-6)


def test_token_chunks_match_the_reference(monkeypatch):
    """The MOE_TOKEN_CHUNK path, with the constant lowered to 8 in both
    packages: 2 x 16 tokens in 4 chunks of 2 x 4, the aux losses averaged."""
    monkeypatch.setattr(jmoe, "MOE_TOKEN_CHUNK", 8)
    monkeypatch.setattr(tmoe, "MOE_TOKEN_CHUNK", 8)
    jy, ja, _, ty, ta, rec = _moe(dict(n_experts=8, top_k=2, d_ff=32), 16, (2, 16, 16),
                                  "quant_sparse", seed=1)
    assert [r["tokens"] for r in rec] == [8] * 4
    assert _rel(ty, jy) <= 1e-5
    assert ta == pytest.approx(ja, rel=1e-6)


def test_a_dropped_assignment_reads_expert_0_with_weight_0():
    """A dropped assignment's gather reads out[0, C - 1] times 0, as the
    reference's: a non-finite value there reaches y in both packages."""
    kw = dict(n_experts=4, top_k=2, d_ff=8, capacity_factor=0.25)
    jspec, tspec = jmoe.MoESpec(**kw), tmoe.MoESpec(**kw)
    jp = _np(jmoe.moe_init(jax.random.PRNGKey(2), 8, jspec))
    jp["w_down"] = jp["w_down"].copy()
    jp["w_down"][0] = np.inf
    x = np.random.default_rng(2).standard_normal((1, 40, 8)).astype(np.float32)
    jctx, tctx = _ctx("dense")  # the quantized modes clamp inf onto the grid
    jy, _ = jax.jit(lambda p, v: jmoe.moe_apply(p, v, jctx, jspec))(
        jp, jnp.asarray(x).astype(jnp.bfloat16))
    ty, _ = tmoe.moe_apply(_t(jp), torch.from_numpy(x).to(torch.bfloat16), tctx, tspec)
    jy, ty = np.asarray(jy.astype(jnp.float32)), ty.float().numpy()
    assert np.isfinite(jy).tolist() == np.isfinite(ty).tolist()
    assert not np.isfinite(ty).all()
    np.testing.assert_array_equal(np.isnan(ty), np.isnan(jy))


# -- MLA ------------------------------------------------------------------------------

MLA = dict(n_heads=4, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)


def _close_leaf(got: torch.Tensor, want) -> None:
    want = np.asarray(want).astype(np.float32)
    assert tuple(got.shape) == want.shape
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=ulp)


def test_mla_prefill_and_absorbed_decode_match_the_reference():
    """Prefill of 2 x 12 tokens (the standard form through the chunked
    attention; the up-projections unquantized), then 3 absorbed decode
    steps at per-row positions, each from the reference's cache."""
    jspec, tspec = jattn.MLASpec(**MLA), tattn.MLASpec(**MLA)
    jp = _np(jattn.mla_init(jax.random.PRNGKey(4), 64, jspec))
    tp = _t(jp)
    jctx, tctx = _ctx("quant", fine=True)
    x = np.random.default_rng(4).standard_normal((2, 12, 64)).astype(np.float32)
    pos = np.tile(np.arange(12), (2, 1))
    jout, jc = jax.jit(lambda p, v: jattn.mla_apply(p, v, jctx, jspec, jnp.asarray(pos),
                                                    return_cache=True))(jp, jnp.asarray(x))
    tout, tc = tattn.mla_apply(tp, torch.from_numpy(x), tctx, tspec, torch.from_numpy(pos),
                               return_cache=True)
    assert _rel(tout.numpy(), jout) <= 1e-5
    assert set(tc) == set(jc) == {"ckv", "krope"}
    for name in jc:
        assert tc[name].dtype == torch.bfloat16
        _close_leaf(tc[name], jc[name])
    jc = {n: jnp.pad(c, ((0, 0), (0, 4), (0, 0))) for n, c in jc.items()}
    step = jax.jit(lambda p, v, c, q: jattn.mla_apply(p, v, jctx, jspec, q[:, None], cache=c,
                                                      pos=q))
    rows = np.array([12, 9], np.int32)  # the second row rewrites a prefilled slot
    for i in range(3):
        xs = np.random.default_rng(10 + i).standard_normal((2, 1, 64)).astype(np.float32)
        tc_in = {n: torch.from_numpy(np.array(jnp.asarray(c, jnp.float32))).to(torch.bfloat16)
                 for n, c in jc.items()}
        jout, jc = step(jp, jnp.asarray(xs), jc, jnp.asarray(rows))
        tout, tc = tattn.mla_apply(tp, torch.from_numpy(xs), tctx, tspec,
                                   torch.from_numpy(rows).long()[:, None], cache=tc_in,
                                   pos=torch.from_numpy(rows).long())
        assert _rel(tout.numpy(), jout) <= 1e-5
        for name in jc:
            _close_leaf(tc[name], jc[name])
        rows = rows + 1


def test_mla_decode_is_batch_invariant():
    """A row's absorbed decode reads the same bits alone and beside others
    (the products in fixed row blocks)."""
    spec = tattn.MLASpec(**MLA)
    gen = torch.Generator().manual_seed(0)
    p = tattn.mla_init(gen, 64, spec, device="cpu")
    ctx = TContext(cfg=serving_config("quant_sparse"))
    cache = tattn.mla_init_cache(3, spec, 16)
    cache = {n: torch.randn(c.shape, generator=gen).to(torch.bfloat16) for n, c in cache.items()}
    x = torch.randn(3, 1, 64, generator=gen)
    pos = torch.tensor([5, 9, 2])
    full, _ = tattn.mla_apply(p, x, ctx, spec, pos[:, None], cache=cache, pos=pos)
    one, _ = tattn.mla_apply(p, x[1:2], ctx, spec, pos[1:2, None],
                             cache={n: c[1:2] for n, c in cache.items()}, pos=pos[1:2])
    assert torch.equal(full[1:2], one)


# -- the models -------------------------------------------------------------------------


def _model(arch: str):
    jview = jget_arch(arch).view(reduced=True)
    jp = _np(jlm.lm_init(jax.random.PRNGKey(0), jview.config))
    cfg = get_arch(arch).resolve(reduced=True)
    return jview, jp, cfg, params_from_jax(jp, cfg)


def test_lm_hidden_aux_matches_the_reference():
    """Reduced olmoe (3 MoE layers): the summed load-balancing losses."""
    jview, jp, cfg, tp = _model(OLMOE)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 10)).astype(np.int32)
    jctx, tctx = _ctx("quant")
    jh, ja = jax.jit(lambda p, t: jlm.lm_hidden(p, jview.config, t, jctx))(jp, jnp.asarray(tokens))
    th, ta = tlm.lm_hidden(tp, cfg, torch.from_numpy(tokens).long(), tctx)
    assert float(ta) == pytest.approx(float(ja), rel=1e-6) and float(ta) >= 3 * (1.0 - 1e-3)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-3)


def _serve(eng, prompts, gen=6):
    for i, p in enumerate(prompts):
        eng.submit_prompt(p, gen, seed=100 + i)
    return eng.run()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_arch_serves_the_reference_tokens(arch, mode):
    """3 slots, 4 requests of 8 and 11 tokens, 6 tokens each: the port's
    monolithic and paged engines serve the reference engine's greedy
    tokens, ``finished_by`` and ``finish_tick``."""
    jview, jp, cfg, tp = _model(arch)
    rng = np.random.default_rng(5)
    # two prompt lengths: each is one more compile of the reference's prefill
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (8, 11, 8, 11)]
    kw = dict(n_slots=3, max_len=20)
    step_cfg = StepConfig(spring=jserving_config(mode), optimizer=OptimizerConfig())
    want = _serve(JEngine(jview, step_cfg, params=jp, **kw), prompts)
    spring = serving_config(mode)
    mono = _serve(ServingEngine(cfg, spring, params=tp, device="cpu", **kw), prompts)
    paged = _serve(PagedServingEngine(cfg, spring, params=tp, device="cpu", page_tokens=8, **kw),
                   prompts)
    for out in (mono, paged):
        assert out["finite"]
        for w, g in zip(want["per_request"], out["per_request"]):
            assert {f: g[f] for f in FIELDS} == {f: w[f] for f in FIELDS}, (arch, g["rid"])


def test_prefill_caches_and_decode_logits_match_the_reference():
    """Reduced deepseek, prompt 9 on 2 rows, then 3 decode steps from the
    reference's cache: logits atol 1e-3 (quant_sparse), the ``prefix_0``
    and ``unit_0`` latent caches within 1 bf16 ulp, padded along their
    seq axis (-2) by ``pad_cache``."""
    jview, jp, cfg, tp = _model(DEEPSEEK)
    jctx, tctx = _ctx("quant_sparse")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 9)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jlm.lm_prefill(p, jview.config, t, jctx))(
        jp, jnp.asarray(tokens))
    tl, tc = tlm.lm_prefill(tp, cfg, torch.from_numpy(tokens).long(), tctx)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-3)
    assert set(tc) == set(jc) == {"pos", "prefix_0", "unit_0"}
    jc, tc = jlm.pad_cache(jc, 3), tlm.pad_cache(tc, 3)
    for key in ("prefix_0", "unit_0"):
        for name in ("ckv", "krope"):
            assert tc[key][name].shape[-2] == 12
            _close_leaf(tc[key][name], jc[key][name])
    step = jax.jit(lambda p, t, c: jlm.lm_decode_step(p, jview.config, t, c, jctx))
    nxt = np.asarray(jl).argmax(-1).astype(np.int32)
    for _ in range(3):
        tcache = {"pos": torch.tensor(int(jc["pos"]))}
        tcache.update({k: {n: torch.from_numpy(np.array(jnp.asarray(v, jnp.float32)))
                           .to(torch.bfloat16) for n, v in jc[k].items()}
                       for k in ("prefix_0", "unit_0")})
        tl, _ = tlm.lm_decode_step(tp, cfg, torch.from_numpy(nxt).long(), tcache, tctx)
        jl, jc = step(jp, jnp.asarray(nxt), jc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-3)
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)


# -- the pool ---------------------------------------------------------------------------


def test_pool_tables_match_the_reference():
    assert tkvpool.PACKED_SEQ_AXIS == jkvpool.PACKED_SEQ_AXIS
    assert tstore.PAGED_LEAVES == jstore.PAGED_LEAVES


def test_latent_pool_packs_round_trips_and_moves_slots_bit_for_bit():
    """Reduced deepseek's pool: ``prefix_0`` (slot axis 0) and ``unit_0``
    (slot axis 1) latent leaves packed; a prefill installed in slot 1
    unpacks to its bits (seq tail zero), a slot payload restores into
    another slot, and a release zeroes the slot."""
    _, _, cfg, tp = _model(DEEPSEEK)
    ctx = TContext(cfg=serving_config("quant_sparse"))
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (1, 7))).long()
    _, pc = tlm.lm_prefill(tp, cfg, toks, ctx)
    pool = tkvpool.init_pool(cfg, 3, 16)
    assert all(isinstance(pool[k][n], tkvpool.PackedKV) for k in ("prefix_0", "unit_0")
               for n in ("ckv", "krope"))
    tkvpool.install_packed(pool, pc, 1, 7)
    dense = tkvpool.unpack_cache(pool)
    for key, ax in (("prefix_0", 0), ("unit_0", 1)):
        for name in ("ckv", "krope"):
            row = dense[key][name].select(ax, 1)
            assert torch.equal(row.narrow(-2, 0, 7), pc[key][name].select(ax, 0))
            assert not row.narrow(-2, 7, 9).any()
            assert not dense[key][name].select(ax, 0).any()
    payload = tkvpool.extract_slot_packed(pool, 1)
    tkvpool.restore_slot_packed(pool, payload, 2)
    dense = tkvpool.unpack_cache(pool)
    for key, ax in (("prefix_0", 0), ("unit_0", 1)):
        for name in ("ckv", "krope"):
            assert torch.equal(dense[key][name].select(ax, 2), dense[key][name].select(ax, 1))
    tkvpool.release_packed(pool, 1)
    assert not tkvpool.unpack_cache(pool)["prefix_0"]["ckv"].select(0, 1).any()


@pytest.fixture(scope="module")
def deepseek_paged_runs():
    """Both packages' paged engines on reduced deepseek (every cache leaf
    pageable, one under ``prefix_0``): 3 requests on 2 slots, two ticks, a
    page-budget cut to 3 pages (a request spills), a snapshot,
    then the rest of the run; (snapshot, summary, engine) per package."""
    jview, jp, cfg, tp = _model(DEEPSEEK)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (9, 11, 9)]
    step_cfg = StepConfig(spring=jserving_config("quant_sparse"), optimizer=OptimizerConfig())
    kw = dict(n_slots=2, max_len=24, page_tokens=8, prefill_chunk=1,
              spec_hash="feedbeefcafe0123")
    makers = {"ref": lambda: JPaged(jview, step_cfg, params=jp, **kw),
              "port": lambda: PagedServingEngine(cfg, serving_config("quant_sparse"),
                                                 params=tp, device="cpu", **kw)}
    out = {}
    for name, make in makers.items():
        eng = make()
        for i, p in enumerate(prompts):
            eng.submit_prompt(p, 6, seed=100 + i)
        for _ in range(2):
            eng.step()
        eng.rescale(num_pages=3)
        snap = eng.snapshot()
        out[name] = (snap, eng.run(), make())
    return out


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return _storable(x)[0]
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def test_deepseek_paged_runs_match(deepseek_paged_runs):
    (jsnap, jout, _), (tsnap, tout, _) = deepseek_paged_runs["ref"], deepseek_paged_runs["port"]
    for w, g in zip(jout["per_request"], tout["per_request"]):
        assert {f: g[f] for f in FIELDS} == {f: w[f] for f in FIELDS}, g["rid"]
    assert tout["elastic"]["n_spills"] == jout["elastic"]["n_spills"] >= 1
    # prefix_0's and unit_0's ckv and krope, each as mask, nnz, values
    assert len(tsnap["backend"]["store"]) == len(jsnap["backend"]["store"]) == 12


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_paged_deepseek_snapshot_crosses_packages_bit_for_bit(deepseek_paged_runs, writer,
                                                               tmp_path):
    """Saved by one package, loaded by the other into a fresh engine, which
    snapshots at once: the page store and slot state bit for bit (``pos``
    by value), the spilled request still parked; run on, the writer's
    tokens."""
    snap, want, _ = deepseek_paged_runs[writer]
    reader_name = "port" if writer == "ref" else "ref"
    reader = deepseek_paged_runs[reader_name][2]
    path = str(tmp_path / "deepseek.npz")
    {"ref": jelastic, "port": telastic}[writer].save_snapshot(snap, path)
    reader.restore({"ref": jelastic, "port": telastic}[reader_name].load_snapshot(path))
    again = reader.snapshot()
    assert again["kind"] == snap["kind"] == "paged"
    for part in ("store", "state"):
        a_leaves, b_leaves = snap["backend"][part], again["backend"][part]
        assert len(a_leaves) == len(b_leaves) > 0
        for i, (a, b) in enumerate(zip(a_leaves, b_leaves)):
            a, b = _bits(a), _bits(b)
            assert a.shape == b.shape, (part, i)
            if part == "state":
                assert a.astype(np.int64).tolist() == b.astype(np.int64).tolist()
            else:
                assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (part, i)
    assert snap["scheduler"]["spilled"]
    got = reader.run()
    assert [r["tokens"] for r in got["per_request"]] == [r["tokens"] for r in want["per_request"]]


# -- what the port refuses --------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_training_is_refused_and_serving_resolves(arch):
    """A train spec of the arch resolves (MoE training is ported), and so
    does one with the lossy stash: ``capacity`` and ``value_bits`` reach the
    resolved MemstashConfig as in the reference's resolve."""
    from repro.api.spec import build_spec as jbuild_spec

    r = build_spec("train", sets=[f"arch.id={arch}"], use_env=False).resolve()
    assert r.config.name == f"{arch}-reduced" and r.step is not None
    sets = [f"arch.id={arch}", "memstash.capacity=0.25", "memstash.policy=stash"]
    got = build_spec("train", sets=sets, use_env=False).resolve()
    want = jbuild_spec("train", sets=sets, use_env=False).resolve()
    assert got.step is not None
    for field in ("policy", "value_bits", "capacity", "min_elems"):
        assert getattr(got.memstash, field) == getattr(want.memstash, field), field
        assert getattr(got.step.memstash, field) == getattr(want.step.memstash, field), field
    assert got.memstash.capacity == 0.25
    r = build_spec("serve", sets=[f"arch.id={arch}", "serving.pages=true"],
                   use_env=False).resolve()
    assert r.config.name == f"{arch}-reduced"
