"""Port parity for internvl2-26b's image prefix and for the int8 KV cache,
``repro_torch`` against ``repro`` on the CPU from the reference's
``lm_init`` carried across by ``convert.params_from_jax``.

* internvl2-26b (reduced: 3 layers, d 96, a GQA group of 3, an 8-position
  image prefix): ``lm_prefill`` with the image embeddings ahead of the
  text, ``lm_loss`` over the text positions, both engines' greedy tokens
  (the reference's monolithic engine is built with room for the image
  rows, which its ``from_spec`` leaves out), the sessions from one spec, the
  synthetic image prefixes, and a paged ``.npz`` snapshot holding an image
  request, across packages.  Both packages' engines start a VLM request's
  decode at the prompt's token count (ROADMAP §3), so engine tokens are not
  the static path's.
* The int8 cache on the reduced llama3.2-1b: ``_q8`` / ``_dq8`` exact, the
  int8 prefill and decode of ``gqa_apply``, ``gqa_init_cache("int8")`` and
  ``pad_cache``, and the static session's tokens with
  ``serving.int8_cache=true`` in every mode.

Tolerances: logits and attention outputs atol 1e-3 in the quantized modes
and 2e-2 in dense, as ``tests/test_torch_model.py`` holds the LM's (fp32
sums in another order move a Q4.16 activation by a step now and then;
measured 3.5e-5 at the image prefill, 1.2e-5 at the int8 decode); bf16
cache leaves within one bf16 ulp at their largest magnitude; int8 lines
within one step and their bf16 scales within one ulp where the
projections feeding them differ in their last fp32 bits, exact where the
inputs are the reference's; the loss rel 1e-5 and every gradient rtol
1e-5 with a 1e-5 x (max|grad| + 1) floor, but the untied embedding's,
whose floor is 1e-4 x (max|grad| + 1): it is the end of the backward pass
through every layer, and with no head gradient added to it its token rows
carry every layer's rounding flips (measured 7.0e-5 against a largest
gradient of 1.86); tokens, finish ticks and snapshot bits exact.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import sessions as jsessions  # noqa: E402
from repro.api.spec import build_spec as jbuild  # noqa: E402
from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import spring_ops as jops  # noqa: E402
from repro.launch.serve import serving_config as jserving_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.layers import SpringContext as JContext  # noqa: E402
from repro.optim.optimizers import OptimizerConfig  # noqa: E402
from repro.runtime.train import StepConfig  # noqa: E402
from repro.serving import elastic as jelastic  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402
from repro.serving.paging import PagedServingEngine as JPaged  # noqa: E402

from repro_torch.api import sessions as tsessions  # noqa: E402
from repro_torch.api import threefry  # noqa: E402
from repro_torch.api.spec import build_spec as tbuild  # noqa: E402
from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import spring_ops as tops  # noqa: E402
from repro_torch.launch.serve import serving_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.layers import SpringContext as TContext  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves, tree_map  # noqa: E402
from repro_torch.serving import elastic as telastic  # noqa: E402
from repro_torch.serving.elastic.snapshot import _storable  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.paging import PagedServingEngine  # noqa: E402

VLM, LLAMA = "internvl2-26b", "llama3.2-1b"
FIELDS = ("tokens", "finished_by", "finish_tick")
LOGIT_ATOL = {"dense": 2e-2, "quant": 1e-3, "quant_sparse": 1e-3}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(arch):
    jview = jget_arch(arch).view(reduced=True)
    jp = jlm.lm_init(jax.random.PRNGKey(0), jview.config)
    cfg = get_arch(arch).resolve(reduced=True)
    return jview, jp, cfg, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg)


@pytest.fixture(scope="module")
def vlm():
    return _model(VLM)


@pytest.fixture(scope="module")
def llama():
    return _model(LLAMA)


def _spring(pkg, mode):
    return dataclasses.replace(pkg.MODES[mode], stochastic=False)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return _storable(x)[0]
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _images(n, cfg, seed):
    """(n, P, d) bf16 image embeddings: the port's tensors and the
    reference's arrays, the same bits."""
    t = threefry.normal_bf16(threefry.prng_key(seed), (n, cfg.vlm_prefix_len, cfg.d_model))
    return t, jnp.asarray(_f32(t), jnp.bfloat16)


def _assert_cache_close(tc: dict, jc: dict) -> None:
    """bf16 leaves within one bf16 ulp at the leaf's largest magnitude; int8
    lines within one step, their bf16 scales within one ulp."""
    assert int(tc["pos"]) == int(jc["pos"])
    for key in (k for k in jc if k != "pos"):
        assert sorted(tc[key]) == sorted(jc[key]), key
        for name, want in jc[key].items():
            got = tc[key][name]
            assert str(got.dtype).split(".")[-1] == str(want.dtype), (key, name)
            w = _f32(want)
            tol = 1.0 if want.dtype == jnp.int8 else 2.0 ** (np.floor(np.log2(
                max(np.abs(w).max(), 1e-30))) - 7)
            assert np.abs(_f32(got) - w).max() <= tol, (key, name)


# -- configs and the registry ---------------------------------------------------------


def test_vlm_config_is_the_references():
    port, ref = get_arch(VLM), jget_arch(VLM)
    for a, b in ((port.config, ref.config), (port.reduced(), ref.reduced())):
        for f in dataclasses.fields(b):
            if hasattr(a, f.name):
                x, y = getattr(a, f.name), getattr(b, f.name)
                if dataclasses.is_dataclass(y):
                    x, y = dataclasses.asdict(x), dataclasses.asdict(y)
                assert x == y, f.name
    assert (port.arch_id, port.family, port.source, port.is_encdec) == \
        (ref.arch_id, ref.family, ref.source, False)
    assert port.config.vlm_prefix_len == 256 and port.reduced().vlm_prefix_len == 8


def test_the_registry_holds_all_ten_of_the_references_archs():
    assert list(ARCHS) == list(JARCHS) and len(ARCHS) == 10


@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_every_arch_resolves_a_serve_spec(arch):
    r = tbuild("serve", sets=[f"arch.id={arch}"], use_env=False).resolve()
    assert r.config.name == f"{arch}-reduced" and r.view.is_encdec == (arch == "whisper-medium")


# -- the image prefix ---------------------------------------------------------------


@pytest.mark.parametrize("mode", ["dense", "quant_sparse"])
def test_lm_prefill_with_the_image_prefix_matches_the_reference(vlm, mode):
    jview, jp, cfg, tp = vlm
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, (2, 11)).astype(np.int32)
    timg, jimg = _images(2, cfg, 3)
    jl, jc = jax.jit(lambda p, t, i: jlm.lm_prefill(
        p, jview.config, t, JContext(cfg=_spring(jops, mode)), i))(jp, jnp.asarray(tokens), jimg)
    tl, tc = tlm.lm_prefill(tp, cfg, torch.from_numpy(tokens).long(),
                            TContext(cfg=_spring(tops, mode)), timg)
    assert int(tc["pos"]) == cfg.vlm_prefix_len + 11
    np.testing.assert_allclose(_f32(tl), np.asarray(jl), rtol=0, atol=LOGIT_ATOL[mode])
    _assert_cache_close(tc, jc)
    with pytest.raises(ValueError, match="image prefix"):
        tlm.lm_prefill(tp, cfg, torch.from_numpy(tokens).long(), TContext())


def test_lm_loss_reads_the_text_positions(vlm):
    jview, jp, cfg, tp = vlm
    tokens = np.random.default_rng(2).integers(0, cfg.vocab, (2, 13)).astype(np.int32)
    timg, jimg = _images(2, cfg, 4)
    (want, _), jgrads = jax.jit(jax.value_and_grad(lambda p: jlm.lm_loss(
        p, jview.config, jnp.asarray(tokens), JContext(cfg=_spring(jops, "quant")), jimg),
        has_aux=True))(jp)
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), tp)
    got, aux = tlm.lm_loss(p, cfg, torch.from_numpy(tokens).long(),
                           TContext(cfg=_spring(tops, "quant"), attention="chunked"), timg)
    grads = torch.autograd.grad(got, tree_leaves(p))
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    assert float(aux["ce"].detach()) == pytest.approx(float(want), rel=1e-5)
    want_grads = tree_leaves(params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), cfg))
    assert len(grads) == len(want_grads) == 3 * 9 + 3
    for i, (g, w) in enumerate(zip(grads, want_grads)):
        w = w.numpy()
        floor = 1e-4 if g is grads[0] else 1e-5  # the embedding's (above)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=floor * (float(np.abs(w).max()) + 1.0), err_msg=str(i))
    assert want_grads[0].shape == tp["embed"]["embedding"].shape


def _vlm_requests(cfg):
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (9, 12, 9, 10)]
    timg, jimg = _images(4, cfg, 11)
    return prompts, timg, jimg


@pytest.mark.parametrize("mode", ["dense", "quant_sparse"])
@pytest.mark.parametrize("backend", ["monolithic", "paged"])
def test_engine_tokens_equal_the_references(vlm, backend, mode):
    """4 image requests on 3 slots: greedy tokens, finished_by and finish
    ticks equal, monolithic and paged (page 4; whole-prompt installs)."""
    jview, jp, cfg, tp = vlm
    prompts, timg, jimg = _vlm_requests(cfg)
    kw = dict(n_slots=3, max_len=cfg.vlm_prefix_len + 12 + 6 + 1)
    step_cfg = StepConfig(spring=jserving_config(mode), optimizer=OptimizerConfig())
    if backend == "paged":
        kw.update(page_tokens=4, prefill_chunk=None)
        jeng = JPaged(jview, step_cfg, params=jp, **kw)
        teng = PagedServingEngine(cfg, serving_config(mode), params=tp, device="cpu", **kw)
    else:
        jeng = JEngine(jview, step_cfg, params=jp, **kw)
        teng = ServingEngine(cfg, serving_config(mode), params=tp, device="cpu", **kw)
    for eng, imgs in ((jeng, jimg), (teng, timg)):
        for i, p in enumerate(prompts):
            eng.submit_prompt(p, 6, seed=i, img_embeds=imgs[i])
    want, got = jeng.run(), teng.run()
    assert got["finite"]
    for w, g in zip(want["per_request"], got["per_request"]):
        assert {f: g[f] for f in FIELDS} == {f: w[f] for f in FIELDS}, g["rid"]
    if backend == "paged":
        assert got["paging"]["prefix_hits"] == want["paging"]["prefix_hits"] == 0


def test_sessions_serve_the_image_prefix_from_one_spec(vlm):
    """The reference's paged session and the port's paged and monolithic
    sessions from one spec: the same tokens (the reference's monolithic
    ``from_spec`` sizes its pool without the image rows and stops at the
    first install, ROADMAP §3)."""
    jview, jp, cfg, tp = vlm
    sets = [f"arch.id={VLM}", "shape.batch=2", "shape.prompt_len=6", "shape.gen=4",
            "serving.queue=3", "numerics.mode=quant_sparse"]
    jout = jsessions.ServeSession(jbuild("serve", sets=sets + ["serving.pages=true"],
                                         use_env=False), params=jp).run()
    want = np.asarray(jout["generated"]).tolist()
    for pages in ("true", "false"):
        tout = tsessions.ServeSession(tbuild("serve", sets=sets + [f"serving.pages={pages}"],
                                             use_env=False), params=tp, device="cpu").run()
        assert tout["finite"] and tout["generated"].tolist() == want, pages
    static = tsessions.ServeSession(tbuild("serve", sets=sets + ["serving.static=true"],
                                           use_env=False), params=tp, device="cpu").run()
    jstatic = jsessions.ServeSession(jbuild("serve", sets=sets + ["serving.static=true"],
                                            use_env=False), params=jp).run()
    assert static["generated"].tolist() == np.asarray(jstatic["generated"]).tolist()


def test_synthetic_image_prefixes_are_the_references():
    """``synthetic_batch``'s img_embeds and the engine session's per-request
    images (a folded key a chunk) bit for bit."""
    jarch, arch = jget_arch(VLM), get_arch(VLM)
    cfg = arch.resolve(reduced=True)
    key = jax.random.PRNGKey(5)
    want = jsessions.synthetic_batch(jarch, jarch.reduced(), 3, 4, key)
    got = tsessions.synthetic_batch(arch, cfg, 3, 4, threefry.prng_key(5))
    assert sorted(got) == sorted(want) == ["img_embeds", "tokens"]
    np.testing.assert_array_equal(got["tokens"], np.asarray(want["tokens"]))
    np.testing.assert_array_equal(_bits(got["img_embeds"]), _bits(want["img_embeds"]))
    images = tsessions.synthetic_images(5, 3, cfg.vlm_prefix_len, cfg.d_model, 5)
    chunk1 = jsessions.synthetic_batch(jarch, jarch.reduced(), 3, 4, jax.random.fold_in(key, 1))
    assert len(images) == 5 and images[0].shape == (cfg.vlm_prefix_len, cfg.d_model)
    for i, img in enumerate(images):
        src = want if i < 3 else chunk1
        np.testing.assert_array_equal(_bits(img), _bits(src["img_embeds"][i % 3]))


@pytest.fixture(scope="module")
def vlm_paged_runs(vlm):
    """Both packages' paged engines: 3 image requests on 2 slots, two ticks,
    a page-budget cut (a request spills), a snapshot, then the rest of the
    run; (snapshot, summary, a fresh engine) per package."""
    jview, jp, cfg, tp = vlm
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (9, 11, 9)]
    timg, jimg = _images(3, cfg, 12)
    step_cfg = StepConfig(spring=jserving_config("quant_sparse"), optimizer=OptimizerConfig())
    kw = dict(n_slots=2, max_len=cfg.vlm_prefix_len + 11 + 6 + 1, page_tokens=8,
              prefill_chunk=1, spec_hash="feedbeefcafe0123")
    makers = {"ref": (lambda: JPaged(jview, step_cfg, params=jp, **kw), jimg),
              "port": (lambda: PagedServingEngine(cfg, serving_config("quant_sparse"),
                                                  params=tp, device="cpu", **kw), timg)}
    out = {}
    for name, (make, imgs) in makers.items():
        eng = make()
        for i, p in enumerate(prompts):
            eng.submit_prompt(p, 6, seed=100 + i, img_embeds=imgs[i])
        for _ in range(2):
            eng.step()
        eng.rescale(num_pages=4)
        snap = eng.snapshot()
        out[name] = (snap, eng.run(), make())
    return out


def test_vlm_paged_runs_match(vlm_paged_runs):
    (_, jout, _), (_, tout, _) = vlm_paged_runs["ref"], vlm_paged_runs["port"]
    for w, g in zip(jout["per_request"], tout["per_request"]):
        assert {f: g[f] for f in FIELDS} == {f: w[f] for f in FIELDS}, g["rid"]
    assert tout["elastic"]["n_spills"] == jout["elastic"]["n_spills"] >= 1


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_paged_image_snapshot_crosses_packages_bit_for_bit(vlm_paged_runs, writer, tmp_path):
    """Saved by one package, loaded by the other into a fresh engine, which
    snapshots at once: the store, the slot state and every request's image
    bit for bit; run on, the writer's tokens."""
    snap, want, _ = vlm_paged_runs[writer]
    reader_name = "port" if writer == "ref" else "ref"
    reader = vlm_paged_runs[reader_name][2]
    path = str(tmp_path / "vlm.npz")
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
    reqs = snap["requests"]
    assert len(reqs) == len(again["requests"]) == 3
    for a, b in zip(reqs, again["requests"]):
        assert _bits(a["img_embeds"]).tobytes() == _bits(b["img_embeds"]).tobytes()
    got = reader.run()
    assert [r["tokens"] for r in got["per_request"]] == [r["tokens"] for r in want["per_request"]]


# -- the int8 KV cache ---------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 7, 3, 16), (1, 1, 8, 64), (3, 5, 2, 128)])
def test_q8_and_dq8_exact(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 30, shape[:-1])[..., None]).astype(
        np.float32)
    x[..., 0] = 0.5 * np.round(x[..., 0])  # values on .5 steps: round half to even shows
    x[0, 0, 0] = 0.0  # an all-zero line: scale 1e-9
    jq, js = jattn._q8(jnp.asarray(x))
    tq, ts = tattn._q8(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    np.testing.assert_array_equal(tattn._dq8(tq, ts).numpy(), np.asarray(jattn._dq8(jq, js)))
    # bf16 inputs (dense mode's k / v)
    jq, js = jattn._q8(jnp.asarray(x, jnp.bfloat16))
    tq, ts = tattn._q8(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))


def test_int8_init_cache_and_pad_cache_are_the_references(llama):
    jview, _, cfg, _ = llama
    jc = jlm.lm_init_cache(jview.config, 2, 9, "int8")
    tc = tlm.lm_init_cache(cfg, 2, 9, "int8")
    assert sorted(tc["unit_0"]) == sorted(jc["unit_0"]) == ["k_q8", "k_sc", "v_q8", "v_sc"]
    for name, want in jc["unit_0"].items():
        got = tc["unit_0"][name]
        assert tuple(got.shape) == want.shape and str(got.dtype).split(".")[-1] == str(want.dtype)
    jp, tp = jlm.pad_cache(jc, 3), tlm.pad_cache(tc, 3)
    for name, want in jp["unit_0"].items():
        assert tuple(tp["unit_0"][name].shape) == want.shape, name
    ring = tattn.gqa_init_cache(2, dataclasses.replace(cfg.attn, window=4), 9, "int8")
    assert sorted(ring) == ["k_ring", "v_ring"] and ring["k_ring"].dtype == torch.bfloat16


@pytest.mark.parametrize("mode", ["dense", "quant_sparse"])
def test_int8_prefill_and_decode_match_the_reference(llama, mode):
    """``gqa_apply`` of the first layer with the int8 cache: the prefill's
    int8 leaves, then three decode steps from the reference's cache
    (outputs and the new lines)."""
    jview, jp, cfg, tp = llama
    spec = cfg.attn
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    jl = jax.tree_util.tree_map(lambda a: a[0], jp["unit_0"])["mixer"]
    tl = tp["layers"][0]["mixer"]
    dt = (jnp.bfloat16, torch.bfloat16) if mode == "dense" else (jnp.float32, torch.float32)
    jctx = JContext(cfg=_spring(jops, mode), int8_cache=True)
    tctx = TContext(cfg=_spring(tops, mode), int8_cache=True)
    pos = np.broadcast_to(np.arange(7), (2, 7))
    _, jc = jax.jit(lambda p, x_: jattn.gqa_apply(p, x_, jctx, spec, jnp.asarray(pos),
                                                  return_cache=True))(jl, jnp.asarray(x, dt[0]))
    _, tc = tattn.gqa_apply(tl, torch.from_numpy(x).to(dt[1]), tctx, spec,
                            torch.from_numpy(pos.copy()), return_cache=True)
    assert sorted(tc) == sorted(jc) == ["k_q8", "k_sc", "v_q8", "v_sc"]
    for name in jc:  # one int8 step apart at most (fp32 projections' last bits)
        assert np.abs(_f32(tc[name]) - _f32(jc[name])).max() <= (
            1.0 if name.endswith("q8") else 2.0**-7 * np.abs(_f32(jc[name])).max()), name
    jc = jlm.pad_cache({"pos": 7, "unit_0": jc}, 3)["unit_0"]
    tc = {n: torch.from_numpy(_bits(a).copy()).view(torch.bfloat16) if a.dtype == jnp.bfloat16
          else torch.from_numpy(np.asarray(a).copy()) for n, a in jc.items()}
    step = jax.jit(lambda p, x_, c, q: jattn.gqa_apply(p, x_, jctx, spec, q, c, q[:, 0]))
    for t in range(3):
        xt = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        q = np.full((2, 1), 7 + t, np.int32)
        jo, jc = step(jl, jnp.asarray(xt, dt[0]), jc, jnp.asarray(q))
        to, tc = tattn.gqa_apply(tl, torch.from_numpy(xt).to(dt[1]), tctx, spec,
                                 torch.from_numpy(q).long(), tc, torch.from_numpy(q[:, 0]).long())
        np.testing.assert_allclose(_f32(to), _f32(jo), rtol=0, atol=LOGIT_ATOL[mode])
        for name in jc:
            assert np.abs(_f32(tc[name]) - _f32(jc[name])).max() <= (
                1.0 if name.endswith("q8") else 2.0**-7 * np.abs(_f32(jc[name])).max()), name


@pytest.mark.parametrize("mode", ["dense", "quant", "quant_sparse"])
def test_int8_static_session_tokens_equal_the_references(llama, mode):
    jview, jp, cfg, tp = llama
    sets = [f"arch.id={LLAMA}", "shape.batch=2", "shape.prompt_len=9", "shape.gen=6",
            "serving.static=true", "serving.int8_cache=true", f"numerics.mode={mode}"]
    jout = jsessions.ServeSession(jbuild("serve", sets=sets, use_env=False), params=jp).run()
    tout = tsessions.ServeSession(tbuild("serve", sets=sets, use_env=False), params=tp,
                                  device="cpu").run()
    assert tout["finite"] and tout["engine"] is False
    assert tout["generated"].tolist() == np.asarray(jout["generated"]).tolist()
