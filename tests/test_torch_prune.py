"""Magnitude pruning in the port (``SpringContext.maybe_prune``,
``runtime/pruning.py``, ``StepConfig.prune_ratio`` and the serving steps'
``prune_ratio``) against the reference, on the CPU at reduced sizes, from
numpy inputs drawn from a seed.

Tolerances, and why:
  masks       exact: the threshold is the reference's fp32 value (its
              erfinv and population std), so every weight lands on the
              same side.  A weight within an ulp of ``t * std`` could flip
              (the two packages sum the std in other orders); the test
              names any such flip with its distance from the threshold.
  pruning     ``apply_pruning`` bit-equal: the quantile is jax's, fp32
              index arithmetic included.
  training    as ``tests/_torch_train_parity.py``: on the Q16.60 grid loss
              rel 1e-5 and every gradient within the contract at rtol 1e-5;
              dense mode loss rel 1e-4 and gradients within 5e-2 x max|grad|.
  serving     greedy tokens, finish reasons and finish ticks equal.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLMStream as JStream  # noqa: E402
from repro.launch.serve import serving_config as jserving_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.layers import SpringContext as JContext  # noqa: E402
from repro.optim.optimizers import OptimizerConfig as JOptConfig  # noqa: E402
from repro.runtime import pruning as jpruning  # noqa: E402
from repro.runtime.train import StepConfig as JStepConfig  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.serve import serving_config  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.layers import SpringContext as TContext  # noqa: E402
from repro_torch.models.layers import prune_threshold  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves, tree_map  # noqa: E402
from repro_torch.runtime import pruning as tpruning  # noqa: E402
from repro_torch.runtime import train as ttrain  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.paging import PagedServingEngine  # noqa: E402

from _torch_train_parity import assert_grads_close, model, springs  # noqa: E402

ARCH = "llama3.2-1b"
RATIOS = (0.2, 0.5, 0.8)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# -- maybe_prune ---------------------------------------------------------------------


def test_prune_threshold_is_the_reference_fp32_value_at_every_percent():
    for k in range(1, 100):
        want = float(jax.scipy.special.erfinv(jnp.float32(k / 100)) * math.sqrt(2.0))
        assert prune_threshold(k / 100) == want, k


@pytest.mark.parametrize("ratio", RATIOS)
@pytest.mark.parametrize("shape,scale", [((256, 384), 0.05), ((64, 1000), 3.0), ((3, 128, 96), 1.0)])
def test_maybe_prune_masks_equal_the_reference(ratio, shape, scale):
    rng = np.random.default_rng(int(ratio * 10) + len(shape))
    w = (rng.standard_normal(shape) * scale).astype(np.float32)
    # a heavy tail too: the threshold is Gaussian-calibrated, not a quantile
    w[..., :7] *= 10.0
    want = np.asarray(JContext(prune_ratio=ratio).maybe_prune(jnp.asarray(w)))
    got = TContext(prune_ratio=ratio).maybe_prune(torch.from_numpy(w)).numpy()
    flips = np.flatnonzero((want == 0) != (got == 0))
    t = prune_threshold(ratio) * float(np.std(w, dtype=np.float64))
    assert flips.size == 0, [(int(i), float(abs(w.reshape(-1)[i]) - t)) for i in flips[:8]]
    np.testing.assert_array_equal(got, want)


def test_maybe_prune_gives_the_pruned_entries_a_zero_gradient():
    w = torch.randn((64, 96), generator=torch.Generator().manual_seed(0)).requires_grad_(True)
    pruned = TContext(prune_ratio=0.5).maybe_prune(w)
    (g,) = torch.autograd.grad(pruned.sum(), w)
    assert torch.equal(g, (pruned != 0).to(g.dtype))
    assert TContext().maybe_prune(w) is w


# -- PruneSchedule / apply_pruning / measured_sparsity ------------------------------


@pytest.mark.parametrize("final,start,ramp", [(0.5, 10, 30), (0.6, 0, 1), (0.5, 0, 2),
                                              (0.9, 20, 100), (0.3, 5, 0)])
def test_prune_schedule_equals_the_reference_in_fp32(final, start, ramp):
    js = jpruning.PruneSchedule(final_sparsity=final, start_step=start, ramp_steps=ramp)
    ts = tpruning.PruneSchedule(final_sparsity=final, start_step=start, ramp_steps=ramp)
    for step in range(0, 130, 3):
        want = np.asarray(js.sparsity_at(jnp.asarray(step)))
        got = ts.sparsity_at(step)
        assert got.dtype == torch.float32 and got.numpy() == want, step


def _tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "big": (rng.standard_normal((256, 192)) * 0.1).astype(np.float32),
        "stack": rng.standard_normal((3, 96, 80)).astype(np.float32),
        "thin": rng.standard_normal((200, 40)).astype(np.float32),  # spared: 40 < 64
        "norm": np.ones((128,), np.float32),
        "nested": {"w": rng.uniform(-1, 1, (70, 65)).astype(np.float32),
                   "ties": np.repeat(rng.standard_normal((80, 1)), 80, 1).astype(np.float32)},
    }


@pytest.mark.parametrize("step", [0, 1, 2, 5, 100])
def test_apply_pruning_is_bit_equal_to_the_reference(step):
    params = _tree(step)
    sched = dict(final_sparsity=0.6, start_step=0, ramp_steps=4)
    want = _np(jpruning.apply_pruning(params, jnp.asarray(step),
                                      jpruning.PruneSchedule(**sched)))
    got = tpruning.apply_pruning(tree_map(torch.from_numpy, params), step,
                                 tpruning.PruneSchedule(**sched))
    for path in ("big", "stack", "thin", "norm"):
        np.testing.assert_array_equal(got[path].numpy(), want[path], err_msg=path)
    for k in ("w", "ties"):
        np.testing.assert_array_equal(got["nested"][k].numpy(), want["nested"][k])
    assert got["thin"] is not None and np.array_equal(got["thin"].numpy(), params["thin"])
    assert float(tpruning.measured_sparsity(got)) == float(jpruning.measured_sparsity(want))


def test_apply_pruning_on_the_lm_treats_a_unit_stack_as_one_leaf():
    """The reference stacks a unit position's layers in one leaf; given the
    config, the port prunes them with one threshold and counts them as one
    (the stacked norms included) — bit-equal, sparsity equal."""
    jcfg, tcfg, jp, tp, _ = model(ARCH)
    sched = dict(final_sparsity=0.5, start_step=0, ramp_steps=2, min_dim=32)
    want = _np(jpruning.apply_pruning(jp, jnp.asarray(3), jpruning.PruneSchedule(**sched)))
    got = tpruning.apply_pruning(tp, 3, tpruning.PruneSchedule(**sched), cfg=tcfg)
    for g, w in zip(tree_leaves(got), tree_leaves(params_from_jax(want, tcfg))):
        assert torch.equal(g, w)
    assert float(tpruning.measured_sparsity(got, cfg=tcfg)) == \
        float(jpruning.measured_sparsity(want))
    # per layer, the thresholds differ: the stacked leaf is what is equal
    alone = tpruning.apply_pruning(tp, 3, tpruning.PruneSchedule(**sched))
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(alone), tree_leaves(got)))


def _jax_index_quantile(a_sorted: np.ndarray, q: np.float32) -> np.float32:
    """numpy's emulation of jnp.quantile's linear method: fp32 index
    arithmetic, clamped gathers, fp32 weights."""
    f = np.float32
    n = f(a_sorted.size)
    qn = f(q) * (n - f(1))
    low, high = np.floor(qn), np.ceil(qn)
    hw = qn - low
    lw = f(1) - hw
    lo = min(int(np.clip(low, f(0), n - f(1))), a_sorted.size - 1)
    hi = min(int(np.clip(high, f(0), n - f(1))), a_sorted.size - 1)
    return f(a_sorted[lo] * lw + a_sorted[hi] * hw)


@pytest.mark.parametrize("n,qs,against_jax", [(2**24 + 3, (0.5,), True),
                                              (2**24 + 1021, (0.3, 1.0), False)])
def test_quantile_past_2_24_elements_follows_jax_index_arithmetic(n, qs, against_jax):
    """Past 2**24 elements ``q * (n - 1)`` rounds in fp32, as in jax (each
    case sorts 16.8 M values, seconds on the CPU)."""
    rng = np.random.default_rng(n)
    x = np.abs(rng.standard_normal(n).astype(np.float32))
    a = np.sort(x)
    for q in map(np.float32, qs):
        got = tpruning.quantile_f32(torch.from_numpy(x), q)
        assert got.numpy() == _jax_index_quantile(a, q), float(q)
        if against_jax:  # the reference itself
            assert got.numpy() == np.asarray(jnp.quantile(jnp.asarray(x), q))


def test_quantile_nan_gives_nan_as_jax_does():
    x = torch.tensor([0.5, float("nan"), 0.25, 1.0])
    assert torch.isnan(tpruning.quantile_f32(x, 0.5))
    assert bool(jnp.isnan(jnp.quantile(jnp.asarray(x.numpy()), jnp.float32(0.5))))


# -- training --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["fine", "dense"])
def test_pruned_loss_and_every_gradient_match_the_reference(mode):
    jcfg, tcfg, jp, tp, tokens = model(ARCH)
    js, ts = springs(mode)
    (want, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jcfg, jnp.asarray(tokens),
                              JContext(cfg=js, prune_ratio=0.5)), has_aux=True))(jp)
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), tp)
    got, _ = tlm.lm_loss(p, tcfg, torch.from_numpy(tokens).long(),
                         TContext(cfg=ts, prune_ratio=0.5, attention="chunked"))
    grads = torch.autograd.grad(got, tree_leaves(p))
    want_grads = tree_leaves(params_from_jax(_np(jgrads), tcfg))
    # the pruned entries of every dense projection get no gradient
    wq = tp["layers"][0]["mixer"]["wq"]["kernel"]
    pruned = TContext(prune_ratio=0.5).maybe_prune(wq) == 0
    assert 0.45 < float(pruned.float().mean()) < 0.55
    at = next(i for i, t in enumerate(tree_leaves(tp)) if t is wq)
    assert bool((grads[at][pruned] == 0).all())
    if mode == "dense":
        assert float(got) == pytest.approx(float(want), rel=1e-4)
        for g, w in zip(grads, want_grads):
            w = w.numpy()
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=5e-2 * float(np.abs(w).max()))
    else:
        assert float(got) == pytest.approx(float(want), rel=1e-5)
        for g, w in zip(grads, want_grads):
            assert_grads_close(g, w)


def test_step_config_prune_ratio_reaches_the_train_step():
    """Three make_train_step steps with StepConfig(prune_ratio=0.5) against
    the reference's, on the fine grid (losses rel 1e-5); the unpruned
    step's losses differ."""
    from repro.optim import optimizers as jopt
    from repro.runtime import train as jtrain
    from repro_torch.convert import train_state_from_jax

    jview, tview = jget_arch(ARCH).view(reduced=True), get_arch(ARCH).view(reduced=True)
    js, ts = springs("fine")
    losses = {}
    for ratio in (0.5, 0.0):
        jstep = jtrain.StepConfig(spring=js, prune_ratio=ratio,
                                  optimizer=jopt.OptimizerConfig(lr=3e-3, warmup_steps=2))
        tstep = ttrain.StepConfig(spring=ts, prune_ratio=ratio,
                                  optimizer=topt.OptimizerConfig(lr=3e-3, warmup_steps=2))
        jstate = jtrain.init_train_state(jax.random.PRNGKey(0), jview, jstep)
        tstate = train_state_from_jax(*(_np(x) for x in (jstate.params, jstate.opt_state,
                                                         jstate.step, jstate.rng)),
                                      tview.config)
        jfn = jax.jit(jtrain.make_train_step(jview, jstep))
        tfn = ttrain.make_train_step(tview, tstep)
        stream = JStream(JDataConfig(seed=3, vocab=tview.config.vocab, seq_len=24,
                                     global_batch=4))
        got = []
        for step in range(3):
            tokens = np.array(stream.batch(step))
            jstate, jm = jfn(jstate, {"tokens": jnp.asarray(tokens)})
            tstate, tm = tfn(tstate, {"tokens": torch.from_numpy(tokens).long()})
            assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
            got.append(float(tm["loss"]))
        losses[ratio] = got
    assert losses[0.5] != losses[0.0]


def test_eager_pruning_training_keeps_learning():
    """The reference's eager-pruning loop (``tests/test_extensions.py``) in
    the port: sparsify to 50% during training, the loss still drops and the
    weights are about half zeros at the end."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLMStream

    cfg = get_arch(ARCH).resolve(reduced=True)
    data = SyntheticLMStream(DataConfig(seed=0, vocab=cfg.vocab, seq_len=64, global_batch=8),
                             device="cpu")
    params = tlm.lm_init(cfg, 0, device="cpu")
    opt_init, opt_update = topt.make_optimizer(topt.OptimizerConfig(lr=3e-3, warmup_steps=5))
    opt_state = opt_init(params)
    sched = tpruning.PruneSchedule(final_sparsity=0.5, start_step=10, ramp_steps=30, min_dim=32)
    losses = []
    for i in range(60):
        p = tree_map(lambda t: t.detach().requires_grad_(True), params)
        loss, _ = tlm.lm_loss(p, cfg, data.batch(i),
                              TContext(attention="chunked"))
        grads = iter(torch.autograd.grad(loss, tree_leaves(p)))
        params, opt_state, _ = opt_update(tree_map(lambda _: next(grads), params), opt_state,
                                          params)
        params = tpruning.apply_pruning(params, i, sched, cfg=cfg)
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0] - 0.5, "pruned training must still learn"
    sp = float(tpruning.measured_sparsity(params, cfg=cfg))
    assert 0.4 < sp < 0.6, f"expected ~50% weight sparsity, got {sp}"


# -- serving ---------------------------------------------------------------------------


def _serve(eng, prompts, gen):
    for i, p in enumerate(prompts):
        eng.submit_prompt(p, gen, seed=100 + i)
    return eng.run()


@pytest.mark.parametrize("paged", [False, True])
def test_pruned_engines_serve_the_reference_engines_tokens(paged):
    jview = jget_arch(ARCH).view(reduced=True)
    jp = _np(jlm.lm_init(jax.random.PRNGKey(0), jview.config))
    cfg = get_arch(ARCH).resolve(reduced=True)
    tp = params_from_jax(jp, cfg)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (8, 11, 9, 14)]
    kw = dict(n_slots=3, max_len=40)
    jstep = JStepConfig(spring=jserving_config("quant_sparse"), optimizer=JOptConfig(),
                        prune_ratio=0.5)
    want = _serve(JEngine(jview, jstep, params=jp, **kw), prompts, 6)
    if paged:
        eng = PagedServingEngine(cfg, serving_config("quant_sparse"), params=tp, device="cpu",
                                 page_tokens=8, prune_ratio=0.5, **kw)
    else:
        eng = ServingEngine(cfg, serving_config("quant_sparse"), params=tp, device="cpu",
                            prune_ratio=0.5, **kw)
    got = _serve(eng, prompts, 6)
    assert got["finite"]
    fields = ("tokens", "finished_by", "finish_tick")
    for w, g in zip(want["per_request"], got["per_request"]):
        assert {f: g[f] for f in fields} == {f: w[f] for f in fields}, g["rid"]
    unpruned = _serve(ServingEngine(cfg, serving_config("quant_sparse"), params=tp,
                                    device="cpu", **kw), prompts, 6)
    assert [r["tokens"] for r in unpruned["per_request"]] != \
        [r["tokens"] for r in got["per_request"]]


def test_serve_session_takes_prune_ratio_on_both_paths():
    """ServeSession(prune_ratio=...) reaches the static path's steps and the
    engine: the tokens change against the unpruned run."""
    from repro_torch.api.sessions import ServeSession
    from repro_torch.api.spec import build_spec

    for sets in (["serving.static=true"], []):
        spec = build_spec("serve", sets=sets + ["shape.prompt_len=8", "shape.gen=4"],
                          use_env=False)
        out = [ServeSession(spec, prune_ratio=r, device="cpu").run() for r in (0.0, 0.6)]
        assert all(o["finite"] for o in out)
        assert not np.array_equal(out[0]["generated"], out[1]["generated"]), sets
