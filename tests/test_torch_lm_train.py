"""Port parity, LM training: ``repro_torch`` against ``repro`` on the CPU,
at the reduced llama3.2-1b.

The same inputs (the reference's ``lm_init`` parameters carried across by
``convert.params_from_jax``, tokens from a seed) go through the JAX
function and its port.  Tolerances, and why:

  exact      the token stream (threefry, bit for bit), checkpoint names
             and values, a remat or stash recompute against no remat
             (the same ops on the same bits), resume against an
             uninterrupted run of the port.
  rel 1e-5   losses in quant / quant_sparse with nearest rounding, and the
             chunked cross-entropy and attention in fp32: fp32 sums in
             another order.
  grads      rtol 1e-5 with an absolute floor of 1e-5 x (max|grad| + 1)
             (``tests/test_torch_train.py``'s contract).
  dense      bf16 activations: XLA and torch round different intermediates
             to bf16, loss rel 1e-4 and grads within 5e-2 x max|grad|
             (measured: 3.9e-5 and 1.9e-2); bf16 logits likewise.
  train      three steps of the reference's ``make_train_step`` (AdamW with
             warmup; SGDm with ``microbatch=2``): losses rel 1e-5, the
             first moments at the gradient contract, SGDm's params within
             1e-5; one optimizer update on shared gradients rel 1e-6 (an
             Adam step jumps where a gradient is within its sum-order
             error of 0, so AdamW's params are held through these).

Model-level SR draws from ``torch.Generator`` seeds, not threefry, so the
parity cases run ``numerics.stochastic=off`` and fp32 master weights;
SR training is held by its loss (the reference's own bounds).
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import build_spec as jbuild  # noqa: E402
from repro.api.sessions import TrainSession as JTrainSession  # noqa: E402
from repro.checkpoint import manager as jckpt  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import spring_ops as jops  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLMStream as JStream  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import losses as jlosses  # noqa: E402
from repro.models.layers import SpringContext as JContext  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.runtime import train as jtrain  # noqa: E402

from repro_torch.api import build_spec as tbuild  # noqa: E402
from repro_torch.api import threefry  # noqa: E402
from repro_torch.api.sessions import TrainSession  # noqa: E402
from repro_torch.checkpoint import manager as tckpt  # noqa: E402
from repro_torch.configs import get_arch as tget_arch  # noqa: E402
from repro_torch.convert import params_from_jax, train_state_from_jax  # noqa: E402
from repro_torch.core import spring_ops as tops  # noqa: E402
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.memstash.config import MemstashConfig  # noqa: E402
from repro_torch.memstash.instrument import record_stash_traffic  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import losses as tlosses  # noqa: E402
from repro_torch.models.layers import SpringContext as TContext  # noqa: E402
from repro_torch.optim import optimizers as topt  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves, tree_map  # noqa: E402
from repro_torch.runtime import train as ttrain  # noqa: E402

ARCH = "llama3.2-1b"
EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "examples", "specs",
                       "train_quant_sparse.json")


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """The reference's reduced config and ``lm_init`` parameters, the
    port's config and its copy of them, and a (2, 33) token batch."""
    jcfg, tcfg = jget_arch(ARCH).reduced(), tget_arch(ARCH).resolve(reduced=True)
    jp = jax.tree_util.tree_map(np.asarray, jlm.lm_init(jax.random.PRNGKey(0), jcfg))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 33)).astype(np.int32)
    return jcfg, tcfg, jp, params_from_jax(jp, tcfg), tokens


def assert_grads_close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * (float(np.max(np.abs(want))) + 1.0))


def _with_grad(params):
    return tree_map(lambda t: t.detach().clone().requires_grad_(True), params)


# -- the token stream ----------------------------------------------------------------


@pytest.mark.parametrize("seed,vocab,seq,batch", [(0, 512, 64, 8), (7, 128256, 33, 3),
                                                  (123, 1000, 128, 2), (5, 97, 17, 5)])
def test_lm_stream_tokens_bit_equal_to_the_reference(seed, vocab, seq, batch):
    jstream = JStream(JDataConfig(seed=seed, vocab=vocab, seq_len=seq, global_batch=batch))
    tstream = SyntheticLMStream(DataConfig(seed=seed, vocab=vocab, seq_len=seq,
                                           global_batch=batch), device="cpu")
    for step in (0, 1, 29):
        want = np.asarray(jstream.batch(step))
        np.testing.assert_array_equal(tstream.tokens(step), want)
        got = tstream.batch(step)
        assert got.dtype == torch.int64 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 42, -3])
def test_threefry_uniform_bit_equal(seed):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 5)
    for shape in ((1,), (7,), (8, 127), (3, 5, 2)):
        want = np.asarray(jax.random.uniform(key, shape))
        got = threefry.uniform(threefry.fold_in(threefry.prng_key(seed), 5), shape)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# -- the chunked cross-entropy and attention -----------------------------------------


@pytest.mark.parametrize("n,chunk,bf16", [(21, 8, False), (16, 16, False), (21, 512, False),
                                          (21, 8, True)])
def test_chunked_softmax_xent_value_and_grads(n, chunk, bf16):
    rng = np.random.default_rng(n + chunk)
    h = rng.standard_normal((2, n, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 50)) / 6).astype(np.float32)
    y = rng.integers(0, 50, (2, n)).astype(np.int32)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    want, (wgh, wgw) = jax.value_and_grad(
        lambda h_, w_: jlosses.chunked_softmax_xent(h_, jnp.asarray(y), w_, chunk=chunk,
                                                    logits_dtype=jdt), (0, 1))(h, w)
    th, tw = torch.tensor(h, requires_grad=True), torch.tensor(w, requires_grad=True)
    got = tlosses.chunked_softmax_xent(th, torch.from_numpy(y), tw, chunk=chunk,
                                       logits_dtype=tdt)
    got.backward()
    rtol = 1e-2 if bf16 else 1e-5
    assert float(got.detach()) == pytest.approx(float(want), rel=rtol * 0.1)
    assert_grads_close(th.grad, wgh, rtol)
    assert_grads_close(tw.grad, wgw, rtol)


@pytest.mark.parametrize("causal,window,s,q_chunk,group", [
    (True, None, 48, 16, 4), (True, 20, 48, 16, 2), (False, None, 40, 16, 1),
    (True, 5, 32, 8, 4)])
def test_chunked_attention_output_and_grads(causal, window, s, q_chunk, group):
    rng = np.random.default_rng(s + group)
    kv, d = 2, 8
    q = rng.standard_normal((2, s, kv * group, d)).astype(np.float32)
    k, v = (rng.standard_normal((2, s, kv, d)).astype(np.float32) for _ in range(2))
    g = rng.standard_normal((2, s, kv * group, d)).astype(np.float32)

    def jf(q_, k_, v_):
        out = jattn._chunked_attention(q_, k_, v_, causal=causal, window=window,
                                       q_chunk=q_chunk)
        return jnp.sum(out * g), out

    (_, want), jgrads = jax.value_and_grad(jf, (0, 1, 2), has_aux=True)(q, k, v)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    got = tattn._chunked_attention(tq, tk, tv, causal=causal, window=window, q_chunk=q_chunk)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    for t, jg in zip((tq, tk, tv), jgrads):
        assert_grads_close(t.grad, jg)


# -- the loss and its gradients --------------------------------------------------------


def _ref_loss_and_grads(jp, jcfg, tokens, spring):
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jcfg, jnp.asarray(tokens), JContext(cfg=spring)),
        has_aux=True))(jp)
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def _port_loss_and_grads(tp, tcfg, tokens, spring, memstash=None, attention="chunked"):
    p = _with_grad(tp)
    loss, _ = tlm.lm_loss(p, tcfg, torch.from_numpy(tokens).long(),
                          TContext(cfg=spring, memstash=memstash, attention=attention))
    grads = torch.autograd.grad(loss, tree_leaves(p))
    return float(loss.detach()), grads


@pytest.mark.parametrize("mode", ["quant", "quant_sparse", "dense"])
def test_lm_loss_and_every_gradient_match_the_reference(model, mode):
    jcfg, tcfg, jp, tp, tokens = model
    want, jgrads = _ref_loss_and_grads(
        jp, jcfg, tokens, dataclasses.replace(jops.MODES[mode], stochastic=False))
    got, grads = _port_loss_and_grads(
        tp, tcfg, tokens, dataclasses.replace(tops.MODES[mode], stochastic=False))
    want_grads = tree_leaves(params_from_jax(jgrads, tcfg))
    assert len(grads) == len(want_grads) == 3 * 9 + 2
    if mode == "dense":
        assert got == pytest.approx(want, rel=1e-4)
        for g, w in zip(grads, want_grads):
            w = w.numpy()
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=5e-2 * float(np.abs(w).max()))
    else:
        assert got == pytest.approx(want, rel=1e-5)
        for g, w in zip(grads, want_grads):
            assert_grads_close(g, w)


def test_bf16_logits_loss_matches_the_reference(model):
    jcfg, tcfg, jp, tp, tokens = model
    spring = dataclasses.replace(jops.QUANT, stochastic=False)
    want, _ = _ref_loss_and_grads(jp, dataclasses.replace(jcfg, bf16_logits=True), tokens,
                                  spring)
    got, _ = _port_loss_and_grads(tp, dataclasses.replace(tcfg, bf16_logits=True), tokens,
                                  dataclasses.replace(tops.QUANT, stochastic=False))
    assert got == pytest.approx(want, rel=1e-4)


def test_pinned_flash_route_trains_through_the_plain_version(model):
    """With flash_attention pinned the full-sequence pass takes the flash
    wrapper, as the reference's does; on the CPU its plain version is
    differentiable and agrees with the chunked route."""
    _, tcfg, _, tp, tokens = model
    spring = dataclasses.replace(tops.QUANT, stochastic=False)
    chunked = _port_loss_and_grads(tp, tcfg, tokens, spring)
    flash = _port_loss_and_grads(tp, tcfg, tokens, spring, attention="flash")
    assert flash[0] == pytest.approx(chunked[0], rel=1e-5)
    for a, b in zip(flash[1], chunked[1]):
        assert_grads_close(a, b)


# -- remat policies (the reference's tests/test_memstash.py:245-292) --------------------


@pytest.mark.parametrize("mode", ["quant", "dense"])
@pytest.mark.parametrize("policy", ["full", "block_io", "stash"])
def test_remat_policies_equal_no_remat(model, mode, policy):
    """Each policy recomputes the same ops on the same bits (nearest
    rounding; the stash restores its input exactly), so loss and every
    gradient equal the run without remat; only "stash" records the
    ``lm/residual`` stash point."""
    _, tcfg, _, tp, tokens = model
    spring = dataclasses.replace(tops.MODES[mode], stochastic=False)
    plain = _port_loss_and_grads(tp, dataclasses.replace(tcfg, remat=False), tokens, spring)
    with record_stash_traffic() as rows:
        got = _port_loss_and_grads(
            tp, dataclasses.replace(tcfg, remat=True, remat_policy=policy), tokens, spring,
            memstash=MemstashConfig(policy="stash"))
    assert got[0] == plain[0]
    for a, b in zip(got[1], plain[1]):
        assert torch.equal(a, b)
    assert bool([r for r in rows if r["layer"] == "lm/residual"]) == (policy == "stash")


@pytest.mark.parametrize("memstash,stashed", [
    (MemstashConfig(policy="none"), False),
    (MemstashConfig(policy="stash", per_layer=(("lm/*", "remat"),)), False),
    (MemstashConfig(policy="stash", min_elems=10**9), False),
    (MemstashConfig(policy="stash"), True),
    (None, True),  # no step-level config: the nomination stands
])
def test_memstash_config_vetoes_the_stash_nomination(model, memstash, stashed):
    _, tcfg, _, tp, tokens = model
    cfg = dataclasses.replace(tcfg, remat_policy="stash")
    with record_stash_traffic() as rows, torch.no_grad():
        tlm.lm_loss(tp, cfg, torch.from_numpy(tokens[:, :16]).long(),
                    TContext(memstash=memstash, attention="chunked"))
    assert any(r["layer"] == "lm/residual" for r in rows) == stashed


def test_stash_policy_names_the_cnn_points():
    ctx = TContext(memstash=MemstashConfig(policy="stash", per_layer=(("c1", "remat"),)))
    assert ctx.stash_policy("c1", 4096) == "remat"
    assert ctx.stash_policy("c2", 4096) == "stash"
    assert ctx.stash_policy("c2", 8) == "none"
    assert TContext().stash_policy("c1", 4096) == "none"


# -- the train step ---------------------------------------------------------------------


@pytest.mark.parametrize("mode,kind,warmup,microbatch", [
    ("quant_sparse", "adamw", 2, None), ("quant", "sgdm", 0, 2), ("quant", "adamw", 10, 2)])
def test_three_train_steps_match_the_reference(mode, kind, warmup, microbatch):
    jview = jget_arch(ARCH).view(reduced=True)
    tview = tget_arch(ARCH).view(reduced=True)
    jstep = jtrain.StepConfig(
        spring=dataclasses.replace(jops.MODES[mode], stochastic=False), microbatch=microbatch,
        optimizer=jopt.OptimizerConfig(kind=kind, lr=3e-3, warmup_steps=warmup))
    tstep = ttrain.StepConfig(
        spring=dataclasses.replace(tops.MODES[mode], stochastic=False), microbatch=microbatch,
        optimizer=topt.OptimizerConfig(kind=kind, lr=3e-3, warmup_steps=warmup))
    jstate = jtrain.init_train_state(jax.random.PRNGKey(0), jview, jstep)
    tstate = train_state_from_jax(
        *(jax.tree_util.tree_map(np.asarray, x) for x in
          (jstate.params, jstate.opt_state, jstate.step, jstate.rng)), tview.config)
    jfn = jax.jit(jtrain.make_train_step(jview, jstep))
    tfn = ttrain.make_train_step(tview, tstep)
    stream = JStream(JDataConfig(seed=3, vocab=tview.config.vocab, seq_len=24, global_batch=4))
    for step in range(3):
        tokens = np.array(stream.batch(step))
        jstate, jm = jfn(jstate, {"tokens": jnp.asarray(tokens)})
        tstate, tm = tfn(tstate, {"tokens": torch.from_numpy(tokens).long()})
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert tm["lr"] == float(jm["lr"])
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    assert tstate.step == 3 and tstate.opt_state.step == 3

    def port_layout(tree):
        return tree_leaves(params_from_jax(jax.tree_util.tree_map(np.asarray, tree),
                                           tview.config))

    for got, w in zip(tree_leaves(tstate.opt_state.m), port_layout(jstate.opt_state.m)):
        assert_grads_close(got, w)
    if kind == "sgdm":
        for got, w in zip(tree_leaves(tstate.params), port_layout(jstate.params)):
            np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind,warmup,step", [("adamw", 10, 0), ("adamw", 10, 12),
                                              ("adamw", 0, 3), ("sgdm", 4, 1)])
def test_optimizer_update_matches_the_reference(kind, warmup, step):
    """One update on the same gradients and moments: params, moments, lr
    and grad_norm as the reference computes them (the warmup schedule in
    float32).  Adam's step m/(sqrt(v)+eps) moves by up to lr where a
    gradient sits within its sum-order error of 0, so the train steps
    above hold AdamW's parameters through their losses and moments, and
    this test holds the update itself."""
    rng = np.random.default_rng(step)
    shapes = {"a": (5, 7), "b": (3,), "c": (2, 4, 4)}
    p, g, m = ({k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
               for _ in range(3))
    v = {k: np.abs(rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
    jcfg = jopt.OptimizerConfig(kind=kind, lr=3e-3, warmup_steps=warmup, weight_decay=0.1)
    tcfg = topt.OptimizerConfig(kind=kind, lr=3e-3, warmup_steps=warmup, weight_decay=0.1)
    jstate = jopt.OptState(jnp.asarray(step, jnp.int32), m, v if kind == "adamw" else
                           {k: np.zeros((), np.float32) for k in shapes})
    jnew, jopt_state, jm = jopt.make_optimizer(jcfg)[1](g, jstate, p)

    def t(tree):
        return {k: torch.from_numpy(np.array(a)) for k, a in tree.items()}

    tstate = topt.OptState(step, t(m), t(jstate.v))
    tnew, topt_state, tm = topt.make_optimizer(tcfg)[1](t(g), tstate, t(p))
    assert tm["lr"] == float(jm["lr"]) and topt_state.step == step + 1
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
    for k in shapes:
        for got, want in ((tnew[k], jnew[k]), (topt_state.m[k], jopt_state.m[k]),
                          (topt_state.v[k], jopt_state.v[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_train_step_refuses_the_mesh_and_its_exchange():
    """The mesh's seams are taken (``dist/`` is ported): ``grad_sync`` runs
    once a step between the backward pass and the optimizer, on the
    gradient tree; ``compress_pod_grads`` is refused, as the reference
    refuses it, without a mesh that has a pod axis."""
    view = tget_arch(ARCH).view(reduced=True)
    with pytest.raises(AssertionError, match="pod axis"):
        ttrain.make_train_step(view, ttrain.StepConfig(compress_pod_grads=True))
    seen = []

    def grad_sync(grads):
        seen.append(len(tree_leaves(grads)))
        return grads

    state = ttrain.init_train_state(view, ttrain.StepConfig(), 0, device="cpu")
    step = ttrain.make_train_step(view, ttrain.StepConfig(), grad_sync=grad_sync)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, view.config.vocab, (2, 9)))
    state, _ = step(state, {"tokens": tokens})
    assert seen == [len(tree_leaves(state.params))] and state.ef is None


def test_sr_fixed_point_step_keeps_every_parameter_on_the_grid():
    """quant_sparse with SR (the example spec's numerics): one step, every
    parameter a Q4.16 grid point afterwards."""
    from repro_torch.launch.train import on_grid

    spec = tbuild("train", spec_file=EXAMPLE, sets=["train.ckpt_dir=", "train.steps=1"],
                  use_env=False)
    out = TrainSession(spec, device="cpu").run()
    assert np.isfinite(out["losses"]).all()
    assert on_grid(dict(enumerate(tree_leaves(out["state"].params))))


# -- checkpoints (the reference's tests/test_substrates.py:101-150) ----------------------


def _tree():
    return {"params": {"w": np.arange(6.0, dtype=np.float32).reshape(2, 3)},
            "opt": (np.ones(3, np.float32), np.zeros((), np.float32)),
            "step": np.asarray(7, np.int32)}


def _equal_flat(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


def test_checkpoint_roundtrip_names_and_values_cross_packages(tmp_path):
    want = jckpt._tree_to_flat(_tree())
    assert sorted(tckpt.tree_to_flat(_tree())) == sorted(want)
    tckpt.save_checkpoint(str(tmp_path / "t"), 7, _tree(), {"note": "x"})
    step, got = tckpt.load_checkpoint(str(tmp_path / "t"))
    assert step == 7
    _equal_flat(got, want)
    jckpt.save_checkpoint(str(tmp_path / "j"), 7, jax.tree_util.tree_map(jnp.asarray, _tree()))
    step, got = tckpt.load_checkpoint(str(tmp_path / "j"))
    assert step == 7
    _equal_flat(got, want)


def test_checkpoint_keep_k_and_latest(tmp_path):
    m = tckpt.CheckpointManager(str(tmp_path), keep=2, every_steps=1)
    for s in range(1, 6):
        m.maybe_save(s, _tree())
    assert m.latest_step() == 5
    assert m.maybe_save(7, _tree) is not None  # a callable is called only to save
    assert tckpt.CheckpointManager(str(tmp_path), every_steps=2).maybe_save(9, None) is None
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert kept == ["step_00000005", "step_00000007"]


def test_checkpoint_corruption_detected(tmp_path):
    tckpt.save_checkpoint(str(tmp_path), 1, _tree())
    path = os.path.join(str(tmp_path), "step_00000001", "arrays.npz")
    with open(path, "r+b") as f:
        f.seek(150)
        f.write(b"\xde\xad")
    with pytest.raises(IOError):
        tckpt.load_checkpoint(str(tmp_path), 1)


def test_checkpoint_torn_write_skipped(tmp_path):
    tckpt.save_checkpoint(str(tmp_path), 1, _tree())
    os.makedirs(os.path.join(str(tmp_path), "tmp.step_00000009"))
    step, _ = tckpt.load_checkpoint(str(tmp_path))
    assert step == 1
    assert tckpt.CheckpointManager(str(tmp_path / "none")).restore_or_none() is None


#: a small train spec: nearest rounding and fp32 master weights, so the
#: two packages compute the same steps
PARITY_SETS = ["shape.batch=4", "shape.seq=32", "numerics.mode=quant_sparse",
               "numerics.stochastic=off", "optimizer.warmup_steps=3"]


def test_a_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference's TrainSession trains 4 steps, checkpointing every 2;
    the port's, from the reference's initial parameters, gives the same 4
    losses.  With the step-4 checkpoint removed, the port's TrainSession
    resumes from step 2 and gives the reference's losses of steps 2 and 3;
    its own step-4 checkpoint has the reference's names, shapes and
    dtypes."""
    ckpt = str(tmp_path / "ck")
    sets = PARITY_SETS + ["train.steps=4", "train.ckpt_every=2", f"train.ckpt_dir={ckpt}"]
    jspec = jbuild("train", sets=sets, use_env=False)
    jout = JTrainSession(jspec).run()
    cfg = tget_arch(ARCH).resolve(reduced=True)
    jp = jlm.lm_init(jax.random.PRNGKey(0), jspec.resolve().config)
    fresh = TrainSession(tbuild("train", sets=PARITY_SETS + ["train.steps=4"], use_env=False),
                         device="cpu", params=params_from_jax(jp, cfg)).run()
    np.testing.assert_allclose(fresh["losses"], jout["losses"], rtol=1e-5)
    _, jflat = jckpt.load_checkpoint(ckpt, 4)
    want = {k: np.asarray(v) for k, v in jckpt._tree_to_flat(jflat).items()}
    shutil.rmtree(os.path.join(ckpt, "step_00000004"))
    tout = TrainSession(tbuild("train", sets=sets, use_env=False), device="cpu").run()
    assert len(tout["losses"]) == 2
    np.testing.assert_allclose(tout["losses"], jout["losses"][2:], rtol=1e-5)
    step, got = tckpt.load_checkpoint(ckpt)
    assert step == 4
    assert sorted(got) == sorted(want)
    for k in want:
        assert (got[k].shape, got[k].dtype) == (want[k].shape, want[k].dtype), k
    np.testing.assert_array_equal(got["3"], want["3"])
    assert int(got["1/.step"]) == int(want["1/.step"]) == 4


# -- the session and the launcher --------------------------------------------------------


def test_train_loop_loss_decreases():
    """The reference's loss bound (tests/test_system.py:19-23), on the CPU.
    Its watchdog bound (at most 2 slow steps) is not held here: an eager
    step on a CPU shared with other test workers takes twice its average
    often enough to trip the watchdog; the count is reported."""
    res = tlaunch.train_loop(ARCH, reduced=True, steps=40, batch=8, seq=64, device="cpu")
    assert res["last_loss"] < res["first_loss"] - 0.5
    assert 0 <= res["slow_steps"] < 40


def test_checkpoint_resume_is_exact(tmp_path):
    """20 steps with checkpoints, then a resume to 30, against 30 straight
    (tests/test_system.py:26-35): equal losses, equal parameters."""
    kw = dict(reduced=True, batch=4, seq=32, mode="quant_sparse", fixed_point_weights=True,
              device="cpu")
    a = tlaunch.train_loop(ARCH, steps=30, **kw)
    tlaunch.train_loop(ARCH, steps=20, ckpt_dir=str(tmp_path), ckpt_every=10, **kw)
    b = tlaunch.train_loop(ARCH, steps=30, ckpt_dir=str(tmp_path), ckpt_every=10, **kw)
    assert b["losses"] == a["losses"][20:]
    for x, y in zip(tree_leaves(a["state"].params), tree_leaves(b["state"].params)):
        assert torch.equal(x, y)


def test_launcher_trains_the_example_spec_on_the_cpu(capsys, monkeypatch, tmp_path):
    out_json = tmp_path / "r.json"
    out = tlaunch.main(["--spec", EXAMPLE, "--set", "train.ckpt_dir=", "--set",
                        "train.steps=2", "--device", "cpu", "--json", str(out_json)])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == (f"loss {out['first_loss']:.4f} -> {out['last_loss']:.4f} "
                    f"(2 steps, slow={out['slow_steps']}) [spec {out['spec_hash']}]")
    assert "state" not in out_json.read_text() and '"losses"' in out_json.read_text()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--spec", EXAMPLE, "--set", "train.ckpt_dir="])


def test_launcher_legacy_flags_and_options_are_the_references():
    from repro.launch import train as jlaunch

    from repro_torch.api import cli as tcli
    from repro_torch.api.spec import field_paths

    def table(flags):
        return [(f.option, f.path, f.const, f.dest, dict(f.kwargs).get("type") is not None,
                 dict(f.kwargs).get("choices")) for f in flags]

    assert table(tlaunch.LEGACY_FLAGS) == table(jlaunch.LEGACY_FLAGS)
    legacy = {lf.option for lf in tlaunch.LEGACY_FLAGS}
    assert all(lf.path in field_paths() for lf in tlaunch.LEGACY_FLAGS)
    for action in tlaunch.build_parser()._actions:
        for opt in action.option_strings:
            if opt.startswith("--"):
                assert opt in tcli.OPERATIONAL_OPTIONS or opt in legacy, opt
    argv = ["--arch", ARCH, "--steps", "3", "--stash", "stash", "--mode", "quant",
            "--fixed-point-weights", "--set", "shape.seq=16"]
    specs = []
    for mod in (jlaunch, tlaunch):
        with pytest.warns(DeprecationWarning):
            specs.append(mod.run_main("train", mod.build_parser().parse_args(argv),
                                      mod.LEGACY_FLAGS))
    assert specs[1].to_json() == specs[0].to_json()
    assert specs[1].describe() == specs[0].describe()
