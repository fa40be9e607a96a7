"""Port parity, the train step's other inputs and the train session:
whisper-medium with ``frames`` and internvl2-26b with ``img_embeds``
through ``runtime.train.make_train_step`` (the reference's ``_loss_for``
branches), and the TrainSession of olmoe-1b-7b, deepseek-v2-lite-16b,
mamba2-780m and recurrentgemma-9b, ``repro_torch`` against ``repro`` on the
CPU at the reduced configs.

Tolerances (``tests/_torch_train_parity.py`` says why):

  * one AdamW step on the fine grid (quant_sparse on Q16.60, nearest),
    with and without ``microbatch=2`` (every leaf of the batch split along
    its first axis): loss rel 1e-5, grad_norm rel 1e-4, lr exact, the
    first moments within DESIGN.md §8's gradient contract;
  * the sessions (``numerics.stochastic=off`` on the spec's Q4.16 grid,
    SGDm with warmup; ``session_losses`` says why not AdamW): three losses
    rel 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_train_parity as tp  # noqa: E402
from repro.checkpoint import manager as jckpt  # noqa: E402

from repro_torch.api import threefry  # noqa: E402
from repro_torch.checkpoint.manager import tree_to_flat  # noqa: E402
from repro_torch.convert import encdec_params_from_jax  # noqa: E402
from repro_torch.optim.optimizers import OptState, tree_leaves  # noqa: E402

WHISPER, VLM = "whisper-medium", "internvl2-26b"


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _states(jview, tview, jstep):
    """The reference's fresh train state and the port's copy of it."""
    jstate = tp.jtrain.init_train_state(jax.random.PRNGKey(0), jview, jstep)
    if not jview.is_encdec:
        return jstate, tp.train_state_from_jax(
            *(jax.tree_util.tree_map(np.asarray, x) for x in
              (jstate.params, jstate.opt_state, jstate.step, jstate.rng)), tview.config)
    params, m, v = (encdec_params_from_jax(jax.tree_util.tree_map(np.asarray, t)) for t in
                    (jstate.params, jstate.opt_state.m, jstate.opt_state.v))
    return jstate, tp.ttrain.TrainState(params, OptState(0, m, v), 0, 0)


@pytest.mark.parametrize("microbatch", [None, 2])
@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_a_step_with_frames_or_img_embeds_matches_the_reference(arch, microbatch):
    """whisper's batch carries (B, S_enc, d) ``frames``, internvl2's (B, P,
    d) ``img_embeds`` (bf16 from threefry, the same bits in both); one
    AdamW step of each package's ``make_train_step`` from one state.  For
    the encoder-decoder the port's own ``init_train_state`` builds
    ``encdec_init``'s parameter names and shapes."""
    jview, tview = tp.jget_arch(arch).view(reduced=True), tp.tget_arch(arch).view(reduced=True)
    cfg = tview.config
    js, ts = tp.springs("fine")
    opt = dict(kind="adamw", lr=3e-3, warmup_steps=2)
    jstep = tp.jtrain.StepConfig(spring=js, microbatch=microbatch,
                                 optimizer=tp.jopt.OptimizerConfig(**opt))
    tstep = tp.ttrain.StepConfig(spring=ts, microbatch=microbatch,
                                 optimizer=tp.topt.OptimizerConfig(**opt))
    jstate, tstate = _states(jview, tview, jstep)
    if tview.is_encdec:
        fresh = tp.ttrain.init_train_state(tview, tstep, 0, device="cpu")
        want = jckpt._tree_to_flat(jax.tree_util.tree_map(np.asarray, jstate.params))
        assert {k: tuple(v.shape) for k, v in tree_to_flat(fresh.params).items()} == \
            {k: tuple(np.shape(v)) for k, v in want.items()}

    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (4, 17)).astype(np.int32)
    name, rows = ("frames", cfg.enc_seq) if tview.is_encdec else ("img_embeds",
                                                                   cfg.vlm_prefix_len)
    extra = threefry.normal_bf16(threefry.prng_key(7), (4, rows, cfg.d_model))
    jbatch = {"tokens": jnp.asarray(tokens), name: jnp.asarray(extra.float().numpy(),
                                                                jnp.bfloat16)}
    tbatch = {"tokens": torch.from_numpy(tokens).long(), name: extra}
    jstate, jm = jax.jit(tp.jtrain.make_train_step(jview, jstep))(jstate, jbatch)
    tstate, tm = tp.ttrain.make_train_step(tview, tstep)(tstate, tbatch)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["ce"]) == pytest.approx(float(jm["ce"]), rel=1e-5)
    assert tm["lr"] == float(jm["lr"])
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    want_m = jax.tree_util.tree_map(np.asarray, jstate.opt_state.m)
    want_m = (tree_leaves(encdec_params_from_jax(want_m)) if tview.is_encdec
              else tree_leaves(tp.params_from_jax(want_m, cfg)))
    got_m = tree_leaves(tstate.opt_state.m)
    assert len(got_m) == len(want_m)
    for g, w in zip(got_m, want_m):
        tp.assert_grads_close(g, w)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "deepseek-v2-lite-16b", "mamba2-780m",
                                  "recurrentgemma-9b"])
def test_train_session_losses_equal_the_references(arch):
    """A train spec with ``arch.id`` set resolves, and its TrainSession
    trains three steps with the reference session's losses."""
    tp.session_losses(arch)


@pytest.mark.parametrize("kind", ["adamw", "sgdm"])
def test_the_lm_step_writes_its_update_into_the_donated_state(kind):
    """``make_train_step`` donates its state, as the reference's jitted
    step does: the returned parameters and moments are the input's tensors,
    and they hold the bits of the functional update (``make_optimizer``'s)
    applied to the same gradients, Q4.16 SR weights included."""
    from repro_torch.core.fixedpoint import SPRING_FORMAT

    view = tp.tget_arch("mamba2-780m").view(reduced=True)
    _, ts = tp.springs("quant_sparse")
    opt = tp.topt.OptimizerConfig(kind=kind, lr=3e-3, warmup_steps=2,
                                  weight_format=SPRING_FORMAT)
    step_cfg = tp.ttrain.StepConfig(spring=ts, optimizer=opt)
    state = tp.ttrain.init_train_state(view, step_cfg, 0, device="cpu")
    params0 = tp.tree_map(torch.clone, state.params)
    opt0 = OptState(0, tp.tree_map(torch.clone, state.opt_state.m),
                    tp.tree_map(torch.clone, state.opt_state.v))
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, view.config.vocab, (2, 17))).long()
    p = tp.tree_map(lambda t: t.clone().requires_grad_(True), params0)
    loss, _ = tp.tlm.lm_loss(p, view.config, tokens, tp.TContext(cfg=ts, attention="chunked"))
    leaves = iter(torch.autograd.grad(loss, tree_leaves(p)))
    grads = tp.tree_map(lambda _: next(leaves), params0)
    ids = [id(t) for t in tree_leaves(state.params) + tree_leaves(state.opt_state.m)]
    new, _ = tp.ttrain.make_train_step(view, step_cfg)(state, {"tokens": tokens})
    assert [id(t) for t in tree_leaves(new.params) + tree_leaves(new.opt_state.m)] == ids
    seed = tp.ttrain.fold_in(tp.ttrain.fold_in(0, 0), tp.ttrain.OPT_SEED_FOLD)
    want_p, want_opt, _ = tp.topt.make_optimizer(opt)[1](grads, opt0, params0, seed)
    for got, want in zip(tree_leaves(new.params) + tree_leaves(new.opt_state.m),
                         tree_leaves(want_p) + tree_leaves(want_opt.m)):
        assert torch.equal(got, want)
