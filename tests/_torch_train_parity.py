"""Shared checks of the train-parity files (``test_torch_train_moe.py``,
``test_torch_train_ssm.py``, ``test_torch_train_branches.py``): the port's
LM training against the reference's on the CPU, at an arch's reduced
config, from the reference's ``lm_init`` parameters carried across by
``convert.params_from_jax`` and tokens drawn from a seed with numpy.

The reference runs under ``jax.jit``, as its train step does (XLA keeps
excess precision in the dense mode, and the port follows the jitted
program).  Tolerances, and why:

  fine      quant_sparse with nearest rounding on the Q16.60 grid, where
            rounding is the identity in both packages: loss rel 1e-5, every
            gradient within DESIGN.md §8's contract, rtol 1e-5 with an
            absolute floor of 1e-5 x (max|grad| + 1) (fp32 sums in
            another order).
  q4.16     quant_sparse with nearest rounding on the default Q4.16 grid:
            an fp32 sum that lands within its last bit of a rounding tie
            rounds one grid step (2**-16) apart in the two packages, and
            the step propagates into the gradients.  The loss holds rel
            1e-5; each arch's gradients hold the contract's form with the
            bound its test file states beside the measured worst case.
  dense     bf16 activations rounded at other places: loss and gradients
            within each file's stated bounds (the llama contract of
            ``test_torch_lm_train.py``, 1e-4 and 5e-2 x max|grad|, where it
            holds).
  exact     a remat / stash recompute against no remat (the same ops on
            the same bits).

Model-level SR draws from ``torch.Generator`` seeds, not threefry, so every
case runs ``stochastic=False``.
"""

from __future__ import annotations

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import build_spec as jbuild
from repro.api.sessions import TrainSession as JTrainSession
from repro.checkpoint import manager as jckpt
from repro.configs import get_arch as jget_arch
from repro.core import spring_ops as jops
from repro.core.fixedpoint import FixedPointFormat as JFormat
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticLMStream as JStream
from repro.memstash.config import MemstashConfig as JMemstash
from repro.models import lm as jlm
from repro.models.layers import SpringContext as JContext
from repro.optim import optimizers as jopt
from repro.runtime import train as jtrain

from repro_torch.api import build_spec as tbuild
from repro_torch.api.sessions import TrainSession
from repro_torch.checkpoint import manager as tckpt
from repro_torch.configs import get_arch as tget_arch
from repro_torch.convert import params_from_jax, train_state_from_jax
from repro_torch.core import spring_ops as tops
from repro_torch.core.fixedpoint import FixedPointFormat as TFormat
from repro_torch.memstash.config import MemstashConfig
from repro_torch.memstash.instrument import record_stash_traffic
from repro_torch.models import lm as tlm
from repro_torch.models.layers import SpringContext as TContext
from repro_torch.optim import optimizers as topt
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.runtime import train as ttrain

#: Q16.60: nearest rounding on this grid leaves every value above 2**-36
#: unchanged in fp32, in both packages
FINE = (16, 60)


def springs(mode: str) -> tuple:
    """The reference's and the port's SpringConfig of ``mode`` ("dense",
    "quant_sparse", or "fine": quant_sparse on :data:`FINE`), nearest
    rounding."""
    j = dataclasses.replace(jops.MODES["quant_sparse" if mode == "fine" else mode],
                            stochastic=False)
    t = dataclasses.replace(tops.MODES["quant_sparse" if mode == "fine" else mode],
                            stochastic=False)
    if mode == "fine":
        j = dataclasses.replace(j, fmt=JFormat(il=FINE[0], fl=FINE[1]))
        t = dataclasses.replace(t, fmt=TFormat(il=FINE[0], fl=FINE[1]))
    return j, t


def model(arch: str) -> tuple:
    """The reference's reduced config and ``lm_init`` parameters (numpy),
    the port's config and its copy of them, and a (2, 33) token batch."""
    jcfg, tcfg = jget_arch(arch).reduced(), tget_arch(arch).resolve(reduced=True)
    jp = jax.tree_util.tree_map(np.asarray, jlm.lm_init(jax.random.PRNGKey(0), jcfg))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 33)).astype(np.int32)
    return jcfg, tcfg, jp, params_from_jax(jp, tcfg), tokens


def ref_loss_and_grads(jp, jcfg, tokens, spring, memstash=None) -> tuple:
    """(loss, aux, grads as numpy) of the reference's jitted lm_loss."""
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jcfg, jnp.asarray(tokens),
                              JContext(cfg=spring, memstash=memstash)),
        has_aux=True))(jp)
    return float(loss), float(metrics["aux"]), jax.tree_util.tree_map(np.asarray, grads)


def port_loss_and_grads(tp, tcfg, tokens, spring, memstash=None) -> tuple:
    """(loss, aux, gradient list in ``tree_leaves`` order) of the port's."""
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), tp)
    loss, metrics = tlm.lm_loss(p, tcfg, torch.from_numpy(tokens).long(),
                                TContext(cfg=spring, memstash=memstash, attention="chunked"))
    grads = torch.autograd.grad(loss, tree_leaves(p))
    return float(loss.detach()), float(metrics["aux"].detach()), grads


def assert_grads_close(got, want, rtol=1e-5) -> None:
    """The contract's form: |got - want| <= rtol (|want| + max|want| + 1)."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * (float(np.max(np.abs(want))) + 1.0))


def check_loss_and_grads(arch: str, mode: str, loss_rel: float, grad_rtol: float) -> None:
    """lm_loss, its aux and every gradient of the reduced ``arch`` against
    the reference's, in ``mode``.  Dense gradients are held within 5e-2 x
    max|grad|, the others by :func:`assert_grads_close` at ``grad_rtol``."""
    jcfg, tcfg, jp, tp, tokens = model(arch)
    js, ts = springs(mode)
    want, want_aux, jgrads = ref_loss_and_grads(jp, jcfg, tokens, js)
    got, aux, grads = port_loss_and_grads(tp, tcfg, tokens, ts)
    want_grads = tree_leaves(params_from_jax(jgrads, tcfg))
    assert len(grads) == len(want_grads) == len(tree_leaves(tp))
    assert got == pytest.approx(want, rel=loss_rel)
    assert aux == pytest.approx(want_aux, rel=loss_rel, abs=1e-7)
    for g, w in zip(grads, want_grads):
        if mode == "dense":
            w = w.numpy()
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=5e-2 * float(np.abs(w).max()))
        else:
            assert_grads_close(g, w, grad_rtol)


def check_remat_policy(arch: str, policy: str) -> None:
    """``policy`` recomputes the same ops on the same bits as no remat
    (nearest rounding; the stash restores its input exactly): loss, aux and
    every gradient equal; only "stash" records the ``lm/residual`` point."""
    _, tcfg, _, tp, tokens = model(arch)
    _, ts = springs("quant_sparse")
    plain = port_loss_and_grads(tp, dataclasses.replace(tcfg, remat=False), tokens, ts)
    with record_stash_traffic() as rows:
        got = port_loss_and_grads(tp, dataclasses.replace(tcfg, remat=True, remat_policy=policy),
                                  tokens, ts, memstash=MemstashConfig(policy="stash"))
    assert got[:2] == plain[:2]
    for a, b in zip(got[2], plain[2]):
        assert torch.equal(a, b)
    assert bool([r for r in rows if r["layer"] == "lm/residual"]) == (policy == "stash")


def check_stash_against_reference(arch: str) -> None:
    """The stashed unit (``remat_policy="stash"``, the MemstashConfig's
    stash) against the reference's stash path: loss, aux and every
    gradient, on the fine grid."""
    jcfg, tcfg, jp, tp, tokens = model(arch)
    js, ts = springs("fine")
    stash = dict(remat=True, remat_policy="stash")
    want, want_aux, jgrads = ref_loss_and_grads(
        jp, dataclasses.replace(jcfg, **stash), tokens, js, JMemstash(policy="stash"))
    got, aux, grads = port_loss_and_grads(tp, dataclasses.replace(tcfg, **stash), tokens, ts,
                                          MemstashConfig(policy="stash"))
    assert got == pytest.approx(want, rel=1e-5)
    assert aux == pytest.approx(want_aux, rel=1e-5, abs=1e-7)
    for g, w in zip(grads, tree_leaves(params_from_jax(jgrads, tcfg))):
        assert_grads_close(g, w)


def check_three_train_steps(arch: str, kind: str) -> None:
    """Three steps of the reference's ``make_train_step`` and the port's
    from one state, on the fine grid: losses rel 1e-5, lr exact, grad_norm rel 1e-4,
    the first moments within the gradient contract; SGDm's parameters
    within 1e-5 (an Adam step jumps by up to lr where a gradient is
    within its sum-order error of 0, so AdamW's parameters are held
    through the losses and moments, as in ``test_torch_lm_train.py``)."""
    jview, tview = jget_arch(arch).view(reduced=True), tget_arch(arch).view(reduced=True)
    js, ts = springs("fine")
    jstep = jtrain.StepConfig(spring=js, optimizer=jopt.OptimizerConfig(
        kind=kind, lr=3e-3, warmup_steps=2))
    tstep = ttrain.StepConfig(spring=ts, optimizer=topt.OptimizerConfig(
        kind=kind, lr=3e-3, warmup_steps=2))
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
        assert float(tm["aux"]) == pytest.approx(float(jm["aux"]), rel=1e-5, abs=1e-7)
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


#: a small train spec: nearest rounding and fp32 master weights, so the
#: two packages compute the same steps
PARITY_SETS = ["shape.batch=4", "shape.seq=32", "numerics.mode=quant_sparse",
               "numerics.stochastic=off", "optimizer.warmup_steps=3"]


def session_losses(arch: str) -> None:
    """The reference's TrainSession and the port's, from the reference's
    initial parameters, give the same three losses (rel 1e-5).  SGDm: on the Q4.16
    grid AdamW's normalised step turns a grid flip in a gradient near 0
    into a jump of up to lr (the third loss of deepseek-v2-lite-16b moved
    rel 2.5e-4 under AdamW), where SGDm's step moves with the gradient;
    AdamW is held on the fine grid by :func:`check_three_train_steps`."""
    sets = PARITY_SETS + [f"arch.id={arch}", "train.steps=3", "train.ckpt_dir=",
                          "optimizer.kind=sgdm"]
    jspec = jbuild("train", sets=sets, use_env=False)
    jout = JTrainSession(jspec).run()
    cfg = tget_arch(arch).resolve(reduced=True)
    jp = jlm.lm_init(jax.random.PRNGKey(0), jspec.resolve().config)
    tout = TrainSession(tbuild("train", sets=sets, use_env=False), device="cpu",
                        params=params_from_jax(jp, cfg)).run()
    assert len(tout["losses"]) == 3
    np.testing.assert_allclose(tout["losses"], jout["losses"], rtol=1e-5)


def check_reference_checkpoint_resumes(arch: str, tmp_path) -> None:
    """The reference's TrainSession trains 4 steps of ``arch``,
    checkpointing every 2; the port's, from the reference's initial
    parameters, gives the same 4 losses.  With the step-4 checkpoint
    removed, the port's TrainSession resumes from step 2 with the
    reference's losses of steps 2 and 3, and its own step-4 checkpoint has
    the reference's names, shapes and dtypes."""
    ckpt = str(tmp_path / "ck")
    arch_set = [f"arch.id={arch}"]
    sets = PARITY_SETS + arch_set + ["train.steps=4", "train.ckpt_every=2",
                                     f"train.ckpt_dir={ckpt}"]
    jspec = jbuild("train", sets=sets, use_env=False)
    jout = JTrainSession(jspec).run()
    cfg = tget_arch(arch).resolve(reduced=True)
    jp = jlm.lm_init(jax.random.PRNGKey(0), jspec.resolve().config)
    fresh = TrainSession(tbuild("train", sets=PARITY_SETS + arch_set + ["train.steps=4"],
                                use_env=False),
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
