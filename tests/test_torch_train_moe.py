"""Port parity, MoE training: olmoe-1b-7b and deepseek-v2-lite-16b
(``models/moe.py`` under autograd, MLA's full-sequence form, the stashed
unit's aux loss) trained by ``repro_torch`` against ``repro`` on the CPU,
at the reduced configs.

Tolerances (``tests/_torch_train_parity.py`` says why each is what it is):

  * fine (quant_sparse on Q16.60): loss and aux rel 1e-5, every gradient
    within DESIGN.md §8's contract (rtol 1e-5, floor 1e-5 x (max + 1));
  * q4.16 (quant_sparse on the default grid, nearest rounding): loss rel
    1e-5; gradients in the contract's form at rtol 1e-4 (measured worst:
    1.87e-5 olmoe, 3.63e-5 deepseek: grid steps of 2**-16 that round the
    other way where an fp32 sum sits within its last bit of a tie);
  * dense: loss rel 1e-4, gradients within 5e-2 x max|grad| (measured
    8.2e-7 / 0 and 1.4e-2 / 1.5e-2);
  * ``moe_apply`` gradients (routing, drops, an expert no token reached,
    the token-chunk map, shared experts) on Q16.60 at the contract; the
    empty expert's weight gradients exactly 0 in both packages;
  * remat policies against no remat: exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_train_parity as tp  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.layers import SpringContext as JContext  # noqa: E402

from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.layers import SpringContext as TContext  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves, tree_map  # noqa: E402

OLMOE, DEEPSEEK = "olmoe-1b-7b", "deepseek-v2-lite-16b"
ARCHS = (OLMOE, DEEPSEEK)
#: gradient rtol on the Q4.16 grid (the module docstring)
Q416_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["fine", "quant_sparse", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_lm_loss_aux_and_every_gradient_match_the_reference(arch, mode):
    tp.check_loss_and_grads(arch, mode, loss_rel=1e-4 if mode == "dense" else 1e-5,
                            grad_rtol=Q416_RTOL if mode == "quant_sparse" else 1e-5)


#: moe_apply cases: the reference's 8 experts top-2 with drops (capacity
#: factor 0.5), the token-chunk map (MOE_TOKEN_CHUNK 8 in both packages:
#: 2 x 16 tokens in 4 chunks), and deepseek's shared experts
MOE_GRAD_CASES = {
    "drops": (dict(n_experts=8, top_k=2, d_ff=32, capacity_factor=0.5), 16, (2, 24, 16), None),
    "chunks": (dict(n_experts=8, top_k=2, d_ff=32), 16, (2, 16, 16), 8),
    "shared": (dict(n_experts=8, top_k=2, d_ff=48, n_shared=2, shared_d_ff=48,
                    capacity_factor=1.0), 64, (1, 20, 64), None),
}


@pytest.mark.parametrize("case", list(MOE_GRAD_CASES))
def test_moe_apply_gradients_match_the_reference(case, monkeypatch):
    """d/d(params, x) of sum(y * g) + 0.01 aux through both packages'
    ``moe_apply`` (quant_sparse on Q16.60, nearest): through the router
    (gates and the Switch aux loss), the dispatch, the experts and the
    combine.  Expert 7's router column is pushed away from every token, so
    it receives no token: its weight gradients are exactly 0 in both."""
    kw, d, shape, chunk = MOE_GRAD_CASES[case]
    if chunk is not None:
        monkeypatch.setattr(jmoe, "MOE_TOKEN_CHUNK", chunk)
        monkeypatch.setattr(tmoe, "MOE_TOKEN_CHUNK", chunk)
    jspec, tspec = jmoe.MoESpec(**kw), tmoe.MoESpec(**kw)
    jp = jax.tree_util.tree_map(np.array, jmoe.moe_init(jax.random.PRNGKey(4), d, jspec))
    jp["router"]["kernel"][0, 7] = -10.0
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape).astype(np.float32)
    x[..., 0] = np.abs(x[..., 0]) + 3.0
    g = rng.standard_normal(shape).astype(np.float32)
    js, ts = tp.springs("fine")

    def jloss(p, v):
        y, aux = jmoe.moe_apply(p, v, JContext(cfg=js), jspec)
        return jnp.sum(y * g) + 0.01 * aux

    jgp, jgx = jax.jit(jax.grad(jloss, (0, 1)))(jp, jnp.asarray(x))
    params = tree_map(lambda a: torch.from_numpy(np.array(a)).requires_grad_(True), jp)
    tx = torch.from_numpy(x).requires_grad_(True)
    with tmoe.record_routing() as rec:
        y, aux = tmoe.moe_apply(params, tx, TContext(cfg=ts), tspec)
    ((y * torch.from_numpy(g)).sum() + 0.01 * aux).backward()
    tp.assert_grads_close(tx.grad, jgx)
    for got, want in zip(tree_leaves(params), tree_leaves(tree_map(np.asarray, jgp))):
        tp.assert_grads_close(got.grad, want)
    assert not any(bool((r["gate_idx"] == 7).any()) for r in rec)
    if chunk is not None:
        assert [r["tokens"] for r in rec] == [chunk] * 4
    if case == "drops":
        assert not bool(rec[0]["keep"].all())
    for name in ("w_gate", "w_up", "w_down"):
        assert not params[name].grad[7].any() and not np.asarray(jgp[name][7]).any()
        assert params[name].grad[:7].abs().sum() > 0


@pytest.mark.parametrize("policy", ["full", "block_io", "stash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_remat_policies_equal_no_remat(arch, policy):
    tp.check_remat_policy(arch, policy)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_stashed_unit_matches_the_reference(arch):
    """``arch.remat_policy=stash``: the stashed unit returns its MoE aux
    loss, whose gradient reaches the routers through the recompute."""
    tp.check_stash_against_reference(arch)


@pytest.mark.parametrize("kind", ["adamw", "sgdm"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_three_train_steps_match_the_reference(arch, kind):
    tp.check_three_train_steps(arch, kind)


def test_a_reference_checkpoint_of_olmoe_resumes_in_the_port(tmp_path):
    tp.check_reference_checkpoint_resumes(OLMOE, tmp_path)


def test_moe_step_config_trains_through_make_train_step_with_microbatches():
    """``microbatch=2`` splits the batch into two halves, each with its own
    routing; the accumulated loss is their mean, as in the reference."""
    tview = tp.tget_arch(OLMOE).view(reduced=True)
    _, ts = tp.springs("fine")
    step_cfg = tp.ttrain.StepConfig(spring=ts, microbatch=2)
    state = tp.ttrain.init_train_state(tview, step_cfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, tview.config.vocab, (4, 17))).long()
    whole = [tp.tlm.lm_loss(state.params, tview.config, tokens[i:i + 2],
                            TContext(cfg=ts, attention="chunked"))[0] for i in (0, 2)]
    _, metrics = tp.ttrain.make_train_step(tview, step_cfg)(state, {"tokens": tokens})
    assert float(metrics["loss"]) == pytest.approx(float(sum(whole) / 2), rel=1e-6)
