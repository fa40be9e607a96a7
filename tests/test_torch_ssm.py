"""Port parity for the SSD scan and Mamba-2 serving: ``repro_torch``
against ``repro``, on the CPU.

The reference's Pallas kernel runs in interpret mode; the port's wrapper
runs its chunked plain version for CPU tensors.  Scan tolerance is the
reference registry's own (``ssd_scan/ops.py:126-127``): rel 1e-4, the
max-abs error over the max-abs of the reference, for y and the final state
alike (the chunked form's fp32 exponents and sums in another order).
Model-level tolerances follow ``tests/test_torch_model.py``: quantized
logits atol 1e-3, dense 2e-2; the bf16 conv and ssm cache leaves within
1 (quantized) or 8 (dense) bf16 ulps at their largest magnitude; served
greedy tokens identical.  The reference serves Mamba-2 through its default
route, which sends the prefill (``return_state=True``) to ``ssd_scan_jnp``.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.kernels.ssd_scan import ops as jssd  # noqa: E402
from repro.kernels.ssd_scan.ref import ssd_scan_reference as jssd_reference  # noqa: E402
from repro.launch.serve import serving_config as jserving_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.layers import SpringContext as JContext  # noqa: E402
from repro.optim.optimizers import OptimizerConfig  # noqa: E402
from repro.runtime.train import StepConfig  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402

from repro_torch.configs import get_arch as tget_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as tssd_ref  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import (  # noqa: E402
    ssd_scan, ssd_scan_chunked, ssd_scan_reference)
from repro_torch.launch.serve import serving_config as tserving_config  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.layers import SpringContext as TContext  # noqa: E402
from repro_torch.serving import kvpool as tkvpool  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TEngine  # noqa: E402

MODES = ("dense", "quant", "quant_sparse")
LOGIT_ATOL = {"dense": 2e-2, "quant": 1e-3, "quant_sparse": 1e-3}
CACHE_ULPS = {"dense": 8, "quant": 1, "quant_sparse": 1}
SCAN_REL = 1e-4
PROMPT, GEN = 150, 5


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / (np.abs(want).max() + 1e-12))


@functools.cache
def _ssd_examples() -> list:
    return [tuple(np.array(a) for a in args) for args, _ in jssd._examples()]


def _scan_inputs(seed, bsz, s, h, p, g, n):
    """The registry's distribution (softplus dt, a = -exp(0.5 N)), from numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bsz, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    b = (rng.standard_normal((bsz, s, g, n)) / n**0.5).astype(np.float32)
    c = (rng.standard_normal((bsz, s, g, n)) / n**0.5).astype(np.float32)
    return x, dt, a, b, c


# -- the kernel's function --------------------------------------------------------


@pytest.mark.parametrize("case", range(3))
def test_ssd_scan_plain_matches_reference_kernel(case):
    """The registry's three examples (S 320 ragged over 3 chunks with 2
    groups, one full chunk, a short ragged one) against the interpret-mode
    Pallas kernel."""
    args = _ssd_examples()[case]
    want = np.asarray(jssd.ssd_scan(*(jnp.asarray(a) for a in args), impl="interpret"))
    got = ssd_scan(*(torch.from_numpy(a) for a in args))
    assert tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) <= SCAN_REL


@pytest.mark.parametrize("case", range(4))
def test_ssd_scan_state_matches_reference_jnp_form(case):
    """y and the final (B,H,N,P) state against ``ssd_scan_jnp(return_state=
    True)``, the reference's prefill route, on the registry's examples and
    on a ragged 300-step input with 4 heads to 1 group."""
    args = _ssd_examples()[case] if case < 3 else _scan_inputs(3, 1, 300, 4, 32, 1, 16)
    jy, jstate = jssd.ssd_scan_jnp(*(jnp.asarray(a) for a in args), return_state=True)
    y, state = ssd_scan(*(torch.from_numpy(a) for a in args), return_state=True)
    assert state.dtype == torch.float32 and tuple(state.shape) == jstate.shape
    assert _rel(y.numpy(), jy) <= SCAN_REL
    assert _rel(state.numpy(), jstate) <= SCAN_REL


def test_ssd_scan_sequential_oracle_matches_reference_and_chunked_form():
    """The port's token-by-token oracle against the reference's, and the
    chunked form (y and state) against the port's oracle, whose last state
    is the recurrence run to the end."""
    x, dt, a, b, c = _scan_inputs(4, 2, 200, 4, 32, 2, 16)
    want = np.asarray(jssd_reference(*(jnp.asarray(v) for v in (x, dt, a, b, c))))
    tx, tdt, ta, tb, tc = (torch.from_numpy(v) for v in (x, dt, a, b, c))
    seq = ssd_scan_reference(tx, tdt, ta, tb, tc)
    assert _rel(seq.numpy(), want) <= 1e-5
    y, state = ssd_scan_chunked(tx, tdt, ta, tb, tc, return_state=True)
    assert _rel(y.numpy(), seq.numpy()) <= SCAN_REL
    # the final state is h at the last step: y_{S-1} = C_{S-1} h_{S-1}
    c_last = tc.repeat_interleave(2, dim=2)[:, -1]  # (B,H,N), 2 heads per group
    y_last = torch.einsum("bhn,bhnp->bhp", c_last, state)
    assert _rel(y_last.numpy(), seq[:, -1].numpy()) <= SCAN_REL


def _model_decay_inputs(seed, bsz, s, h, p, g, n):
    """The registry's x, b, c with mamba2-780m's own decays: ``ssm_init``'s
    a = -linspace(1, 16) and dt = softplus(N(0, 1)), so a chunk's
    cumulative log decay reaches about -2000."""
    x, dt, _, b, c = _scan_inputs(seed, bsz, s, h, p, g, n)
    return x, dt, -np.linspace(1.0, 16.0, h).astype(np.float32), b, c


#: the staged plain versions' cases: the registry's three examples, a
#: ragged S, G > 1 with several heads per group, and the model's decays
STAGE_CASES = {"registry0": 0, "registry1": 1, "registry2": 2,
               "ragged": (5, 1, 300, 4, 32, 1, 16), "groups": (6, 2, 200, 6, 64, 3, 16),
               "model decays": (7, 1, 260, 8, 32, 1, 32)}


def _stage_case(name):
    case = STAGE_CASES[name]
    if isinstance(case, int):
        return _ssd_examples()[case]
    if name == "model decays":
        return _model_decay_inputs(*case)
    return _scan_inputs(*case)


@pytest.mark.parametrize("name", list(STAGE_CASES))
def test_staged_plain_versions_compose_to_the_scan(name):
    """The four stages (scores once per group, chunk state and decays,
    state passing, chunk scan), composed from their plain versions, give ``ssd_scan_chunked``'s y and final state (rel 1e-6: the same fp32
    math, batched otherwise) and the interpret-mode Pallas kernel's y (rel
    1e-4, the registry's compare)."""
    args = _stage_case(name)
    x, dt, a, b, c = (torch.from_numpy(v) for v in args)
    cb = tssd_ref.ssd_chunk_scores(b, c)
    st, cum = tssd_ref.ssd_chunk_state(x, dt, a, b)
    h_prev, state = tssd_ref.ssd_state_passing(st, cum)
    y = tssd_ref.ssd_chunk_scan(x, dt, c, cb, cum, h_prev)
    nc, g = -(-x.shape[1] // 128), b.shape[2]
    assert tuple(cb.shape) == (x.shape[0], nc, g, 128, 128)
    assert not torch.triu(cb, diagonal=1).any()  # nothing above the diagonal
    assert tuple(h_prev.shape) == tuple(st.shape) == (x.shape[0], nc, x.shape[2], b.shape[3],
                                                       x.shape[3])
    assert not h_prev[:, 0].any()  # the first chunk starts from h = 0
    wy, wstate = ssd_scan_chunked(x, dt, a, b, c, return_state=True)
    assert _rel(y.numpy(), wy.numpy()) <= 1e-6
    assert _rel(state.numpy(), wstate.numpy()) <= 1e-6
    want = np.asarray(jssd.ssd_scan(*(jnp.asarray(v) for v in args), impl="interpret"))
    assert _rel(y.numpy(), want) <= SCAN_REL


def test_ssd_scan_plain_version_keeps_its_gradient():
    """On the CPU the wrapper's plain version stays differentiable (only
    the card's kernels raise when a gradient is wanted): d/d(x, dt, b, c) of
    a weighted sum of y equal jax's gradients of the reference's jnp form
    at the registry's compare."""
    args = _scan_inputs(8, 1, 200, 4, 32, 2, 16)
    wgt = np.random.default_rng(9).standard_normal(args[0].shape).astype(np.float32)

    def loss(x, dt, b, c):
        return jnp.sum(jssd.ssd_scan_jnp(x, dt, jnp.asarray(args[2]), b, c) * wgt)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(args[i]) for i in (0, 1, 3, 4)))
    x, dt, b, c = (torch.from_numpy(args[i]).requires_grad_(True) for i in (0, 1, 3, 4))
    (ssd_scan(x, dt, torch.from_numpy(args[2]), b, c) * torch.from_numpy(wgt)).sum().backward()
    for got, w in zip((x.grad, dt.grad, b.grad, c.grad), want):
        assert got is not None and _rel(got.numpy(), w) <= SCAN_REL


@pytest.mark.parametrize("bad", ["ndim", "dt", "groups"])
def test_ssd_scan_rejects_bad_shapes(bad):
    x, dt, a = torch.zeros(1, 8, 4, 32), torch.zeros(1, 8, 4), torch.zeros(4)
    b = torch.zeros(1, 8, 1, 16)
    if bad == "ndim":
        x = x[0]
    elif bad == "dt":
        dt = torch.zeros(1, 8, 3)
    else:
        b = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError):
        ssd_scan(x, dt, a, b, b)


# -- the slice: reduced mamba2-780m --------------------------------------------


@pytest.fixture(scope="module")
def model():
    jview = jget_arch("mamba2-780m").view(reduced=True)
    tcfg = tget_arch("mamba2-780m").resolve(reduced=True)
    jparams = jlm.lm_init(jax.random.PRNGKey(0), jview.config)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, tcfg.vocab, PROMPT + 7 * i).tolist() for i in range(3)]
    return jview, tcfg, jparams, tparams, prompts


def test_params_cross_with_the_mamba2_tree(model):
    jview, tcfg, jparams, tparams, _ = model
    assert len(tparams["layers"]) == tcfg.n_layers
    layer = tparams["layers"][2]
    assert set(layer) == {"norm1", "mixer"}
    for name in ("in_proj", "conv_w", "conv_b", "a_log", "dt_bias", "d_skip", "norm", "out_proj"):
        assert name in layer["mixer"]
    np.testing.assert_array_equal(layer["mixer"]["conv_w"].numpy(),
                                  np.asarray(jparams["unit_0"]["mixer"]["conv_w"][2]))


def _assert_state_cache(tcache, jcache, mode):
    for name in ("conv", "ssm"):
        want = np.asarray(jcache["unit_0"][name]).astype(np.float32)
        got = tcache["unit_0"][name]
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=CACHE_ULPS[mode] * ulp)


@pytest.mark.parametrize("mode", MODES)
def test_mamba2_prefill_and_decode_logits_match_reference(model, mode):
    """Prefill two 150-token rows (2 chunks, the second ragged), compare the
    conv/ssm cache leaves, then two decode steps on the state cache."""
    jview, tcfg, jparams, tparams, prompts = model
    toks = np.asarray([prompts[0], prompts[0][::-1]], np.int64)
    jctx, tctx = JContext(cfg=jserving_config(mode)), TContext(cfg=tserving_config(mode))
    jl, jc = jlm.lm_prefill(jparams, jview.config, jnp.asarray(toks, jnp.int32), jctx)
    tl, tc = tlm.lm_prefill(tparams, tcfg, torch.from_numpy(toks), tctx)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGIT_ATOL[mode])
    _assert_state_cache(tc, jc, mode)
    nxt = np.array(jnp.argmax(jl, -1))
    np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
    for _ in range(2):
        jl, jc = jlm.lm_decode_step(jparams, jview.config, jnp.asarray(nxt, jnp.int32),
                                    jlm.pad_cache(jc, 2), jctx)
        tl, tc = tlm.lm_decode_step(tparams, tcfg, torch.from_numpy(nxt).to(torch.int64),
                                    tlm.pad_cache(tc, 2), tctx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGIT_ATOL[mode])
        nxt = np.array(jnp.argmax(jl, -1))
    _assert_state_cache(tc, jc, mode)


@pytest.mark.parametrize("mode", MODES)
def test_mamba2_engine_tokens_match_reference_engine(model, mode):
    """2 slots, 3 requests of 150-164 tokens (the third joins mid-flight
    into a released slot): identical greedy tokens."""
    jview, tcfg, jparams, tparams, prompts = model
    max_len = PROMPT + 7 * 2 + GEN + 1
    step_cfg = StepConfig(spring=jserving_config(mode), optimizer=OptimizerConfig())
    jeng = JEngine(jview, step_cfg, params=jparams, n_slots=2, max_len=max_len)
    teng = TEngine(tcfg, tserving_config(mode), params=tparams, n_slots=2, max_len=max_len,
                   device="cpu")
    for i, p in enumerate(prompts):
        jeng.submit_prompt(p, GEN, seed=100 + i)
        teng.submit_prompt(p, GEN, seed=100 + i)
    want = [r["tokens"] for r in jeng.run()["per_request"]]
    out = teng.run()
    assert [r["tokens"] for r in out["per_request"]] == want
    assert out["finite"] and all(r["n_tokens"] == GEN for r in out["per_request"])
    assert out["kv_elems"] == 0.0  # no seq-bearing leaf: nothing is packed


def test_pool_keeps_state_leaves_dense_per_slot(model):
    """The conv/ssm leaves pass through the pool dense: install copies one
    slot's rows bit for bit, merge keeps idle slots, release zeroes only
    its slot."""
    _, tcfg, _, tparams, prompts = model
    ctx = TContext(cfg=tserving_config("quant_sparse"))
    _, pc = tlm.lm_prefill(tparams, tcfg, torch.tensor([prompts[1]]), ctx)
    pool = tkvpool.init_pool(tcfg, 3, 32)
    assert all(isinstance(v, torch.Tensor) for v in pool["unit_0"].values())
    tkvpool.install_packed(pool, pc, 1, len(prompts[1]))
    dense = tkvpool.unpack_cache(pool)
    for name in ("conv", "ssm"):
        assert torch.equal(dense["unit_0"][name][:, 1], pc["unit_0"][name][:, 0])
        assert not dense["unit_0"][name][:, [0, 2]].any()
    new = {"pos": dense["pos"] + 1,
           "unit_0": {n: torch.ones_like(v) for n, v in dense["unit_0"].items()}}
    merged = tkvpool.merge_active(new, dense, torch.tensor([False, True, False]))
    assert merged["pos"].tolist() == [0, len(prompts[1]) + 1, 0]
    assert bool((merged["unit_0"]["ssm"][:, 1] == 1).all())
    assert not merged["unit_0"]["ssm"][:, [0, 2]].any()
    tkvpool.release_packed(pool, 1)
    assert not any(bool(v.any()) for v in pool["unit_0"].values())
    assert pool["pos"].tolist() == [0, 0, 0]
