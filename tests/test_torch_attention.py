"""Port parity for flash attention and the long-prompt llama prefill:
``repro_torch`` against ``repro``, on the CPU.

The reference's Pallas kernel runs in interpret mode; the port's wrapper
runs its plain version for CPU tensors.  Tolerances are the reference
registry's own (``flash_attention/ops.py:57-58``): atol 2e-5 for fp32
(fp32 softmax sums in another order), 2e-2 for bf16 (one bf16 rounding of
outputs of magnitude ~1).  Model-level tolerances are those of
``tests/test_torch_model.py`` (quantized logits 1e-3, dense 2e-2, bf16
caches within 1 or 8 ulps), and served greedy tokens must be identical.
The reduced llama3.2-1b prompts are longer than one 128-key block, so the
reference's kernel crosses kv blocks and pads a ragged tail.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.kernels.flash_attention import ops as jfa  # noqa: E402
from repro.launch.serve import serving_config as jserving_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.layers import SpringContext as JContext  # noqa: E402
from repro.optim.optimizers import OptimizerConfig  # noqa: E402
from repro.runtime.train import StepConfig  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402

from repro_torch.configs import get_arch as tget_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    attention_reference, flash_attention)
from repro_torch.launch.serve import serving_config as tserving_config  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.layers import SpringContext as TContext  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TEngine  # noqa: E402

MODES = ("dense", "quant", "quant_sparse")
LOGIT_ATOL = {"dense": 2e-2, "quant": 1e-3, "quant_sparse": 1e-3}
CACHE_ULPS = {"dense": 8, "quant": 1, "quant_sparse": 1}
FLASH_PIN = "flash_attention=interpret"
PROMPT, GEN = 150, 5


def _torch(a) -> torch.Tensor:
    """A jax array as a torch tensor of the same dtype (bf16 via fp32, exact)."""
    t = torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))
    return t.to(torch.bfloat16) if a.dtype == jnp.bfloat16 else t


@functools.cache
def _fa_examples() -> list:
    return jfa._examples()


# -- the kernel's function on the registry's examples ---------------------------


@pytest.mark.parametrize("case", range(5))
def test_flash_attention_plain_matches_reference_kernel(case):
    """The five registry examples (causal, ragged 300, window 128,
    non-causal at D=128, bf16) against the interpret-mode Pallas kernel."""
    args, kw, *cmp = _fa_examples()[case]
    atol = cmp[0]["atol"] if cmp else 2e-5
    want = np.asarray(jfa.flash_attention(*args, impl="interpret", **kw).astype(jnp.float32))
    got = flash_attention(*(_torch(a) for a in args), **kw)
    assert got.dtype == _torch(args[0]).dtype and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)


def test_flash_attention_plain_version_keeps_its_gradient():
    """On the CPU the wrapper's plain version stays differentiable (only
    the card's kernel raises when a gradient is wanted): d/d(q, k, v) of a
    weighted sum of the causal GQA output equal jax's gradients of the
    reference's oracle (``impl="ref"``) within 2e-5."""
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((1, 4, 150, 32), (1, 2, 150, 32), (1, 2, 150, 32)))
    wgt = rng.standard_normal(q.shape).astype(np.float32)

    def loss(q, k, v):
        return jnp.sum(jfa.flash_attention(q, k, v, impl="ref") * wgt)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    (flash_attention(tq, tk, tv) * torch.from_numpy(wgt)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        assert got is not None
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0, atol=2e-5)


def test_flash_attention_noncausal_ragged_follows_the_oracle():
    """Non-causal with a ragged Skv (200): the port masks keys >= Skv and
    matches the reference's oracle (``impl="ref"``).  The reference's own
    Pallas route pads Skv to 256 with zero keys that it masks only
    causally, so they enter its softmax: it sits about 0.07 from its
    oracle here (a reference-side condition, ROADMAP §3)."""
    rng = np.random.default_rng(7)
    q, k, v = (rng.standard_normal((1, 4, 200, 64)).astype(np.float32) for _ in range(3))
    k, v = k[:, :2], v[:, :2]
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    oracle = np.asarray(jfa.flash_attention(jq, jk, jv, causal=False, impl="ref"))
    interp = np.asarray(jfa.flash_attention(jq, jk, jv, causal=False, impl="interpret"))
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=False)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=0, atol=2e-5)
    assert np.abs(interp - oracle).max() > 1e-2  # the padded keys the port does not admit


def test_flash_attention_reads_strided_views():
    """The model hands the wrapper (B,S,H,D) projections transposed to
    (B,H,S,D) views; the result equals the contiguous inputs' and the
    plain version's."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 70, 8, 16, generator=gen)
    k = torch.randn(2, 70, 2, 16, generator=gen)
    v = torch.randn(2, 70, 2, 16, generator=gen)
    views = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    got = flash_attention(*views)
    want = attention_reference(*(t.contiguous() for t in views))
    assert torch.equal(got, want)


@pytest.mark.parametrize("bad", ["ndim", "heads", "head_dim", "window"])
def test_flash_attention_rejects_bad_shapes(bad):
    q, k = torch.zeros(1, 4, 8, 16), torch.zeros(1, 2, 8, 16)
    kw = {}
    if bad == "ndim":
        q = q[0]
    elif bad == "heads":
        k = torch.zeros(1, 3, 8, 16)
    elif bad == "head_dim":
        k = torch.zeros(1, 2, 8, 32)
    else:
        kw = {"window": 0}
    with pytest.raises(ValueError):
        flash_attention(q, k, k, **kw)


# -- the slice: reduced llama3.2-1b with long prompts ---------------------------


@pytest.fixture(scope="module")
def model():
    jview = jget_arch("llama3.2-1b").view(reduced=True)
    tcfg = tget_arch("llama3.2-1b").resolve(reduced=True)
    jparams = jlm.lm_init(jax.random.PRNGKey(0), jview.config)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab, PROMPT + 7 * i).tolist() for i in range(3)]
    return jview, tcfg, jparams, tparams, prompts


@pytest.mark.parametrize("mode", MODES)
def test_long_prefill_and_decode_logits_match_reference_flash_route(model, mode):
    """Prefill over two 150-token rows through the flash route (the
    reference pinned to its interpret-mode kernel), then one decode step."""
    jview, tcfg, jparams, tparams, prompts = model
    toks = np.asarray([prompts[0], prompts[0][::-1]], np.int64)
    jctx = JContext(cfg=jserving_config(mode, FLASH_PIN))
    tctx = TContext(cfg=tserving_config(mode))
    jl, jc = jlm.lm_prefill(jparams, jview.config, jnp.asarray(toks, jnp.int32), jctx)
    tl, tc = tlm.lm_prefill(tparams, tcfg, torch.from_numpy(toks), tctx)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGIT_ATOL[mode])
    for name in ("k", "v"):
        want = np.asarray(jc["unit_0"][name]).astype(np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(tc["unit_0"][name].float().numpy(), want,
                                   rtol=0, atol=CACHE_ULPS[mode] * ulp)
    nxt = np.array(jnp.argmax(jl, -1))
    np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
    jd, _ = jlm.lm_decode_step(jparams, jview.config, jnp.asarray(nxt, jnp.int32),
                               jlm.pad_cache(jc, 2), jctx)
    td, _ = tlm.lm_decode_step(tparams, tcfg, torch.from_numpy(nxt).to(torch.int64),
                               tlm.pad_cache(tc, 2), tctx)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=LOGIT_ATOL[mode])


@pytest.mark.parametrize("mode", MODES)
def test_long_prompt_engine_tokens_match_reference_flash_engine(model, mode):
    """2 slots, 3 requests of 150-164 tokens: the port's engine and the
    reference engine on its flash route give identical greedy tokens."""
    jview, tcfg, jparams, tparams, prompts = model
    max_len = PROMPT + 7 * 2 + GEN + 1
    step_cfg = StepConfig(spring=jserving_config(mode, FLASH_PIN), optimizer=OptimizerConfig())
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
