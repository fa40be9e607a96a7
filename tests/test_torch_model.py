"""Port parity, model and serving level: ``repro_torch`` against ``repro``.

The JAX reference's ``lm_init`` parameters are carried across with
``params_from_jax``; the same numpy prompts go through both packages on
the CPU (the port's kernel wrappers run their plain versions there).

Tolerances: quantized matmuls sum fp32 products in another order than
XLA's CPU dot, which moves a result across a rounding boundary of the
Q4.16 grid now and then — by exactly one step, 2**-16.  Through a 3-layer
model that stays far below 1e-3 at the logits (measured 2e-5), so
quantized logits are held to atol 1e-3.  The bf16 KV caches are roundings
of those values: a one-step difference can flip a rounding, so caches are
held to one bf16 ulp at their largest magnitude.  Dense mode carries bf16
activations (8 significant bits): the reference's own scan-compiled and
op-by-op forms of the same prefill differ by 7.1e-3 at these logits, as
XLA keeps some bf16 intermediates in fp32 when it fuses, so dense logits
are held to 2e-2 and dense caches to 8 ulps.  Greedy tokens must be
identical in every mode.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.core import spring_ops as jops  # noqa: E402
from repro.kernels.registry import KernelPolicy  # noqa: E402
from repro.launch.serve import serving_config as jserving_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.layers import SpringContext as JContext  # noqa: E402
from repro.optim.optimizers import OptimizerConfig  # noqa: E402
from repro.runtime.train import StepConfig  # noqa: E402
from repro.serving import kvpool as jkvpool  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402

from repro_torch.configs import get_arch as tget_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core import spring_ops as tops  # noqa: E402
from repro_torch.launch.serve import serving_config as tserving_config  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models.layers import SpringContext as TContext  # noqa: E402
from repro_torch.serving import kvpool as tkvpool  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TEngine  # noqa: E402

MODES = ("dense", "quant", "quant_sparse")
LOGIT_ATOL = {"dense": 2e-2, "quant": 1e-3, "quant_sparse": 1e-3}
CACHE_ULPS = {"dense": 8, "quant": 1, "quant_sparse": 1}
GRID = 2.0**-16
PROMPT, GEN = 8, 5


@pytest.fixture(scope="module")
def model():
    jview = jget_arch("llama3.2-1b").view(reduced=True)
    tcfg = tget_arch("llama3.2-1b").resolve(reduced=True)
    jparams = jlm.lm_init(jax.random.PRNGKey(0), jview.config)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab, PROMPT + i).tolist() for i in range(4)]
    return jview, tcfg, jparams, tparams, prompts


# -- (d) spring_matmul in all three modes --------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_spring_matmul_matches_reference(mode):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((37, 128)) * 2).astype(np.float32)
    w = (rng.standard_normal((128, 200)) / 11).astype(np.float32)
    want = np.asarray(jops.spring_matmul(jnp.asarray(x), jnp.asarray(w),
                                         jserving_config(mode)).astype(jnp.float32))
    got = tops.spring_matmul(torch.from_numpy(x), torch.from_numpy(w),
                             tserving_config(mode)).to(torch.float32).numpy()
    if mode == "dense":
        np.testing.assert_array_equal(got, want)  # one bf16 rounding of fp32 sums
    else:
        # one grid step where the fp32 sum order crosses a rounding boundary
        assert np.abs(got - want).max() <= GRID
        assert np.mean(got == want) > 0.95
        np.testing.assert_array_equal(got / GRID, np.round(got / GRID))  # on the grid


def test_spring_matmul_sr_epilogue_matches_tpu_path():
    """With stochastic rounding on (and no model-level key), the port runs the
    kernel's SR epilogue, as the reference's TPU path does: exact against the
    reference pinned to the interpret-mode Pallas kernel, on coarse-grid
    operands whose sums are exact."""
    rng = np.random.default_rng(2)
    x = (np.round(rng.standard_normal((70, 96)) * 64) / 256).astype(np.float32)
    w = (np.round(rng.standard_normal((96, 130)) * 64) / 256).astype(np.float32)
    jcfg = dataclasses.replace(jops.QUANT_SPARSE,
                               kernels=KernelPolicy.parse("masked_matmul=interpret"))
    want = np.asarray(jops.spring_matmul(jnp.asarray(x), jnp.asarray(w), jcfg))
    got = tops.spring_matmul(torch.from_numpy(x), torch.from_numpy(w), tops.QUANT_SPARSE)
    np.testing.assert_array_equal(got.numpy(), want)


def test_model_level_sr_is_refused():
    with pytest.raises(NotImplementedError, match="threefry"):
        tops.spring_matmul(torch.zeros(2, 3), torch.zeros(3, 4), tops.QUANT, keys=object())


# -- slice end to end: prefill / decode logits and the served tokens ----------


@pytest.mark.parametrize("mode", MODES)
def test_prefill_and_decode_logits_match_reference(model, mode):
    jview, tcfg, jparams, tparams, prompts = model
    toks = np.asarray([prompts[0], prompts[0][::-1]], np.int64)
    jctx, tctx = JContext(cfg=jserving_config(mode)), TContext(cfg=tserving_config(mode))
    jl, jc = jlm.lm_prefill(jparams, jview.config, jnp.asarray(toks, jnp.int32), jctx)
    tl, tc = tlm.lm_prefill(tparams, tcfg, torch.from_numpy(toks), tctx)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=LOGIT_ATOL[mode])
    # the caches are bf16 roundings of k/v: equal up to flipped roundings
    for name in ("k", "v"):
        want = np.asarray(jc["unit_0"][name]).astype(np.float32)
        ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
        np.testing.assert_allclose(tc["unit_0"][name].float().numpy(), want,
                                   rtol=0, atol=CACHE_ULPS[mode] * ulp)
    nxt = np.array(jnp.argmax(jl, -1))  # a writable copy for torch.from_numpy
    np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt)
    jd, _ = jlm.lm_decode_step(jparams, jview.config, jnp.asarray(nxt, jnp.int32),
                               jlm.pad_cache(jc, 2), jctx)
    td, _ = tlm.lm_decode_step(tparams, tcfg, torch.from_numpy(nxt).to(torch.int64),
                               tlm.pad_cache(tc, 2), tctx)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=LOGIT_ATOL[mode])


def _jax_engine_tokens(jview, jparams, prompts, mode, n_slots):
    step_cfg = StepConfig(spring=jserving_config(mode), optimizer=OptimizerConfig())
    eng = JEngine(jview, step_cfg, params=jparams, n_slots=n_slots, max_len=64)
    for i, p in enumerate(prompts):
        eng.submit_prompt(p, GEN, seed=100 + i)
    return [r["tokens"] for r in eng.run()["per_request"]]


def _port_engine(tcfg, tparams, prompts, mode, n_slots):
    eng = TEngine(tcfg, tserving_config(mode), params=tparams, n_slots=n_slots,
                  max_len=64, device="cpu")
    for i, p in enumerate(prompts):
        eng.submit_prompt(p, GEN, seed=100 + i)
    out = eng.run()
    return [r["tokens"] for r in out["per_request"]], out


@pytest.mark.parametrize("mode", MODES)
def test_engine_tokens_match_reference_engine(model, mode):
    """2 slots, 4 requests of ragged lengths: requests join mid-flight and
    slots sit at different depths; greedy tokens are identical."""
    jview, tcfg, jparams, tparams, prompts = model
    want = _jax_engine_tokens(jview, jparams, prompts, mode, n_slots=2)
    got, out = _port_engine(tcfg, tparams, prompts, mode, n_slots=2)
    assert got == want
    assert out["finite"] and out["decode_steps"] >= 2 * GEN
    assert all(r["n_tokens"] == GEN for r in out["per_request"])
    assert out["kv_traffic_reduction_vs_fp32"] > 1.0


def test_engine_tokens_invariant_to_batch_composition(model):
    """(f) A request's tokens do not depend on who shares its batch: alone,
    with 3 co-tenants, queued behind 2 slots, or admitted last."""
    _, tcfg, _, tparams, prompts = model
    alone, _ = _port_engine(tcfg, tparams, prompts[:1], "quant_sparse", n_slots=2)
    together, _ = _port_engine(tcfg, tparams, prompts, "quant_sparse", n_slots=4)
    queued, _ = _port_engine(tcfg, tparams, prompts, "quant_sparse", n_slots=2)
    rev, _ = _port_engine(tcfg, tparams, prompts[1:] + prompts[:1], "quant_sparse", n_slots=2)
    assert together[0] == alone[0]
    assert queued == together
    assert rev[-1] == alone[0]


# -- packed KV pool -------------------------------------------------------------


def test_pool_pack_matches_reference_and_roundtrips(model):
    """The port's packed pool holds the reference's exact bits for the same
    cache, and unpacks bit-exactly; install/release touch only their slot."""
    jview, tcfg, jparams, tparams, prompts = model
    toks = np.asarray([prompts[1]], np.int64)
    ctx = TContext(cfg=tserving_config("quant_sparse"))
    _, tc = tlm.lm_prefill(tparams, tcfg, torch.from_numpy(toks), ctx)
    tpool = tkvpool.init_pool(tcfg, 3, 16)
    tkvpool.install_packed(tpool, tc, 1, toks.shape[1])
    jcache = {"pos": jnp.zeros((3,), jnp.int32),
              "unit_0": {n: jnp.asarray(tkvpool.unpack_cache(tpool)["unit_0"][n]
                                        .view(torch.int16).numpy().view(np.uint16)
                                        .view(jnp.bfloat16)) for n in ("k", "v")}}
    jpool = jkvpool.pack_cache(jcache, "ref")
    for n in ("k", "v"):
        t, j = tpool["unit_0"][n], jpool["unit_0"][n]
        np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
        np.testing.assert_array_equal(t.nnz.numpy(), np.asarray(j.nnz))
        np.testing.assert_array_equal(t.values.view(torch.int16).numpy(),
                                      np.asarray(j.values).view(np.int16))
        dense = tkvpool.unpack_cache(tpool)["unit_0"][n]
        np.testing.assert_array_equal(dense[:, 1, :toks.shape[1]].view(torch.int16).numpy(),
                                      tc["unit_0"][n][:, 0].view(torch.int16).numpy())
        assert not dense[:, [0, 2]].any() and not dense[:, 1, toks.shape[1]:].any()
    assert tpool["pos"].tolist() == [0, toks.shape[1], 0]
    stats = tkvpool.pool_wire_stats(tpool)
    jstats = jkvpool.pool_wire_stats(jpool)
    for key in ("kv_elems", "kv_nnz", "kv_wire_bytes", "kv_dense_fp32_bytes"):
        assert stats[key] == pytest.approx(jstats[key], rel=1e-12)
    tkvpool.release_packed(tpool, 1)
    assert not any(bool(t.nnz.any()) for t in tpool["unit_0"].values())
    assert tpool["pos"].tolist() == [0, 0, 0]


def test_slot_ledger_rejects_double_release():
    ledger = tkvpool.SlotLedger(2)
    ledger.install(0)
    ledger.release(0)
    with pytest.raises(ValueError, match="double release"):
        ledger.release(0)


# -- package rules --------------------------------------------------------------


def test_port_imports_neither_jax_nor_reference():
    """(g) Importing every repro_torch module pulls in no jax and no repro
    module (the port keeps its own copies)."""
    import os
    import pathlib
    import subprocess
    import sys

    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad or len(names) < 20 else 0)\n")
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    env = {**os.environ, "PYTHONPATH": src}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_engine_without_a_card_raises(monkeypatch):
    """(h) With no CUDA device the entry points refuse the default device
    instead of running on the CPU; the CPU runs only when asked for."""
    from repro_torch.launch.serve import serve_session

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tcfg = tget_arch("llama3.2-1b").resolve(reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEngine(tcfg, tserving_config("quant_sparse"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_session("llama3.2-1b", reduced=True, queue=1, prompt_len=4, gen=2)
    out = serve_session("llama3.2-1b", reduced=True, queue=1, prompt_len=4, gen=2,
                        device="cpu")
    assert out["device"] == "cpu" and out["per_request"][0]["n_tokens"] == 2
