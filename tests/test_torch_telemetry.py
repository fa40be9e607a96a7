"""Telemetry and sampled decode in the port, against the reference.

  * ``QuantileSketch``: the same adds give the same ``to_dict`` in both
    packages, in the exact and the bucketed phase, and merged sketches
    agree; ``MetricsRegistry``: the same writes give the same Prometheus
    exposition;
  * the port's Chrome trace passes the reference's ``validate_chrome_trace``;
    an engine run with telemetry on emits the reference engine's span names
    and ``spring_serve_*`` metric families on the same workload (the
    reduced llama3.2-1b, quant_sparse, a rescale that spills), and the same
    tokens as with telemetry off;
  * the kernel registry's instrumentation feeds ``spring_kernel_<key>{op}``
    histograms into the port's default registry under a telemetry scope;
  * sampled decode: float64 frequencies over many draw indices on fixed
    logits lie within 5 sigma of the softmax probabilities; a request's
    sampled tokens are the same alone, with co-tenants and in another slot.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import telemetry as jtel  # noqa: E402
from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch.serve import serving_config as jserving_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim.optimizers import OptimizerConfig  # noqa: E402
from repro.runtime.train import StepConfig  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402

from repro_torch import telemetry as ttel  # noqa: E402
from repro_torch.configs import get_arch as tget_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.launch.serve import serving_config as tserving_config  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TEngine  # noqa: E402
from repro_torch.serving.engine import draw_seed, sample_token  # noqa: E402

pytestmark = pytest.mark.telemetry


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the reduced models' ops are too small to gain
    from more, and the suite's other workers share the cores (with a
    thread per core in every worker, this file ran 20x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PROMPT, GEN, MAX_LEN = 8, 4, 64


# -- sketches and the registry ---------------------------------------------------------


@pytest.mark.parametrize("n", [0, 1, 50, 128, 129, 2000])
def test_sketch_to_dict_matches_the_reference(n):
    """Values of both signs, zeros and magnitudes from 1e-6 to 1e6: the
    exact phase (n <= 128) and the bucketed one."""
    rng = np.random.default_rng(n)
    vals = (rng.choice([-1.0, 1.0, 0.0], n, p=[0.3, 0.6, 0.1])
            * 10.0 ** rng.uniform(-6, 6, n)).tolist()
    j, t = jtel.QuantileSketch(), ttel.QuantileSketch()
    for v in vals:
        j.add(v)
        t.add(v)
    assert t.to_dict() == j.to_dict()
    assert t.percentiles() == j.percentiles()
    assert ttel.QuantileSketch.from_dict(j.to_dict()) == t


def test_merged_sketches_match_the_reference():
    rng = np.random.default_rng(7)
    parts = [rng.exponential(0.01, k).tolist() for k in (40, 100, 300)]
    jm, tm = jtel.QuantileSketch(), ttel.QuantileSketch()
    for p in parts:
        jm = jm.merge(jtel.QuantileSketch().update(p))
        tm = tm.merge(ttel.QuantileSketch().update(p))
    assert tm.to_dict() == jm.to_dict()
    assert [tm.quantile(q) for q in (0.1, 0.5, 0.99)] == \
        [jm.quantile(q) for q in (0.1, 0.5, 0.99)]


def test_registry_prometheus_exposition_matches_the_reference():
    regs = (jtel.MetricsRegistry(), ttel.MetricsRegistry())
    for reg in regs:
        reg.inc("spring_serve_tokens_total", 3, help="decode tokens emitted")
        reg.inc("spring_serve_shed_total", 1, reason="deadline")
        reg.set("spring_serve_kv_pool_density", 0.375)
        for v in (0.25, 0.5, 0.125, 2.0):
            reg.observe("spring_serve_decode_step_s", v, op="decode")
    j, t = regs
    assert t.to_prometheus() == j.to_prometheus()
    assert t.snapshot() == j.snapshot()
    assert json.loads(json.dumps(t.snapshot())) == t.snapshot()


# -- spans and metrics of an engine run --------------------------------------------------


@pytest.fixture(scope="module")
def model():
    jview = jget_arch("llama3.2-1b").view(reduced=True)
    tcfg = tget_arch("llama3.2-1b").resolve(reduced=True)
    jparams = jlm.lm_init(jax.random.PRNGKey(0), jview.config)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab, PROMPT + i).tolist() for i in range(3)]
    return jview, tcfg, jparams, tparams, prompts


def _traced(engine, prompts, tel, path):
    """Serve ``prompts`` (a rescale to 1 slot after two ticks, so requests
    spill and resume) inside a telemetry scope writing ``path``."""
    reg = tel.default_registry()
    reg.reset()
    with tel.scope(tel.TelemetryConfig(enabled=True, trace_path=str(path))):
        for i, p in enumerate(prompts):
            engine.submit_prompt(p, GEN, seed=100 + i)
        for _ in range(2):
            engine.step()
        engine.rescale(1)
        out = engine.run()
    return out, reg.snapshot()


def _port_engine(tcfg, tparams, **kw):
    return TEngine(tcfg, tserving_config("quant_sparse"), params=tparams, n_slots=2,
                   max_len=MAX_LEN, device="cpu", **kw)


def test_engine_spans_and_metrics_are_the_references(model, tmp_path):
    jview, tcfg, jparams, tparams, prompts = model
    step_cfg = StepConfig(spring=jserving_config("quant_sparse"), optimizer=OptimizerConfig())
    jeng = JEngine(jview, step_cfg, params=jparams, n_slots=2, max_len=MAX_LEN)
    jout, jsnap = _traced(jeng, prompts, jtel, tmp_path / "ref.json")
    tout, tsnap = _traced(_port_engine(tcfg, tparams), prompts, ttel, tmp_path / "port.json")
    jnames = {e["name"] for e in jtel.validate_chrome_trace((tmp_path / "ref.json").read_text())}
    tnames = {e["name"] for e in jtel.validate_chrome_trace((tmp_path / "port.json").read_text())}
    assert tnames == jnames
    assert {"serve.tick", "serve.tick.schedule", "serve.tick.prefill", "serve.tick.install",
            "serve.tick.decode", "serve.tick.sample", "serve.tick.repack",
            "serve.tick.spill", "serve.tick.resume", "serve.rescale"} <= tnames
    serve = {k for k in jsnap if k.startswith("spring_serve_")}
    assert {k for k in tsnap if k.startswith("spring_serve_")} == serve
    assert tsnap["spring_serve_tokens_total"] == jsnap["spring_serve_tokens_total"]
    assert [r["tokens"] for r in tout["per_request"]] == \
        [r["tokens"] for r in jout["per_request"]]


def test_telemetry_changes_no_token(model, tmp_path):
    _, tcfg, _, tparams, prompts = model
    on, _ = _traced(_port_engine(tcfg, tparams), prompts, ttel, tmp_path / "t.json")
    off = _port_engine(tcfg, tparams)
    for i, p in enumerate(prompts):
        off.submit_prompt(p, GEN, seed=100 + i)
    for _ in range(2):
        off.step()
    off.rescale(1)
    off = off.run()
    assert [r["tokens"] for r in on["per_request"]] == [r["tokens"] for r in off["per_request"]]
    assert on["elastic"]["n_spills"] == off["elastic"]["n_spills"] > 0


def test_launcher_telemetry_writes_a_valid_trace(tmp_path, capsys):
    path = tmp_path / "serve_trace.json"
    base = ["--reduced", "--device", "cpu", "--slots", "2", "--queue", "3",
            "--prompt-len", "8", "--gen", "4"]
    off = serve_main(base)
    on = serve_main(base + ["--telemetry", "--trace-path", str(path)])
    capsys.readouterr()
    events = jtel.validate_chrome_trace(path.read_text())
    assert on["telemetry"]["spans"] == len(events) > 0
    assert on["telemetry"]["trace_path"] == str(path)
    assert "spring_serve_tick_utilization" in on["telemetry"]["metrics"]
    assert "telemetry" not in off
    assert [r["tokens"] for r in on["per_request"]] == [r["tokens"] for r in off["per_request"]]
    # the report CLI renders the artifact as the reference's does
    from repro.telemetry import report as jreport
    from repro_torch.telemetry import report as treport

    art = tmp_path / "serve.json"
    art.write_text(json.dumps(on, default=float))
    for argv in ([str(art)], [str(art), "--prom"], ["--validate-trace", str(path)]):
        treport.main(argv)
        mine = capsys.readouterr().out
        jreport.main(argv)
        assert mine == capsys.readouterr().out and mine


def test_kernel_metrics_feed_the_registry_under_a_scope():
    from repro.kernels import registry as jregistry
    from repro_torch.kernels import registry
    from repro_torch.kernels.masked_matmul.ops import masked_matmul

    assert not registry.metrics_active()
    reg = ttel.default_registry()
    reg.reset()
    x = torch.zeros(8, 8)
    x[:4] = 1.0
    with ttel.scope(ttel.TelemetryConfig(enabled=True)):
        assert registry.metrics_active()
        masked_matmul(x, torch.ones(8, 8))
    assert not registry.metrics_active()
    name = jregistry.KERNEL_METRIC_PREFIX + "tile_skip"
    assert registry.KERNEL_METRIC_PREFIX == jregistry.KERNEL_METRIC_PREFIX
    cell = reg.get(name, op="masked_matmul")
    assert cell is not None and cell.count == 1
    assert f'{name}_count{{op="masked_matmul"}} 1' in reg.to_prometheus()


# -- sampled decode -----------------------------------------------------------------------


def test_sampled_frequencies_match_the_softmax():
    """20,000 draws (seed 5, draw indices 0..19,999) from fixed logits: each
    category's float64 frequency lies within 5 sigma of its softmax
    probability, sigma = sqrt(p (1 - p) / n)."""
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -1.0, -3.0, 0.25, 1.5])
    n = 20_000
    counts = np.bincount([sample_token(logits, 5, i) for i in range(n)],
                         minlength=logits.numel()).astype(np.float64)
    p = torch.softmax(logits.double(), -1).numpy()
    sigma = np.sqrt(p * (1 - p) / n)
    assert np.all(np.abs(counts / n - p) <= 5 * sigma), (counts / n, p)


def test_draw_seeds_are_a_pure_function():
    assert draw_seed(7, 3) == draw_seed(7, 3)
    seeds = {draw_seed(s, i) for s in range(20) for i in range(50)}
    assert len(seeds) == 1000 and all(0 <= s < 2**63 for s in seeds)
    logits = torch.randn(50, generator=torch.Generator().manual_seed(0))
    assert sample_token(logits, 1, 2) == sample_token(logits.clone(), 1, 2)


def test_sampled_tokens_do_not_depend_on_co_tenants_or_slot(model):
    """Request X (prompt 0, seed 100) sampled alone in slot 0, behind
    another request in slot 1, and queued behind two co-tenants in a
    2-slot pool: the same tokens each time."""
    _, tcfg, _, tparams, prompts = model

    def serve(order, slots):
        eng = TEngine(tcfg, tserving_config("quant_sparse"), params=tparams, n_slots=slots,
                      max_len=MAX_LEN, greedy=False, device="cpu")
        for i in order:
            eng.submit_prompt(prompts[i], GEN + 2, seed=100 + i)
        out = eng.run()
        row = out["per_request"][order.index(0)]
        return row["tokens"], eng._results[row["rid"]].slot

    alone, slot_a = serve([0], 1)
    second, slot_b = serve([1, 0], 2)
    queued, _ = serve([1, 2, 0], 2)
    assert (slot_a, slot_b) == (0, 1)
    assert alone == second == queued
    assert len(alone) == GEN + 2
