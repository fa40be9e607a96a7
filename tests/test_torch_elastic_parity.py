"""spring-survive, the port against the reference engine.

The reduced llama3.2-1b in quant_sparse with the reference's parameters
(``convert.params_from_jax``), 2 slots, pool length 64, 3 requests of
8-10 prompt tokens from ``default_rng(3)``, 5 tokens each.  Both engines
run the same schedule: two ticks, a rescale to 1 slot (both actives spill
their packed bits to the host), one tick, a snapshot, then a chaos
schedule (snapshot, ``.npz`` round trip, rewind, rescale to 3, kill into a
fresh engine).  Greedy nearest-rounding decode on the CPU, so every
comparison is exact:

  * per request: tokens, ``finished_by`` and ``finish_tick``; and the
    spill and resume counts;
  * a snapshot crosses packages bit for bit: the reference's mid-run
    snapshot restored into the port (and the port's into the reference)
    snapshots again to the same pool leaves, index by index and bit for
    bit (bf16 as uint16, mask words, nnz; ``pos`` by value: int32 in the
    reference, int64 here), and the same scheduler subtree, the spilled
    payloads' bits included; the restored engine then finishes with the
    writer's tokens;
  * the two snapshots the engines take at the same tick of their own runs
    agree in everything but the last bits of a few bf16 KV values: the
    pool's mask words, nnz and ``pos``, the scheduler, the ledger and the
    tokens exactly; the values where the port's plain fp32 sums (another
    order than XLA's) cross a rounding boundary, as
    ``test_torch_model.test_spring_matmul_matches_reference`` allows a
    quantized product one grid step: at most 1% of them, each within 2
    bf16 ulps;
  * the files: one package's ``save_snapshot`` output loads through the
    other's ``load_snapshot`` to the same arrays and meta.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch.serve import serving_config as jserving_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim.optimizers import OptimizerConfig  # noqa: E402
from repro.runtime.train import StepConfig  # noqa: E402
from repro.serving import elastic as jelastic  # noqa: E402
from repro.serving.engine import ServingEngine as JEngine  # noqa: E402

from repro_torch.configs import get_arch as tget_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.serve import serving_config as tserving_config  # noqa: E402
from repro_torch.serving import elastic as telastic  # noqa: E402
from repro_torch.serving.elastic.snapshot import _storable  # noqa: E402
from repro_torch.serving.engine import ServingEngine as TEngine  # noqa: E402

pytestmark = pytest.mark.elastic


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the reduced models' ops are too small to gain
    from more, and the suite's other workers share the cores (with a
    thread per core in every worker, this file ran 20x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PROMPT, GEN, SLOTS, MAX_LEN = 8, 5, 2, 64
FIELDS = ("tokens", "finished_by", "finish_tick")
PACKAGES = {"ref": jelastic, "port": telastic}
CHAOS = [("snapshot", 0, None), ("roundtrip", 1, None), ("rewind", 2, None),
         ("rescale", 3, 3), ("kill", 4, None)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both engines through the same schedule: (snapshot at the same tick,
    final summary, engine) per package, reference first."""
    jview = jget_arch("llama3.2-1b").view(reduced=True)
    tcfg = tget_arch("llama3.2-1b").resolve(reduced=True)
    jparams = jlm.lm_init(jax.random.PRNGKey(0), jview.config)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), tcfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, tcfg.vocab, PROMPT + i).tolist() for i in range(3)]
    step_cfg = StepConfig(spring=jserving_config("quant_sparse"), optimizer=OptimizerConfig())

    def jmake():
        return JEngine(jview, step_cfg, params=jparams, n_slots=SLOTS, max_len=MAX_LEN,
                       spec_hash="feedbeefcafe0123")

    def tmake():
        return TEngine(tcfg, tserving_config("quant_sparse"), params=tparams, n_slots=SLOTS,
                       max_len=MAX_LEN, spec_hash="feedbeefcafe0123", device="cpu")

    out = {}
    for name, make, el in (("ref", jmake, jelastic), ("port", tmake, telastic)):
        eng = make()
        for i, p in enumerate(prompts):
            eng.submit_prompt(p, GEN, seed=100 + i)
        for _ in range(2):
            eng.step()
        eng.rescale(1)
        eng.step()
        snap = eng.snapshot()
        events = [el.ChaosEvent(at, kind, slots=slots) for kind, at, slots in CHAOS]
        harness = el.ChaosHarness(eng, events, make_engine=make,
                                  tmp_dir=str(tmp_path_factory.mktemp(name)))
        out[name] = (snap, harness.run(), harness.engine)
    out["n_slots"] = (out["ref"][2].n_slots, out["port"][2].n_slots)
    return out


def _arr(x) -> np.ndarray:
    """A leaf as a numpy array of its bits' dtype (bf16 as uint16)."""
    if isinstance(x, torch.Tensor):
        return _storable(x)[0]
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _same_leaf(a, b, by_value: bool) -> bool:
    a, b = _arr(a), _arr(b)
    if a.shape != b.shape:
        return False
    if by_value:
        return np.array_equal(a.astype(np.int64), b.astype(np.int64))
    return a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _close_values(a, b) -> bool:
    """bf16 KV values equal but for the last bits of a few: at most 1% of
    them differ, each by at most 2 ulps (bit patterns as int16)."""
    a, b = _arr(a), _arr(b)
    if a.shape != b.shape or a.dtype != np.uint16 or b.dtype != np.uint16:
        return False
    ulps = np.abs(a.view(np.int16).astype(np.int32) - b.view(np.int16).astype(np.int32))
    return np.mean(ulps > 0) <= 0.01 and ulps.max() <= 2


def _same_bits(a, b) -> bool:
    return _same_leaf(a, b, by_value=False)


def _same_tree(a, b, path=(), values=_same_bits) -> None:
    """Equal trees: arrays bit for bit, a ``pos`` leaf by value (bf16 value
    leaves through ``values`` when given another check)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), path
        for k in a:
            _same_tree(a[k], b[k], path + (k,), values)
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, path + (i,), values)
    elif hasattr(a, "shape") or hasattr(b, "shape"):
        if path[-1:] == ("values",):
            assert values(a, b), path
        else:
            assert _same_leaf(a, b, by_value=path[-1:] == ("pos",)), path
    else:
        assert a == b, path


def test_chaos_run_matches_the_reference_engine(runs):
    (_, want, jeng), (_, got, teng) = runs["ref"], runs["port"]
    assert len(got["per_request"]) == len(want["per_request"]) == 3
    for w, g in zip(want["per_request"], got["per_request"]):
        assert {f: g[f] for f in FIELDS} == {f: w[f] for f in FIELDS}, g["rid"]
        assert g["n_tokens"] == GEN
    for key in ("n_spills", "n_resumes", "n_rescales"):
        assert got["elastic"][key] == want["elastic"][key], key
    assert got["elastic"]["n_spills"] >= 2
    assert runs["n_slots"] == (3, 3)
    assert got["ticks"] == want["latency"]["ticks"]


def _pool_tree(snap) -> dict:
    """The snapshot's pool leaves named by part (pos, then k and v as
    values, mask, nnz: the reference's leaf order)."""
    leaves = snap["backend"]["pool"]
    assert len(leaves) == 7
    names = ["pos"] + [part for _ in "kv" for part in ("values", "mask", "nnz")]
    return {"pool": [{name: leaf} for name, leaf in zip(names, leaves)]}


@pytest.mark.parametrize("writer", ["ref", "port"])
def test_a_snapshot_restores_across_packages_bit_for_bit(runs, writer, tmp_path):
    """One engine's mid-run snapshot, saved by its package, loaded by the
    other's and restored (relabelled with the reader's pool impl, the one
    signature field the packages name differently) into the other engine,
    which snapshots at once: the same pool leaves and scheduler, bit for
    bit; run on, it gives the writer's tokens."""
    snap, want, _ = runs[writer]
    reader_name = "port" if writer == "ref" else "ref"
    reader = runs[reader_name][2]
    path = str(tmp_path / "cross.npz")
    PACKAGES[writer].save_snapshot(snap, path)
    loaded = PACKAGES[reader_name].load_snapshot(path)
    impl = reader._signature()["kv_pack_impl"]
    reader.restore(dict(loaded, signature=dict(loaded["signature"], kv_pack_impl=impl,
                                               kv_unpack_impl=impl)))
    again = reader.snapshot()
    assert again["tick"] == snap["tick"] and again["decode_steps"] == snap["decode_steps"]
    pool, pool_again = snap["backend"]["pool"], again["backend"]["pool"]
    assert len(pool_again) == len(pool) == 7  # pos, then k and v as values, mask, nnz
    for i, (a, b) in enumerate(zip(pool, pool_again)):
        assert _same_leaf(a, b, by_value=i == 0), i
    assert snap["scheduler"]["spilled"], "the rescale to 1 slot left a request spilled"
    _same_tree(snap["scheduler"], again["scheduler"])
    assert again["ledger"] == snap["ledger"]
    assert _arr(again["next_tok"]).tolist() == _arr(snap["next_tok"]).tolist()
    got = reader.run()
    assert [r["tokens"] for r in got["per_request"]] == [r["tokens"] for r in want["per_request"]]


def test_snapshots_of_the_two_runs_at_the_same_tick_agree(runs):
    (jsnap, _, _), (tsnap, _, _) = runs["ref"], runs["port"]
    assert tsnap["tick"] == jsnap["tick"] and tsnap["decode_steps"] == jsnap["decode_steps"]
    jpool, tpool = jsnap["backend"]["pool"], tsnap["backend"]["pool"]
    assert np.asarray(jpool[1]).dtype.name == "bfloat16" and tpool[1].dtype == torch.bfloat16
    assert tpool[2].dtype == torch.uint32 and np.asarray(jpool[2]).dtype == np.uint32
    _same_tree(_pool_tree(jsnap), _pool_tree(tsnap), values=_close_values)
    assert jsnap["scheduler"]["spilled"], "the rescale to 1 slot left a request spilled"
    _same_tree(jsnap["scheduler"], tsnap["scheduler"], values=_close_values)
    assert tsnap["ledger"] == jsnap["ledger"]
    assert _arr(tsnap["next_tok"]).tolist() == _arr(jsnap["next_tok"]).tolist()
    assert [r["tokens"] for r in tsnap["results"]] == [r["tokens"] for r in jsnap["results"]]
    sig = {k: v for k, v in tsnap["signature"].items() if not k.startswith("kv_")}
    assert sig == {k: v for k, v in jsnap["signature"].items() if not k.startswith("kv_")}
    assert tsnap["signature"]["kv_pack_impl"] == "plain"


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_each_package_loads_the_others_file(runs, writer, tmp_path):
    """A file one package writes decodes through the other's
    ``load_snapshot`` to the same arrays and meta as through its own."""
    snap = runs[writer][0]
    path = str(tmp_path / f"{writer}.npz")
    PACKAGES[writer].save_snapshot(snap, path)
    mine = PACKAGES[writer].load_snapshot(path)
    theirs = PACKAGES["port" if writer == "ref" else "ref"].load_snapshot(path)
    _same_tree(mine, theirs)
    _same_tree(snap["backend"], theirs["backend"])
    assert theirs["version"] == snap["version"] and theirs["spec_hash"] == snap["spec_hash"]
    assert theirs["metrics"]["queue_sketch"] == snap["metrics"]["queue_sketch"]
