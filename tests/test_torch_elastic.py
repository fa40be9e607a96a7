"""spring-survive in the port: snapshots, restore, rescale and chaos on the
port's own engine (the twin of the monolithic half of
``tests/test_elastic.py``), and the launcher's snapshot and restore flags.

The reduced llama3.2-1b on the CPU (plain versions), 2 slots, pool length
64, 3 requests of 8-10 prompt tokens from ``default_rng(3)``, 4 tokens
each.  One engine is built per (mode, greedy) and cached with a snapshot
taken right after submission and its uninterrupted run's tokens (the
oracle): a test restores the snapshot and replays the same workload.
Every check is exact: a restored, rescaled or chaos-driven run must give
the oracle's tokens.
"""

import numpy as np
import pytest
from hypothesis import given, strategies as st

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.launch.serve import serving_config  # noqa: E402
from repro_torch.models.lm import lm_init  # noqa: E402
from repro_torch.serving.elastic import (ChaosEvent, ChaosHarness, SnapshotError,  # noqa: E402
                                         load_snapshot, save_snapshot)
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.scheduler import REJECT_QUEUE_FULL, ShedPolicy  # noqa: E402

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


PROMPT, GEN, MAX_LEN = 8, 4, 64
N_PROMPTS = 3
MODES = ["dense", "quant", "quant_sparse"]

_ENGINES: dict = {}


def _build_engine(mode, *, arch="llama3.2-1b", n_slots=2, greedy=True, shed=None,
                  spec_hash="feedbeefcafe0123"):
    cfg = get_arch(arch).resolve(reduced=True)
    params = lm_init(cfg, 0, device="cpu")
    return ServingEngine(cfg, serving_config(mode), params=params, n_slots=n_slots,
                         max_len=MAX_LEN, greedy=greedy, spec_hash=spec_hash, shed=shed,
                         device="cpu")


def _prompts(vocab):
    rng = np.random.default_rng(3)
    return [rng.integers(0, vocab, PROMPT + i).tolist() for i in range(N_PROMPTS)]


def get_engine(mode, greedy=True, arch="llama3.2-1b"):
    """Cached (engine, post-submit snapshot, oracle tokens)."""
    key = (mode, greedy, arch)
    if key not in _ENGINES:
        eng = _build_engine(mode, arch=arch, greedy=greedy)
        for i, p in enumerate(_prompts(eng.cfg.vocab)):
            eng.submit_prompt(p, GEN, seed=100 + i)
        snap0 = eng.snapshot()
        out = eng.run()
        oracle = _tokens(out)
        assert all(len(t) == GEN for t in oracle)
        _ENGINES[key] = (eng, snap0, oracle)
    return _ENGINES[key]


def _tokens(out):
    return [r["tokens"] for r in sorted(out["per_request"], key=lambda r: r["rid"])]


def _bits(t) -> bytes:
    t = t.contiguous()
    if t.dtype in (torch.bfloat16, torch.uint32):
        t = t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)
    return t.numpy().tobytes()


# -- snapshot round trip ------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_snapshot_roundtrip_bit_exact(mode, tmp_path):
    """Mid-run snapshot -> .npz -> load: every pool leaf is byte-identical
    in dtype, shape and bits, and the restored engine finishes with the
    oracle's tokens."""
    eng, snap0, oracle = get_engine(mode)
    eng.restore(snap0)
    for _ in range(3):
        eng.step()
    snap = eng.snapshot()
    path = str(tmp_path / "snap.npz")
    save_snapshot(snap, path)
    loaded = load_snapshot(path)
    assert len(snap["backend"]["pool"]) == len(loaded["backend"]["pool"]) > 0
    for a, b in zip(snap["backend"]["pool"], loaded["backend"]["pool"]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _bits(a) == _bits(b)
    assert loaded["spec_hash"] == eng.spec_hash
    assert loaded["kind"] == eng.backend_kind == "monolithic"
    assert loaded["signature"] == eng._signature()
    eng.restore(loaded)
    assert _tokens(eng.run()) == oracle


def test_restore_into_fresh_engine_exact_remaining_tokens():
    """Process death: a cold engine restores a mid-run snapshot and emits
    the exact remaining tokens of every in-flight request."""
    eng, snap0, oracle = get_engine("dense")
    eng.restore(snap0)
    for _ in range(4):
        eng.step()
    snap = eng.snapshot()
    fresh = _build_engine("dense")
    fresh.restore(snap)
    assert fresh.tick == eng.tick and fresh.decode_steps == eng.decode_steps
    assert _tokens(fresh.run()) == oracle


def test_sampled_decode_keys_survive_restore():
    """Sampling seeds and draw indices are part of the snapshot: a sampled
    run restored mid-flight emits the uninterrupted sampled run's tokens,
    which differ from greedy decoding's."""
    eng, snap0, oracle = get_engine("dense", greedy=False)
    eng.restore(snap0)
    for _ in range(3):
        eng.step()
    eng.restore(eng.snapshot())
    assert _tokens(eng.run()) == oracle
    assert oracle != get_engine("dense")[2]


# -- restore refusals: nothing changes before the error -------------------------------


def _state(eng) -> tuple:
    snap = eng.snapshot()
    eng.n_snapshots -= 1
    return (snap["tick"], snap["next_tok"].tolist(), snap["ledger"],
            [_bits(t) for t in snap["backend"]["pool"]], eng.n_slots)


def _refused(eng, bad, match):
    before = _state(eng)
    with pytest.raises(SnapshotError, match=match):
        eng.restore(bad)
    assert _state(eng) == before


def test_restore_under_wrong_spec_hash_rejected():
    eng, snap0, oracle = get_engine("dense")
    eng.restore(snap0)
    eng.step()
    _refused(eng, dict(snap0, spec_hash="0" * 16), "spec_hash")
    # None on either side means "unstamped": restore is allowed
    eng.restore(dict(snap0, spec_hash=None))
    assert _tokens(eng.run()) == oracle


def test_restore_wrong_backend_kind_and_version_rejected():
    eng, snap0, _ = get_engine("dense")
    eng.restore(snap0)
    eng.step()
    _refused(eng, dict(snap0, kind="paged"), "pool")
    _refused(eng, dict(snap0, version=999), "version")
    _refused(eng, {"not": "a snapshot"}, "version")


def test_restore_structural_mismatch_rejected():
    """A signature field, the pool impl (a card snapshot into a CPU engine)
    or the pool's leaves that do not fit: refused, nothing changed."""
    eng, snap0, oracle = get_engine("dense")
    eng.restore(snap0)
    eng.step()
    _refused(eng, dict(snap0, signature=dict(snap0["signature"], max_len=MAX_LEN * 2)),
             "max_len")
    _refused(eng, dict(snap0, signature=dict(snap0["signature"], kv_pack_impl="pallas")),
             "kv_pack_impl")
    pool = snap0["backend"]["pool"]
    _refused(eng, dict(snap0, backend={"pool": pool[:-1]}), "leaves")
    _refused(eng, dict(snap0, backend={"pool": [pool[0], pool[1][:, :, :-1]] + pool[2:]}),
             "shape")
    # a snapshot at another slot count whose pool is still this size
    _refused(eng, dict(snap0, signature=dict(snap0["signature"], n_slots=3)), "shape")
    eng.restore(snap0)
    assert _tokens(eng.run()) == oracle


# -- live rescaling ---------------------------------------------------------------------


def test_rescale_grow_and_shrink_keeps_every_request():
    """Shrink below occupancy (the spill path), then grow: nothing is
    dropped and every token matches the oracle."""
    eng, snap0, oracle = get_engine("quant_sparse")
    eng.restore(snap0)
    for _ in range(2):
        eng.step()
    eng.rescale(1)  # below occupancy: actives spill
    assert eng.sched.n_spills >= 1
    for _ in range(2):
        eng.step()
    eng.rescale(3)
    out = eng.run()
    assert _tokens(out) == oracle
    assert out["elastic"]["n_rescales"] == 2
    assert out["elastic"]["n_resumes"] == out["elastic"]["n_spills"]


def test_spill_payload_is_a_copy_and_resumes_into_another_slot():
    """A spilled slot's payload is a host copy (the release that follows
    zeroes the pool's row, not the payload) and resumes bit-exactly into
    another slot."""
    eng, snap0, oracle = get_engine("quant_sparse")
    eng.restore(snap0)
    eng.step()
    pay_before = [_bits(t) for t in _payload_leaves(eng, 0)]
    eng._spill_slot(0)
    spilled = eng.sched._spilled[0]
    assert [_bits(t) for t in _leaves(spilled.payload["slot_state"])] == pay_before
    assert all(t.device.type == "cpu" for t in _leaves(spilled.payload["slot_state"]))
    assert _tokens(eng.run()) == oracle


def _leaves(tree):
    from repro_torch.serving.kvpool import pool_leaves

    return pool_leaves(tree)


def _payload_leaves(eng, slot):
    from repro_torch.serving.kvpool import extract_slot_packed

    return _leaves(extract_slot_packed(eng.pool, slot))


# -- chaos: failure schedules against the oracle ------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_chaos_fixed_schedule_every_mode(mode, tmp_path):
    """One snapshot / kill / rewind / roundtrip / rescale schedule in every
    numerics mode, bit-identical to the uninterrupted oracle."""
    eng, snap0, oracle = get_engine(mode)
    eng.restore(snap0)
    events = [ChaosEvent(1, "snapshot"), ChaosEvent(2, "kill"),
              ChaosEvent(3, "rewind"), ChaosEvent(4, "roundtrip"),
              ChaosEvent(5, "rescale", slots=3)]
    out = ChaosHarness(eng, events, max_steps=500, tmp_dir=str(tmp_path)).run()
    assert _tokens(out) == oracle
    assert out["finite"]


def test_chaos_kill_into_a_fresh_engine():
    eng, snap0, oracle = get_engine("quant_sparse")
    eng.restore(snap0)
    events = [ChaosEvent(1, "rescale", slots=1), ChaosEvent(2, "kill"),
              ChaosEvent(4, "rescale", slots=2)]
    harness = ChaosHarness(eng, events, make_engine=lambda: _build_engine("quant_sparse"))
    out = harness.run()
    assert harness.engine is not eng
    assert _tokens(out) == oracle
    assert out["elastic"]["n_spills"] >= 1


def test_chaos_num_pages_needs_the_paged_backend():
    eng, snap0, _ = get_engine("dense")
    eng.restore(snap0)
    with pytest.raises(ValueError, match="paged"):
        ChaosHarness(eng, [ChaosEvent(0, "rescale", num_pages=8)]).run()


def _draw_events(data):
    events = []
    for _ in range(data.draw(st.integers(0, 4), label="n_events")):
        at = data.draw(st.integers(0, 12), label="at")
        kind = data.draw(st.sampled_from(ChaosEvent.KINDS), label="kind")
        if kind == "rescale":
            events.append(ChaosEvent(at, kind, slots=data.draw(st.integers(1, 4), label="slots")))
        else:
            events.append(ChaosEvent(at, kind))
    return events


@given(st.data())
def test_chaos_monolithic_matches_oracle(data):
    eng, snap0, oracle = get_engine("quant_sparse")
    eng.restore(snap0)
    out = ChaosHarness(eng, _draw_events(data), max_steps=500).run()
    assert _tokens(out) == oracle
    assert out["finite"]


# -- engine-level shedding + periodic snapshots ------------------------------------------


def test_engine_typed_rejections_no_silent_loss():
    """An overloaded engine completes or typed-rejects every request, and
    the completed ones are unaffected by the shedding around them."""
    eng = _build_engine("dense", n_slots=1, shed=ShedPolicy(max_queue_depth=1))
    for i, p in enumerate(_prompts(eng.cfg.vocab)):
        eng.submit_prompt(p, GEN, seed=100 + i)
    out = eng.run()
    rows = {r["rid"]: r for r in out["per_request"]}
    assert len(rows) == N_PROMPTS
    completed = [r for r in rows.values() if r["status"] == "completed"]
    rejected = [r for r in rows.values() if r["status"] == "rejected"]
    assert len(completed) + len(rejected) == N_PROMPTS
    assert rejected and all(r["rejected"] == REJECT_QUEUE_FULL
                            and r["finished_by"] == "rejected"
                            and r["tokens"] == [] for r in rejected)
    assert out["elastic"]["rejected"] == {REJECT_QUEUE_FULL: len(rejected)}
    oracle = get_engine("dense")[2]
    for r in completed:
        assert r["tokens"] == oracle[r["rid"]]


def test_periodic_snapshots_and_restore_file(tmp_path):
    eng, snap0, oracle = get_engine("dense")
    eng.restore(snap0)
    path = str(tmp_path / "auto.npz")
    eng.snapshot_every, eng.snapshot_path = 2, path
    ticks_before = len(eng.watchdog.events)
    try:
        out = eng.run()
    finally:
        eng.snapshot_every, eng.snapshot_path = 0, ""
    assert _tokens(out) == oracle
    assert out["elastic"]["n_snapshots"] >= 1
    # the watchdog observed every tick of the run
    assert len(eng.watchdog.events) - ticks_before == out["latency"]["ticks"]
    eng.restore_file(path)
    assert _tokens(eng.run()) == oracle


def test_summary_carries_latency_and_elastic_blocks():
    eng, snap0, _ = get_engine("dense")
    eng.restore(snap0)
    out = eng.run()
    assert set(out["latency"]) == {"queue_s", "ttft_s", "token_s", "ticks",
                                   "tick_utilization"}
    assert eng.token_sketch.count > 0 and eng.ttft_sketch.count > 0
    assert set(out["elastic"]) == {"rejected", "n_rejected", "n_spills", "n_resumes",
                                   "n_rescales", "n_snapshots", "n_restores", "slow_ticks"}
    assert all(r["slo_met"] is None for r in out["per_request"])  # no SLO set


# -- mamba2-780m: the dense state leaves ---------------------------------------------------


def test_mamba2_snapshot_roundtrip_and_rescale(tmp_path):
    """The SSM state leaves take the dense branch of the slot payload and
    the snapshot: a file round trip and a rescale below occupancy keep the
    oracle's tokens."""
    eng, snap0, oracle = get_engine("quant_sparse", arch="mamba2-780m")
    assert {"conv", "ssm"} <= set(eng.pool["unit_0"])
    eng.restore(snap0)
    eng.step()
    path = str(tmp_path / "m.npz")
    save_snapshot(eng.snapshot(), path)
    eng.restore(load_snapshot(path))
    eng.step()
    eng.rescale(1)
    assert eng.sched.n_spills >= 1
    eng.step()
    eng.rescale(2)
    assert _tokens(eng.run()) == oracle


# -- the launcher: --snapshot-every, then --restore -----------------------------------------


def test_launcher_snapshot_then_restore_drains_the_same_tokens(tmp_path, capsys):
    """Serve with periodic snapshots, then restore the last one in a new
    launch: the drained run reports the uninterrupted run's tokens, and it
    took no new work."""
    base = ["--reduced", "--device", "cpu", "--slots", "2", "--queue", "3",
            "--prompt-len", "8", "--gen", "5"]
    plain = serve_main(base)
    path = str(tmp_path / "serve.npz")
    periodic = serve_main(base + ["--snapshot-every", "3", "--snapshot-path", path])
    assert _tokens(periodic) == _tokens(plain)
    assert periodic["elastic"]["n_snapshots"] >= 1
    snap = load_snapshot(path)
    assert 0 < snap["tick"] <= periodic["ticks"]
    restored = serve_main(base + ["--restore", path])
    assert _tokens(restored) == _tokens(plain)
    assert restored["elastic"]["n_restores"] == 1
    assert len(restored["per_request"]) == 3
    with pytest.raises(SystemExit, match="restore_path"):
        serve_main(base + ["--restore", path, "--snapshot-every", "2",
                           "--snapshot-path", path])
    # another configuration's stamp: refused
    with pytest.raises(SnapshotError, match="spec_hash"):
        serve_main(base[:-1] + ["6", "--restore", path])
    capsys.readouterr()


def test_decode_reductions_agree_across_batch_sizes_in_the_shipped_form():
    """The probe behind the decode's row-by-row reductions, at the reduced
    widths on the CPU: each op's fixed-row-block form, and the form the
    decode ships, give rows 0-1 the same bits in a batch of 4 as in a batch of 2,
    and so does the whole decode step of both models."""
    from repro_torch.benchmarks.decode_invariance import run_decode, run_ops

    out = run_ops(torch.device("cpu"), reduced=True)
    assert len(out) == 13
    for name, row in out.items():
        assert row["fixed_rows"]["bit_equal"], name
        assert row[row["shipped"]]["bit_equal"], name
    decode = run_decode(torch.device("cpu"), reduced=True)
    assert decode["llama3.2-1b shipped"]["bit_equal"]
    assert decode["mamba2-780m shipped"]["bit_equal"]


# -- the paged backend (the reference's backend="paged" cases) ------------------------------

_PAGED: dict = {}


def _build_paged(mode, *, n_slots=2, spec_hash="feedbeefcafe0123"):
    from repro_torch.serving.paging import PagedServingEngine

    cfg = get_arch("llama3.2-1b").resolve(reduced=True)
    return PagedServingEngine(cfg, serving_config(mode), params=lm_init(cfg, 0, device="cpu"),
                              n_slots=n_slots, max_len=MAX_LEN, spec_hash=spec_hash,
                              page_tokens=8, device="cpu")


def get_paged_engine(mode):
    """Cached (paged engine, post-submit snapshot, oracle tokens); the
    oracle equals the monolithic engine's."""
    if mode not in _PAGED:
        eng = _build_paged(mode)
        for i, p in enumerate(_prompts(eng.cfg.vocab)):
            eng.submit_prompt(p, GEN, seed=100 + i)
        snap0 = eng.snapshot()
        oracle = _tokens(eng.run())
        assert oracle == get_engine(mode)[2]
        _PAGED[mode] = (eng, snap0, oracle)
    return _PAGED[mode]


@pytest.mark.parametrize("mode", MODES)
def test_paged_snapshot_roundtrip_bit_exact(mode, tmp_path):
    """Mid-run paged snapshot -> .npz -> load: every page-store and
    slot-state leaf is byte-identical, and the restored engine finishes
    with the oracle's tokens."""
    eng, snap0, oracle = get_paged_engine(mode)
    eng.restore(snap0)
    for _ in range(3):
        eng.step()
    snap = eng.snapshot()
    path = str(tmp_path / "paged.npz")
    save_snapshot(snap, path)
    loaded = load_snapshot(path)
    for part in ("store", "state"):
        assert len(snap["backend"][part]) == len(loaded["backend"][part]) > 0
        for a, b in zip(snap["backend"][part], loaded["backend"][part]):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert _bits(a) == _bits(b)
    assert loaded["kind"] == eng.backend_kind == "paged"
    assert loaded["signature"] == eng._signature()
    eng.restore(loaded)
    assert _tokens(eng.run()) == oracle


def test_paged_rescale_grow_and_shrink_keeps_every_request():
    eng, snap0, oracle = get_paged_engine("quant_sparse")
    eng.restore(snap0)
    for _ in range(2):
        eng.step()
    eng.rescale(1)  # below occupancy: actives spill
    assert eng.sched.n_spills >= 1
    for _ in range(2):
        eng.step()
    eng.rescale(3, num_pages=12)
    out = eng.run()
    assert _tokens(out) == oracle
    assert out["elastic"]["n_rescales"] == 2
    assert out["elastic"]["n_resumes"] == out["elastic"]["n_spills"]
    assert out["paging"]["num_pages"] == 12


def test_paged_rescale_infeasible_page_budget_rejected():
    eng, snap0, oracle = get_paged_engine("quant_sparse")
    eng.restore(snap0)
    eng.step()
    with pytest.raises(ValueError, match="pages"):
        eng.rescale(num_pages=1)
    # refused before any state changed: the run still completes exactly
    assert _tokens(eng.run()) == oracle


def test_chaos_num_pages_raises_the_reference_message_on_the_monolithic_backend():
    """The reference's refusal (``repro/serving/elastic/chaos.py:125-127``),
    word for word, before any state changes."""
    eng, snap0, oracle = get_engine("dense")
    eng.restore(snap0)
    with pytest.raises(ValueError, match=r"^num_pages rescale needs the paged backend$"):
        ChaosHarness(eng, [ChaosEvent(0, "rescale", num_pages=8)]).run()
    assert eng.n_rescales == 0 and eng.sched.n_spills == 0


@pytest.mark.parametrize("mode", MODES)
def test_paged_chaos_fixed_schedule_every_mode(mode, tmp_path):
    eng, snap0, oracle = get_paged_engine(mode)
    eng.restore(snap0)
    events = [ChaosEvent(1, "snapshot"), ChaosEvent(2, "kill"), ChaosEvent(3, "rewind"),
              ChaosEvent(4, "roundtrip"), ChaosEvent(5, "rescale", slots=3, num_pages=8)]
    out = ChaosHarness(eng, events, max_steps=500, tmp_dir=str(tmp_path)).run()
    assert _tokens(out) == oracle
    assert out["finite"]


@given(st.data())
def test_chaos_paged_matches_oracle(data):
    eng, snap0, oracle = get_paged_engine("quant_sparse")
    eng.restore(snap0)
    events = []
    for _ in range(data.draw(st.integers(0, 4), label="n_events")):
        at = data.draw(st.integers(0, 12), label="at")
        kind = data.draw(st.sampled_from(ChaosEvent.KINDS), label="kind")
        if kind == "rescale":
            events.append(ChaosEvent(at, kind, slots=data.draw(st.integers(1, 4), label="slots"),
                                     num_pages=data.draw(st.sampled_from([None, 8, 12, 16]),
                                                         label="pages")))
        else:
            events.append(ChaosEvent(at, kind))
    out = ChaosHarness(eng, events, max_steps=500).run()
    assert _tokens(out) == oracle
    assert out["finite"]


def _paged_state(eng) -> tuple:
    snap = eng.snapshot()
    eng.n_snapshots -= 1
    b = snap["backend"]
    return (snap["tick"], snap["ledger"], [_bits(t) for t in b["store"] + b["state"]],
            b["alloc"], b["table"], eng.n_slots, eng.admission.num_pages)


def test_paged_restore_refusals_change_nothing():
    """A monolithic snapshot into the paged engine (and the reverse), a
    page store of another geometry, a logical frame count that does not
    fit: refused, nothing changed."""
    eng, snap0, oracle = get_paged_engine("dense")
    mono, mono0, _ = get_engine("dense")
    eng.restore(snap0)
    eng.step()
    before = _paged_state(eng)
    store = snap0["backend"]["store"]
    bad = [dict(snap0, kind="monolithic"),
           dict(snap0, backend=dict(snap0["backend"], store=store[:-1])),
           dict(snap0, backend=dict(snap0["backend"],
                                    store=[store[0][..., :-1]] + store[1:])),
           dict(snap0, backend=dict(snap0["backend"],
                                    alloc=dict(snap0["backend"]["alloc"], capacity=3)))]
    for snap, match in zip(bad, ("pool", "leaves", "shape", "logical frames")):
        with pytest.raises(SnapshotError, match=match):
            eng.restore(snap)
        assert _paged_state(eng) == before
    with pytest.raises(SnapshotError, match="pool"):
        mono.restore(snap0)
    eng.restore(snap0)
    assert _tokens(eng.run()) == oracle
