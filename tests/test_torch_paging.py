"""spring-pages in the port: the twin of ``tests/test_paging.py``, and the
port's paged engine against the reference's.

  * the pure-python layers: the same hypothesis op streams through both
    packages' ``PageAllocator`` and ``BlockTable`` give the same frames,
    refcounts, ``prefix_hits``, ``cow_copies`` and errors; and every
    property test of the reference's file, on the port's classes;
  * admission: the ``20d + 1`` budget, admit implies within budget;
  * the engine: reduced llama3.2-1b with the reference's parameters
    (``convert.params_from_jax``), 4 slots, pool length 38 (not a multiple
    of the 4-token page), 5 requests of 8-11 tokens from
    ``default_rng(3)`` (a twin, a shared 8-token prefix), 8 physical pages
    at overcommit 2 (so one request spills and resumes), 5 tokens each.
    In every numerics mode the port's ``PagedServingEngine`` gives the
    reference's tokens, ``finished_by``, ``finish_tick``, spills,
    resumes, ``prefix_hits``, ``cow_copies`` and page statistics, and
    the port's monolithic engine's tokens.  Greedy nearest-rounding decode
    on the CPU, so every comparison is exact;
  * COW prefix sharing, spill/resume, chunked prefill (greedy and
    sampled), the budget after a spill, double release, the gauges and
    the summary, and the launcher's ``--pages``, each paged run against
    the port's monolithic engine.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.launch.serve import serving_config as jserving_config  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim.optimizers import OptimizerConfig  # noqa: E402
from repro.runtime.train import StepConfig  # noqa: E402
from repro.serving import paging as jpaging  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch.serve import main as serve_main  # noqa: E402
from repro_torch.launch.serve import serve_session, serving_config  # noqa: E402
from repro_torch.serving import paging as tpaging  # noqa: E402
from repro_torch.serving.engine import ServingEngine  # noqa: E402
from repro_torch.serving.kvpool import SlotLedger  # noqa: E402
from repro_torch.serving.paging import (AdmissionController, BlockTable,  # noqa: E402
                                        PageAllocator, PageError, PagedServingEngine,
                                        chain_keys)

pytestmark = pytest.mark.paging

ARCH = "llama3.2-1b"
PROMPT, GEN, MAX_LEN = 8, 5, 38
MODES = ["dense", "quant", "quant_sparse"]
FIELDS = ("tokens", "finished_by", "finish_tick")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the reduced model's ops are too small to gain
    from more, and the suite's other workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# =========================================================================
# allocator and block table: both packages on the same op streams
# =========================================================================

ops_strategy = st.lists(st.tuples(st.integers(0, 2), st.integers(0, 10 ** 6)),
                        min_size=1, max_size=80)


def _allocator_log(pkg, capacity: int, ops) -> list:
    """Every op's result (or its error), the free/allocated counts and
    refcounts after it; frames are picked among all of them, free ones
    too, so double frees and unknown increfs happen."""
    alloc = pkg.PageAllocator(capacity)
    frames = list(range(pkg.PageAllocator.RESERVED, pkg.PageAllocator.RESERVED + capacity))
    log = []
    for op, pick in ops:
        f = frames[pick % len(frames)]
        try:
            out = (alloc.alloc() if op == 0 else alloc.incref(f) if op == 1
                   else alloc.decref(f))
        except pkg.PageError as e:
            out = ("PageError", str(e))
        alloc.check_invariants()
        log.append((out, alloc.n_free, alloc.n_allocated,
                    [alloc.refcount(g) for g in frames]))
    return log


@given(capacity=st.integers(1, 12), ops=ops_strategy)
def test_allocator_streams_match_the_reference(capacity, ops):
    assert _allocator_log(tpaging, capacity, ops) == _allocator_log(jpaging, capacity, ops)


table_ops = st.lists(st.tuples(st.integers(0, 5), st.integers(0, 10 ** 6),
                               st.lists(st.integers(0, 3), min_size=1, max_size=12)),
                     min_size=1, max_size=40)


def _table_log(pkg, pt: int, prefix_cache: bool, ops) -> list:
    """Open a request with a prompt (adopting its plan's hits), write a
    block (``ensure_writable``), grow, truncate, release (twice, too) or
    fork a twin of an open request; the result of every op (or its
    error) and the table's state after it."""
    alloc = pkg.PageAllocator(24)
    table = pkg.BlockTable(alloc, pt, prefix_cache=prefix_cache)
    prompts, log, next_rid = {}, [], 0

    def open_with(toks):
        nonlocal next_rid
        rid, next_rid = next_rid, next_rid + 1
        keys = pkg.chain_keys(toks, pt, len(toks))
        plan = table.plan_prompt(toks, len(toks))
        table.open(rid)
        prompts[rid] = toks
        for b, hit in enumerate(plan):
            if hit is not None:
                table.adopt_block(rid, hit)
            else:
                f = table.append_block(rid)
                table.register(f, keys[b])
        return plan

    for op, pick, toks in ops:
        rids = sorted(table.blocks)
        rid = rids[pick % len(rids)] if rids else None
        try:
            if op == 0 or rid is None:
                out = open_with(toks)
            elif op == 1:
                out = open_with(prompts[rid])  # a twin: every block a hit
            elif op == 2:
                out = (table.ensure_writable(rid, pick % table.n_blocks(rid))
                       if table.n_blocks(rid) else None)
            elif op == 3:
                out = table.grow(rid)
            elif op == 4:
                out = table.truncate(rid, pick % (table.n_blocks(rid) + 1))
            else:
                out = table.release(rid)
                out = (out, table.release(rid))  # the second one raises
        except pkg.PageError as e:
            out = ("PageError", str(e))
        table.check_invariants()
        log.append((out, {r: table.frames_of(r) for r in sorted(table.blocks)},
                    table.prefix_hits, table.cow_copies, sorted(table.shared_frames()),
                    alloc.n_free))
    return log


@given(pt=st.integers(1, 4), prefix_cache=st.booleans(), ops=table_ops)
@settings(max_examples=25)
def test_blocktable_streams_match_the_reference(pt, prefix_cache, ops):
    assert (_table_log(tpaging, pt, prefix_cache, ops)
            == _table_log(jpaging, pt, prefix_cache, ops))


# =========================================================================
# allocator properties — the reference's tests on the port's classes
# =========================================================================


@given(capacity=st.integers(1, 12), ops=ops_strategy)
def test_allocator_stream_no_leaks(capacity, ops):
    """Random alloc/incref/decref streams: conservation holds after every
    op, and draining every reference returns the pool to fully free."""
    alloc = PageAllocator(capacity)
    live = {}  # frame -> model refcount
    for op, pick in ops:
        if op == 0:
            if alloc.n_free:
                f = alloc.alloc()
                assert f not in live and f >= PageAllocator.RESERVED
                live[f] = 1
            else:
                with pytest.raises(PageError, match="out of pages"):
                    alloc.alloc()
        elif live:
            f = sorted(live)[pick % len(live)]
            if op == 1:
                alloc.incref(f)
                live[f] += 1
            else:
                left = alloc.decref(f)
                live[f] -= 1
                assert left == live[f]
                if live[f] == 0:
                    del live[f]
        alloc.check_invariants()
        assert alloc.n_allocated == len(live)
        for f, n in live.items():
            assert alloc.refcount(f) == n
    for f in list(live):
        for _ in range(live[f]):
            alloc.decref(f)
    assert alloc.n_free == capacity and alloc.n_allocated == 0


def test_allocator_errors():
    alloc = PageAllocator(2)
    f = alloc.alloc()
    alloc.decref(f)
    with pytest.raises(PageError, match="double free"):
        alloc.decref(f)
    with pytest.raises(PageError, match="unallocated"):
        alloc.incref(f)
    assert isinstance(PageError("x"), ValueError)  # callers catch ValueError
    with pytest.raises(PageError):
        PageAllocator(0)


def test_allocator_reuses_lowest_frame_deterministically():
    alloc = PageAllocator(4)
    frames = [alloc.alloc() for _ in range(4)]
    alloc.decref(frames[1])
    alloc.decref(frames[0])
    assert alloc.alloc() == frames[0]  # lowest free first, always
    assert alloc.alloc() == frames[1]


tokens_strategy = st.lists(st.integers(0, 7), min_size=1, max_size=24)


@given(a=tokens_strategy, b=tokens_strategy, pt=st.integers(1, 5), m=st.integers(0, 24))
def test_chain_keys_share_exactly_the_common_prefix(a, b, pt, m):
    """Two prompts agreeing on their first m tokens share exactly their
    common full-block keys, and the keys are the reference's."""
    m = min(m, len(a), len(b))
    b = a[:m] + b[m:]
    ka = chain_keys(a, pt, len(a))
    kb = chain_keys(b, pt, len(b))
    for i in range(min(m // pt, len(ka), len(kb))):
        if ka[i][0] == "full" and kb[i][0] == "full":
            assert ka[i] == kb[i]
    if a == b:
        assert ka == kb
    assert all(k[0] in ("full", "partial") for k in ka)
    assert ka == jpaging.chain_keys(a, pt, len(a))


@given(data=st.data())
@settings(max_examples=25)
def test_blocktable_cow_never_aliases_a_written_page(data):
    """After ensure_writable, the returned frame has refcount 1 and is
    referenced by no other request."""
    pt = data.draw(st.integers(1, 4), label="page_tokens")
    alloc = PageAllocator(64)
    table = BlockTable(alloc, pt, prefix_cache=True)
    n_req = data.draw(st.integers(2, 4), label="n_req")
    base = data.draw(st.lists(st.integers(0, 3), min_size=pt, max_size=4 * pt), label="base")
    for rid in range(n_req):
        toks = base if rid % 2 == 0 else data.draw(
            st.lists(st.integers(0, 3), min_size=1, max_size=4 * pt), label=f"toks{rid}")
        keys = chain_keys(toks, pt, len(toks))
        plan = table.plan_prompt(toks, len(toks))
        table.open(rid)
        for b, hit in enumerate(plan):
            if hit is not None:
                table.adopt_block(rid, hit)
            else:
                table.append_block(rid, key=keys[b])
        table.check_invariants()
    writes = data.draw(st.lists(st.integers(0, 10 ** 6), max_size=12), label="writes")
    for pick in writes:
        rid = pick % n_req
        if not table.n_blocks(rid):
            continue
        frame, cow = table.ensure_writable(rid, (pick // n_req) % table.n_blocks(rid))
        assert alloc.refcount(frame) == 1
        for other in range(n_req):
            if other != rid:
                assert frame not in table.frames_of(other)
        table.check_invariants()
    for rid in range(n_req):
        table.release(rid)
    assert alloc.n_allocated == 0 and alloc.n_free == alloc.capacity


def test_blocktable_release_raises_on_double_free():
    alloc = PageAllocator(8)
    table = BlockTable(alloc, 2)
    table.open(7)
    table.append_block(7)
    table.release(7)
    assert alloc.n_allocated == 0
    with pytest.raises(PageError, match="double free"):
        table.release(7)


def test_blocktable_shared_partial_tail_forks_on_write():
    """Identical prompts share even the partial tail block; the first
    decode write forks it (cow) leaving the sharer's page untouched."""
    alloc = PageAllocator(8)
    table = BlockTable(alloc, 4, prefix_cache=True)
    toks = [1, 2, 3, 4, 5, 6]  # full(4) + partial(2)
    keys = chain_keys(toks, 4, len(toks))
    table.open(0)
    for b in range(len(keys)):
        table.append_block(0, key=keys[b])
    plan = table.plan_prompt(toks, len(toks))
    assert plan == table.frames_of(0)
    table.open(1)
    for hit in plan:
        table.adopt_block(1, hit)
    assert table.prefix_hits == 2
    shared_tail = table.frames_of(1)[-1]
    frame, cow = table.ensure_writable(1, 1)
    assert cow and frame != shared_tail
    assert table.frames_of(0)[-1] == shared_tail
    assert table.cow_copies == 1


# =========================================================================
# admission arithmetic
# =========================================================================


def test_admission_budget_is_dense_pages_at_20d_plus_1():
    elems = 320
    adm = AdmissionController(elems, page_mask_bits=elems, num_pages=4)
    assert adm.budget_bits == 4 * elems * 21
    for d in (0.0, 0.25, 0.5, 1.0):
        assert adm.page_bits(d) == pytest.approx(elems * (20 * d + 1))
    assert adm.admits(0.0, 4, 1.0)
    assert not adm.admits(0.0, 5, 1.0)
    assert adm.admits(0.0, 7, 0.5)  # half density admits ~2x the pages
    assert adm.admits_exact(0.0, adm.budget_bits)
    assert not adm.admits_exact(1.0, adm.budget_bits)
    assert adm.over_budget(adm.budget_bits + 1)
    assert adm.utilization(adm.budget_bits) == pytest.approx(1.0)
    with pytest.raises(ValueError, match="num_pages"):
        AdmissionController(elems, elems, 0)


@given(live=st.floats(0, 1e9), n=st.integers(0, 64), d=st.floats(0.05, 1.0))
def test_admission_admit_implies_within_budget(live, n, d):
    adm = AdmissionController(256, page_mask_bits=256, num_pages=8)
    ref = jpaging.AdmissionController(256, page_mask_bits=256, num_pages=8)
    assert adm.admits(live, n, d) == ref.admits(live, n, d)
    if adm.admits(live, n, d):
        assert adm.projected_bits(live, n, d) <= adm.budget_bits
        if n:
            assert adm.projected_bits(live, n + 1, d) > adm.projected_bits(live, n, d)


def test_slot_ledger_double_release_raises():
    led = SlotLedger(2)
    led.install(0)
    led.release(0)
    with pytest.raises(ValueError, match="double release"):
        led.release(0)
    with pytest.raises(ValueError, match="not installed"):
        led.release(1)
    led.install(0)
    with pytest.raises(ValueError, match="already installed"):
        led.install(0)
    with pytest.raises(ValueError, match="out of range"):
        led.install(2)


# =========================================================================
# the engine: the port against the reference, and paged = monolithic
# =========================================================================


@pytest.fixture(scope="module")
def model():
    jview = jget_arch(ARCH).view(reduced=True)
    cfg = get_arch(ARCH).resolve(reduced=True)
    jparams = jlm.lm_init(jax.random.PRNGKey(0), jview.config)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, PROMPT + i).tolist() for i in range(4)]
    p = prompts[3]  # 11 tokens: full pages and a partial tail at 4 tokens a page
    shared = [p, list(p), p[:8] + [5, 9], prompts[0], prompts[1]]
    return jview, jparams, cfg, params, prompts, shared


#: the parity geometry: pool length 38 (not a multiple of the page), 8
#: physical pages at overcommit 2 (one request spills and resumes)
PARITY = dict(n_slots=4, max_len=MAX_LEN, page_tokens=4, num_pages=8, overcommit=2.0)


def _submit_run(eng, prompts, gen=GEN):
    for i, p in enumerate(prompts):
        eng.submit_prompt(p, gen, seed=100 + i)
    out = eng.run()
    return [r["tokens"] for r in out["per_request"]], out, eng


def _run_mono(model, prompts, gen=GEN, n_slots=4, mode="quant_sparse", **kw):
    cfg, params = model[2], model[3]
    eng = ServingEngine(cfg, serving_config(mode), params=params, n_slots=n_slots,
                        max_len=MAX_LEN, device="cpu", **kw)
    return _submit_run(eng, prompts, gen)


def _run_paged(model, prompts, gen=GEN, n_slots=4, mode="quant_sparse", **kw):
    cfg, params = model[2], model[3]
    kw.setdefault("max_len", MAX_LEN)
    eng = PagedServingEngine(cfg, serving_config(mode), params=params, n_slots=n_slots,
                             device="cpu", **kw)
    return _submit_run(eng, prompts, gen)


@pytest.mark.parametrize("mode", MODES)
def test_paged_engine_matches_the_reference_engine(model, mode):
    jview, jparams, cfg, params, _, shared = model
    step_cfg = StepConfig(spring=jserving_config(mode), optimizer=OptimizerConfig())
    _, want, _ = _submit_run(jpaging.PagedServingEngine(jview, step_cfg, params=jparams,
                                                        **PARITY), shared)
    _, got, eng = _run_paged(model, shared, mode=mode, **PARITY)
    for w, g in zip(want["per_request"], got["per_request"]):
        assert {f: g[f] for f in FIELDS} == {f: w[f] for f in FIELDS}, g["rid"]
    assert got["paging"] == want["paging"]
    assert got["paging"]["spills"] >= 1 and got["paging"]["resumes"] == got["paging"]["spills"]
    assert got["paging"]["prefix_hits"] >= 3 and got["paging"]["cow_copies"] >= 1
    for key in ("n_spills", "n_resumes", "n_rejected"):
        assert got["elastic"][key] == want["elastic"][key], key
    for key in ("kv_wire_bytes", "kv_nnz", "kv_density", "peak_kv_wire_bytes",
                "kv_mean_wire_bytes", "peak_active", "decode_steps"):
        assert got[key] == want[key], key
    assert got["latency"]["ticks"] == want["latency"]["ticks"]
    mono, _, _ = _run_mono(model, shared, mode=mode, n_slots=4)
    assert [r["tokens"] for r in got["per_request"]] == mono
    assert eng.alloc.n_allocated == 0


@pytest.mark.parametrize("mode", MODES)
def test_paged_serve_session_matches_monolithic(mode):
    """serve_session(pages=True) serves the monolithic engine's tokens in
    every numerics mode, with 2 slots forcing mid-flight joins."""
    kw = dict(reduced=True, mode=mode, slots=2, queue=3, prompt_len=PROMPT, gen=GEN,
              device="cpu")
    mono = serve_session(ARCH, **kw)
    paged = serve_session(ARCH, pages=True, **kw)
    assert [r["tokens"] for r in paged["per_request"]] == \
        [r["tokens"] for r in mono["per_request"]]
    assert paged["finite"]
    assert paged["paging"]["num_pages"] >= 1


def test_cow_prefix_sharing_is_bit_identical(model):
    """>= 2 in-flight requests sharing a prompt prefix through COW pages
    emit exactly the monolithic pool's tokens, prefix cache on or off."""
    shared = model[5][:4]
    mono, _, _ = _run_mono(model, shared)
    on, out_on, eng_on = _run_paged(model, shared, page_tokens=4, prefix_cache=True)
    off, _, _ = _run_paged(model, shared, page_tokens=4, prefix_cache=False)
    assert on == mono
    assert off == mono
    pg = out_on["paging"]
    assert pg["prefix_hits"] >= 3
    assert pg["cow_copies"] >= 1
    assert pg["prefix_cache"] is True
    assert eng_on.alloc.n_allocated == 0


def test_spill_resume_is_bit_identical(model):
    prompts = model[4]
    mono, _, _ = _run_mono(model, prompts)
    paged, out, eng = _run_paged(model, prompts, page_tokens=4, num_pages=8, overcommit=2.0)
    assert paged == mono
    pg = out["paging"]
    assert pg["spills"] >= 1, "config did not exercise the spill path"
    assert pg["resumes"] == pg["spills"]
    assert eng.alloc.n_allocated == 0


def test_chunked_prefill_parity_greedy_and_sampled(model):
    """prefill_chunk=1 staggers prompt page installs across ticks while
    earlier residents keep decoding; tokens stay identical, greedy and
    sampled."""
    prompts = model[4]
    for greedy in (True, False):
        mono, _, _ = _run_mono(model, prompts, n_slots=2, greedy=greedy)
        paged, out, _ = _run_paged(model, prompts, n_slots=2, greedy=greedy, page_tokens=4,
                                   prefill_chunk=1)
        assert paged == mono, f"greedy={greedy}"
        assert out["finite"]


def test_admission_never_exceeds_budget_after_spill(model):
    cfg, params, prompts = model[2], model[3], model[4]
    eng = PagedServingEngine(cfg, serving_config("quant_sparse"), params=params, n_slots=4,
                             max_len=MAX_LEN, page_tokens=4, num_pages=8, overcommit=2.0,
                             device="cpu")
    for i, p in enumerate(prompts):
        eng.submit_prompt(p, GEN, seed=100 + i)
    while eng.sched.has_work():
        eng.step()  # runs the allocator's and the table's invariants
        assert (not eng.admission.over_budget(eng._live_bits)
                or len(eng._resident_order) <= 1)
        assert eng.alloc.n_allocated <= eng.alloc.capacity
    assert eng.summary()["paging"]["spills"] >= 1
    assert eng.alloc.n_allocated == 0


def test_engine_release_slot_double_release_raises(model):
    prompts = model[4]
    _, mono_out, mono_eng = _run_mono(model, prompts[:1], gen=2, n_slots=2)
    with pytest.raises(ValueError, match="double release|not installed"):
        mono_eng.release_slot(0)
    _, out, eng = _run_paged(model, prompts[:1], gen=2, n_slots=2)
    with pytest.raises(ValueError, match="double release|not installed"):
        eng.release_slot(0)
    assert mono_out["finite"] and out["finite"]


def test_paged_gauges_and_summary(model):
    from repro_torch import telemetry

    prompts = model[4]
    with telemetry.scope(telemetry.TelemetryConfig(enabled=True)):
        _, out, _ = _run_paged(model, prompts[:2], n_slots=2, page_tokens=4)
        m = telemetry.metrics()
        for g in ("spring_pages_allocated", "spring_pages_free", "spring_pages_utilization",
                  "spring_pages_shared", "spring_pages_prefix_hits_total",
                  "spring_pages_cow_copies_total", "spring_pages_spills_total"):
            assert m.get(g) is not None, g
    pg = out["paging"]
    for k in ("page_tokens", "num_pages", "logical_frames", "overcommit", "max_blocks",
              "peak_active", "prefix_hits", "cow_copies", "spills", "resumes",
              "budget_bits", "peak_page_utilization", "page_utilization"):
        assert k in pg, k
    assert pg["logical_frames"] >= pg["num_pages"]
    assert 0.0 <= pg["peak_page_utilization"] <= 1.0 + 1e-9


def test_paged_engine_refuses_a_model_without_pageable_leaves():
    """mamba2-780m keeps O(1) state and no token-indexed KV: the paged
    engine refuses it, as the reference's store does."""
    cfg = get_arch("mamba2-780m").resolve(reduced=True)
    with pytest.raises(ValueError, match="pageable"):
        PagedServingEngine(cfg, serving_config("quant_sparse"), n_slots=2, max_len=32,
                           device="cpu")


def test_launcher_pages_prints_the_paging_line(capsys):
    out = serve_main(["--reduced", "--device", "cpu", "--pages", "--queue", "3",
                      "--prompt-len", "8", "--gen", "4", "--page-tokens", "4"])
    lines = capsys.readouterr().out.strip().splitlines()
    paging = [line for line in lines if line.startswith("paging: ")]
    assert len(paging) == 1 and "x 4 tok" in paging[0]
    assert out["paging"]["page_tokens"] == 4 and out["paging"]["prefix_cache"] is True
    off = serve_main(["--reduced", "--device", "cpu", "--pages", "--queue", "3",
                      "--prompt-len", "8", "--gen", "4", "--prefix-cache", "off"])
    assert off["paging"]["prefix_cache"] is False
    assert [r["tokens"] for r in off["per_request"]] == [r["tokens"] for r in out["per_request"]]
    capsys.readouterr()


def test_dense_install_matches_the_reference():
    """``kvpool.install_prefill`` on a dense pool tree (the paged engine's
    slot state holds one, with ``None`` holes) gives the reference's
    leaves."""
    from repro.serving import kvpool as jkvpool

    from repro_torch.serving import kvpool

    rng = np.random.default_rng(0)
    k = rng.standard_normal((3, 1, 5, 2, 4)).astype(np.float32)
    pcache = {"unit_0": {"k": k, "conv": rng.standard_normal((3, 1, 6)).astype(np.float32)}}
    tree = {"pos": np.zeros((4,), np.int32),
            "unit_0": {"k": np.zeros((3, 4, 9, 2, 4), np.float32),
                       "conv": np.zeros((3, 4, 6), np.float32)}}
    want = jkvpool.install_prefill(jax.tree_util.tree_map(jax.numpy.asarray, tree),
                                   jax.tree_util.tree_map(jax.numpy.asarray, pcache), 2, 5)
    got = kvpool.install_prefill(
        {"pos": torch.zeros(4, dtype=torch.int64),
         "unit_0": {n: torch.from_numpy(v.copy()) for n, v in tree["unit_0"].items()}},
        {"unit_0": {n: torch.from_numpy(v) for n, v in pcache["unit_0"].items()}}, 2, 5)
    assert got["pos"].tolist() == np.asarray(want["pos"]).tolist()
    for n in ("k", "conv"):
        np.testing.assert_array_equal(got["unit_0"][n].numpy(), np.asarray(want["unit_0"][n]))
    holes = {"pos": torch.zeros(2, dtype=torch.int64), "unit_0": {"k": None, "v": None}}
    assert kvpool.install_prefill(holes, {}, 1, 7)["pos"].tolist() == [0, 7]
