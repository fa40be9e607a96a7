"""ServingEngine: continuous batching over a fixed slot pool (port of
``repro/serving/engine.py``, its monolithic backend).

One engine owns a :class:`SlotScheduler` (FCFS admission, mid-flight
join and retire, spill and resume) and a packed :mod:`kvpool`.  Each tick
sheds expired requests, resumes spilled requests and admits queued ones
into free slots (batch-1 prefill, then the slot's KV is packed into the
pool) and runs one pooled decode step: unpack the pool, decode every slot,
keep the updates of active slots, repack.  On the card every projection is
a ``masked_matmul`` kernel launch, every pack a ``mask_pack`` launch,
every prefill attention a ``flash_attention`` launch and every prefill SSM
mixer an ``ssd_scan`` launch.  The models are llama3.2-1b (attention,
packed k/v) and mamba2-780m (SSM, whose O(1) state leaves the pool keeps
dense).

Serving numerics: quantized modes round to nearest, so a request's tokens
are a function of the request alone, never of its batch co-tenants.
Token accounting is the reference's: the prefill's token is fed as the
first decode input (not reported), every decode step emits one reported
token, ``max_tokens`` bounds them and EOS is included.

Sampled decode (``greedy=False``): the reference draws
``jax.random.categorical(fold_in(PRNGKey(seed), draw_idx), logits)``,
whose threefry stream the port does not reproduce.  Here each draw comes
from its own ``torch.Generator`` seeded by a pure function of the
request's ``seed`` and the draw index (0 the fed prefill token, 1.. the
decode emissions), on the host, by inverse CDF over the float64 softmax
of the row's logits.  A token is then a function of the request and its
logits alone: the same with any co-tenants, in any slot, and again after
a rewind, a restart or a resume.  It is held statistically against the
softmax.  The card's logits differ from the CPU's in their last bits, so
a request's sampled tokens may differ between the two devices.

Load shedding follows the reference: with a :class:`ShedPolicy` a request
arriving at a full queue is rejected at submit (``"queue_full"``) and a
request still queued past its admission deadline is shed at the top of a
tick (``"deadline"``).

spring-survive (the reference's DESIGN.md §13): :meth:`rescale` resizes
the pool of a live engine (every active request spills its exact packed
bits to the host and resumes on later ticks); :meth:`snapshot` /
:meth:`restore` / :meth:`save_snapshot` / :meth:`restore_file` capture and
restore the engine's whole state bit-exactly (``serving/elastic``), and
with ``snapshot_every=N`` :meth:`run` writes one every N ticks.  Telemetry:
three latency sketches (queue wait, TTFT, per-token) always on, a
straggler watchdog timing every tick, and, inside a ``telemetry.scope``,
the reference's ``serve.tick.*`` spans and ``spring_serve_*`` metrics.
Spans close where the engine waits for the device (the decode's copy of
its tokens to the host, the end of an install or a resume), so on the
card they measure the work, not its issue.

Not ported: the paged pool (``serving/paging``) and the RunSpec
constructor ``from_spec``.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.runtime.resilience import StragglerWatchdog
from repro_torch.serving import kvpool
from repro_torch.serving.request import Request, RequestResult
from repro_torch.serving.scheduler import ShedPolicy, SlotScheduler
from repro_torch.serving.steps import make_decode_step, make_prefill_step
from repro_torch.telemetry.sketch import QuantileSketch

_MASK64 = (1 << 64) - 1


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (no silent
    move to the CPU: the caller asks for the CPU explicitly)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port serves on the GPU by default "
            "(pass device='cpu' to run the plain versions on the CPU)")
    return device


def _on(actual: torch.device, wanted: torch.device) -> bool:
    """Is ``actual`` the device ``wanted`` names (``cuda`` is the current
    card, as tensors made on it report ``cuda:<index>``)?"""
    if actual.type != wanted.type:
        return False
    if wanted.type != "cuda":
        return True
    return actual.index == (torch.cuda.current_device() if wanted.index is None
                            else wanted.index)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def draw_seed(seed: int, draw_idx: int) -> int:
    """The generator seed of a request's ``draw_idx``-th draw: splitmix64 of
    the pair, a pure function (no stream is shared across draws)."""
    z = ((int(seed) & 0xFFFFFFFF) << 32 | (int(draw_idx) & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15
    z &= _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & ((1 << 63) - 1)


def sample_token(row_logits: torch.Tensor, seed: int, draw_idx: int) -> int:
    """One categorical draw from ``softmax(row_logits)``: a float64 uniform
    from the draw's own generator, inverted through the float64 CDF."""
    probs = torch.softmax(row_logits.detach().to("cpu", torch.float64), dim=-1)
    cdf = torch.cumsum(probs, dim=-1)
    gen = torch.Generator().manual_seed(draw_seed(seed, draw_idx))
    u = torch.rand((), generator=gen, dtype=torch.float64) * cdf[-1]
    return min(int(torch.searchsorted(cdf, u, right=True)), probs.numel() - 1)


class ServingEngine:
    """Continuous-batching engine for the ported decoder-only LMs.

    ``cfg`` is an ``LMConfig``; ``spring`` the serving ``SpringConfig``
    (``launch.serve.serving_config``).  ``params`` default to
    ``lm_init(cfg, seed)`` on ``device``.  ``shed`` is the scheduler's
    load-shedding policy (None: plain FCFS, nothing is shed).
    ``spec_hash`` stamps snapshots (a restore under another hash is
    refused); ``snapshot_every`` / ``snapshot_path`` make :meth:`run`
    write one every N ticks.
    """

    #: snapshot/restore artifact tag — snapshots from one pool backend
    #: never restore into the other (the packed layouts differ)
    backend_kind = "monolithic"

    def __init__(self, cfg, spring, *, params: Optional[dict] = None, n_slots: int = 4,
                 max_len: int = 256, greedy: bool = True, seed: int = 0,
                 spec_hash: Optional[str] = None, shed: Optional[ShedPolicy] = None,
                 snapshot_every: int = 0, snapshot_path: str = "",
                 watchdog: Optional[StragglerWatchdog] = None, device="cuda"):
        self.device = resolve_device(device)
        cfg.check_supported()
        self.cfg = cfg
        self.spring = spring
        self.greedy = greedy
        self.n_slots = n_slots
        self.max_len = max_len
        self.spec_hash = spec_hash
        self.shed_policy = shed
        self.snapshot_every = int(snapshot_every)
        self.snapshot_path = snapshot_path
        # serving ticks are bimodal (prefill ticks dwarf decode ticks), so
        # the threshold is loose and the first ticks are warm-up
        self.watchdog = watchdog if watchdog is not None else (
            StragglerWatchdog(threshold=4.0, warmup_steps=5))
        if params is None:
            from repro_torch.models.lm import lm_init

            params = lm_init(cfg, seed, device=self.device)
        elif not _on(params["embed"]["embedding"].device, self.device):
            raise ValueError(f"params live on {params['embed']['embedding'].device}, "
                             f"engine on {self.device}")
        self.params = params
        # what the pool's pack and unpack dispatch to; a snapshot restores
        # only where they are the same, as the reference's records its impls
        self._kv_pack_impl = self._kv_unpack_impl = (
            "cuda" if self.device.type == "cuda" else "plain")

        self.sched = SlotScheduler(n_slots, policy=shed)
        self._ledger = kvpool.SlotLedger(n_slots)
        self._next_tok = np.zeros((n_slots,), np.int64)
        self._results: dict[int, RequestResult] = {}
        self._requests: dict[int, Request] = {}
        self._next_rid = 0
        self._t0 = time.monotonic()

        self._prefill = make_prefill_step(cfg, spring)
        self._decode = make_decode_step(cfg, spring)
        self._build_pool()

        self.decode_steps = 0
        self.tick = 0  # scheduler ticks (every step() call, admit-only ones too)
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.occupancy_sum = 0.0
        self.tokens_emitted = 0
        self.peak_kv_wire_bytes = 0.0
        self._peak_stats: Optional[dict] = None
        self._wire_bytes_sum = 0.0
        self._density_sum = 0.0
        self.finite = True
        # latency attribution: mergeable quantile sketches, always on
        self.queue_sketch = QuantileSketch()
        self.ttft_sketch = QuantileSketch()
        self.token_sketch = QuantileSketch()
        self.peak_active = 0
        # spring-survive counters
        self.n_rejected: dict = {}  # reason -> count
        self.n_rescales = 0
        self.n_snapshots = 0
        self.n_restores = 0
        self.slow_ticks = 0

    def _build_pool(self) -> None:
        self.pool = kvpool.init_pool(self.cfg, self.n_slots, self.max_len, device=self.device)

    # -- submission ---------------------------------------------------------

    def _now(self) -> float:
        return time.monotonic() - self._t0

    def submit(self, req: Request) -> int:
        if len(req.prompt) + req.max_tokens + 1 > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + max_tokens "
                f"{req.max_tokens} + 1 exceeds pool max_len {self.max_len}")
        self._requests[req.rid] = req
        self._results[req.rid] = RequestResult(rid=req.rid, tokens=[],
                                               submit_s=self._now(),
                                               enqueue_tick=self.tick)
        reason = self.sched.submit(req, tick=self.tick)
        if reason is not None:
            self._reject(req.rid, reason)
        return req.rid

    def _reject(self, rid: int, reason: str) -> None:
        """Record a typed rejection: the request is finished, carries no
        tokens, and its result says why."""
        res = self._results[rid]
        res.rejected = reason
        res.finished_by = "rejected"
        res.done_s = self._now()
        res.finish_tick = self.tick
        self.n_rejected[reason] = self.n_rejected.get(reason, 0) + 1
        if telemetry.enabled():
            telemetry.metrics().inc("spring_serve_shed_total", 1,
                                    help="requests shed with a typed rejection reason")

    def submit_prompt(self, prompt, max_tokens: int, **kw) -> int:
        rid = self._next_rid
        self._next_rid = rid + 1
        return self.submit(Request(rid=rid, prompt=tuple(int(t) for t in prompt),
                                   max_tokens=max_tokens, **kw))

    # -- one scheduler tick: admissions + one pooled decode step ------------

    def _sample(self, tracker, row_logits: torch.Tensor, draw_idx: int) -> int:
        """``draw_idx`` counts the request's draws (0 = the fed prefill
        token, 1.. = decode emissions) so no two draws share a seed."""
        if self.greedy:
            return int(torch.argmax(row_logits))
        return sample_token(row_logits, tracker.req.seed, draw_idx)

    def release_slot(self, slot: int) -> None:
        """Free one installed slot (a double release raises in the ledger
        before the pool is touched)."""
        self._ledger.release(slot)
        kvpool.release_packed(self.pool, slot)

    def step(self) -> None:
        self.watchdog.step_start()
        with telemetry.span("serve.tick", tick=self.tick):
            self._step_body()
        self.tick += 1
        ev = self.watchdog.step_end(self.tick)
        if ev.slow:
            self.slow_ticks += 1
        if telemetry.enabled():
            m = telemetry.metrics()
            m.set("spring_serve_tick_ewma_s", ev.ewma,
                  help="EWMA of serving-tick wall seconds (watchdog)")
            if ev.slow:
                m.inc("spring_serve_slow_ticks_total", 1,
                      help="serving ticks the straggler watchdog flagged")

    def _step_body(self) -> None:
        self._admit_phase()
        self.peak_active = max(self.peak_active, len(self.sched.active))
        slots = sorted(self.sched.active)
        if not slots:
            return
        logits, host, step_s = self._dispatch_decode(slots)
        self.decode_s += step_s
        self.decode_steps += 1
        self.occupancy_sum += len(slots) / self.n_slots
        self.finite &= bool(torch.isfinite(logits[torch.as_tensor(slots)]).all())

        with telemetry.span("serve.tick.sample", active=len(slots)):
            token_by_slot = {}
            for slot in slots:
                tracker = self.sched.active[slot]
                tok = (int(host[slot]) if self.greedy
                       else self._sample(tracker, host[slot], len(tracker.tokens) + 1))
                token_by_slot[slot] = tok
                self._next_tok[slot] = tok
                res = self._results[tracker.req.rid]
                if not tracker.tokens:
                    res.first_token_s = self._now()
                    res.first_token_tick = self.tick
                    self.ttft_sketch.add(res.first_token_s - res.submit_s)
                # every decoded request got one token this tick: the tick's
                # decode wall time is its per-token latency
                self.token_sketch.add(step_s)
        with telemetry.span("serve.tick.repack"):
            for tracker in self.sched.record_tokens(token_by_slot):
                res = self._results[tracker.req.rid]
                res.tokens = list(tracker.tokens)
                res.done_s = self._now()
                res.finish_tick = self.tick
                res.finished_by = tracker.finished_by
                self.tokens_emitted += len(tracker.tokens)
                self.release_slot(tracker.slot)
            stats = kvpool.pool_wire_stats(self.pool)
        if stats["kv_wire_bytes"] >= self.peak_kv_wire_bytes:
            self.peak_kv_wire_bytes = stats["kv_wire_bytes"]
            self._peak_stats = stats
        self._wire_bytes_sum += stats["kv_wire_bytes"]
        self._density_sum += stats["kv_density"]
        if telemetry.enabled():
            m = telemetry.metrics()
            m.set("spring_serve_tick_utilization", len(slots) / self.n_slots,
                  help="active slots / pool slots at the last decode tick")
            m.set("spring_serve_kv_pool_density", stats["kv_density"],
                  help="measured KV-pool density at the last decode tick")
            m.set("spring_serve_kv_pool_wire_bytes", stats["kv_wire_bytes"],
                  help="packed KV-pool wire bytes at the last decode tick")
            m.inc("spring_serve_tokens_total", len(slots), help="decode tokens emitted")
            m.observe("spring_serve_decode_step_s", step_s, help="decode-step wall seconds")

    def _admit_phase(self) -> None:
        self._shed_phase()
        with telemetry.span("serve.tick.schedule"):
            admitted = self.sched.admit_gated(self._can_resume, self._can_admit)
        for tracker, spilled in admitted:
            if spilled is not None:
                self._resume_one(tracker, spilled)
            else:
                self._admit_one(tracker)

    def _shed_phase(self) -> None:
        """Expire queued requests whose admission deadline passed."""
        for req, reason in self.sched.shed_expired(self.tick):
            self._reject(req.rid, reason)

    def _can_admit(self, req) -> bool:
        """Admission gate: the monolithic pool has room for any request
        that gets a free slot (the paged backend projects page budgets)."""
        return True

    def _can_resume(self, spilled) -> bool:
        return True

    def _admit_one(self, tracker) -> None:
        req = tracker.req
        t0 = time.monotonic()
        with telemetry.span("serve.tick.prefill", rid=req.rid, prompt_len=len(req.prompt)):
            tokens = torch.tensor([req.prompt], dtype=torch.int64, device=self.device)
            logits, pcache = self._prefill(self.params, tokens)
        with telemetry.span("serve.tick.install", rid=req.rid, slot=tracker.slot):
            self._ledger.install(tracker.slot)
            kvpool.install_packed(self.pool, pcache, tracker.slot, len(req.prompt))
            _sync(self.device)
        self.prefill_s += time.monotonic() - t0
        # the prefill token is fed, not reported (static-path contract)
        self._next_tok[tracker.slot] = self._sample(tracker, logits[0], 0)
        self.finite &= bool(torch.isfinite(logits).all())
        res = self._results[req.rid]
        res.admit_s = self._now()
        res.slot = tracker.slot
        self.queue_sketch.add(res.queue_s)

    def _dispatch_decode(self, slots: list) -> tuple:
        """One pooled decode step over ``slots``; returns ``(logits, host,
        step_s)``: ``host`` is the argmax per slot (greedy) or the logits,
        on the CPU — copying it there is where the step waits for the
        device, so the span and ``step_s`` cover the device's work."""
        active = np.zeros((self.n_slots,), bool)
        active[slots] = True
        active_t = torch.as_tensor(active, device=self.device)
        tokens = torch.as_tensor(self._next_tok, device=self.device)
        _sync(self.device)
        t0 = time.monotonic()
        with telemetry.span("serve.tick.decode", active=len(slots)):
            cache = kvpool.unpack_cache(self.pool)
            logits, new_cache = self._decode(self.params, tokens, cache)
            self.pool = kvpool.pack_cache(kvpool.merge_active(new_cache, cache, active_t))
            host = (logits.argmax(dim=-1) if self.greedy else logits).cpu()
        return logits, host, time.monotonic() - t0

    # -- spill / resume ------------------------------------------------------

    def _spill_slot(self, slot: int) -> None:
        """Preempt the request in ``slot``: its exact packed pool bits move
        to host memory, the slot frees, the request parks in the
        scheduler's resume queue."""
        tracker = self.sched.active[slot]
        with telemetry.span("serve.tick.spill", rid=tracker.req.rid, slot=slot):
            payload = {"slot_state": kvpool.extract_slot_packed(self.pool, slot),
                       "next_tok": int(self._next_tok[slot])}
            self._ledger.release(slot)
            kvpool.release_packed(self.pool, slot)
            self._next_tok[slot] = 0
            self.sched.preempt(slot, payload)

    def _resume_one(self, tracker, spilled) -> None:
        """Write a spilled request's exact packed bits into its new slot:
        nothing is recomputed, so resuming is bit-identical."""
        slot, pay = tracker.slot, spilled.payload
        with telemetry.span("serve.tick.resume", rid=tracker.req.rid, slot=slot):
            self._ledger.install(slot)
            kvpool.restore_slot_packed(self.pool, pay["slot_state"], slot)
            _sync(self.device)
        self._next_tok[slot] = pay["next_tok"]
        self._results[tracker.req.rid].slot = slot

    # -- elastic: rescale / snapshot / restore ---------------------------------

    def rescale(self, slots: Optional[int] = None) -> None:
        """Resize the slot pool of a live engine without dropping work:
        every active request spills (exact packed bits), the pool is
        rebuilt at the new size, and the resume queue drains back in on
        the following ticks — highest priority first, so shrinking below
        occupancy leaves exactly the lowest-priority requests parked."""
        new = self.n_slots if slots is None else int(slots)
        if new < 1:
            raise ValueError(f"rescale: slots must be >= 1, got {new}")
        with telemetry.span("serve.rescale", slots=new):
            for slot in sorted(self.sched.active):
                self._spill_slot(slot)
            self.sched.rescale(new)
            self.n_slots = new
            self._ledger = kvpool.SlotLedger(new)
            self._next_tok = np.zeros((new,), np.int64)
            self._build_pool()
        self.n_rescales += 1

    def _signature(self) -> dict:
        """Structural identity a snapshot must match to restore (``n_slots``
        is adapted by rebuilding the pool instead)."""
        return {
            "n_slots": self.n_slots, "max_len": self.max_len,
            "greedy": self.greedy,
            "kv_pack_impl": self._kv_pack_impl,
            "kv_unpack_impl": self._kv_unpack_impl,
            "vocab": int(self.cfg.vocab), "d_model": int(self.cfg.d_model),
        }

    def _check_backend(self, sig: dict, b: dict) -> None:
        """Refuse a snapshot's pool leaves that do not fit this engine's
        pool at the snapshot's slot count (before any state changes)."""
        from repro_torch.serving.elastic.snapshot import check_leaves

        check_leaves(kvpool.pool_shapes(self.pool, int(sig["n_slots"])), b["pool"], "kv pool")

    def _reconfigure(self, sig: dict) -> None:
        """Adapt the pool to a snapshot taken at another size."""
        new = int(sig["n_slots"])
        if new != self.n_slots:
            self.n_slots = new
            self._build_pool()

    def _snapshot_backend(self) -> dict:
        from repro_torch.serving.elastic.snapshot import tree_to_host_leaves

        return {"pool": tree_to_host_leaves(self.pool)}

    def _restore_backend(self, b: dict) -> None:
        from repro_torch.serving.elastic.snapshot import leaves_to_tree

        self.pool = leaves_to_tree(self.pool, b["pool"], "kv pool")

    def snapshot(self) -> dict:
        """Full engine state as one host tree (``serving/elastic/snapshot.py``
        has the format)."""
        from repro_torch.serving import elastic

        snap = elastic.build_snapshot(self)
        self.n_snapshots += 1
        if telemetry.enabled():
            telemetry.metrics().inc("spring_serve_snapshots_total", 1,
                                    help="engine snapshots taken")
        return snap

    def restore(self, snap: dict) -> None:
        """Restore this engine to a snapshot's exact state; it then emits
        the exact remaining tokens of every in-flight request.  Raises
        :class:`~repro_torch.serving.elastic.SnapshotError` on a version,
        kind, spec-hash, signature or pool-structure mismatch, before any
        state changes."""
        from repro_torch.serving import elastic

        elastic.apply_snapshot(self, snap)
        self.n_restores += 1
        if telemetry.enabled():
            telemetry.metrics().inc("spring_serve_restores_total", 1,
                                    help="engine restores applied")

    def save_snapshot(self, path: Optional[str] = None) -> str:
        from repro_torch.serving import elastic

        return elastic.save_snapshot(self.snapshot(),
                                     path or self.snapshot_path or "spring_snapshot.npz")

    def restore_file(self, path: str) -> None:
        from repro_torch.serving import elastic

        self.restore(elastic.load_snapshot(path))

    def run(self) -> dict:
        """Drain the queue; returns :meth:`summary`.  With
        ``snapshot_every`` set, a restartable snapshot lands on disk every
        N ticks (crash recovery: ``restore_file`` + ``run`` again)."""
        while self.sched.has_work():
            self.step()
            self.sched.check_invariants()
            if self.snapshot_every > 0 and self.tick % self.snapshot_every == 0:
                self.save_snapshot()
        return self.summary()

    # -- metrics ------------------------------------------------------------

    def summary(self) -> dict:
        results = [self._results[r] for r in sorted(self._results)]
        # headline KV numbers at peak wire occupancy: the pool drains as
        # requests retire, so end-of-run stats under-report
        stats = self._peak_stats or kvpool.pool_wire_stats(self.pool)
        per_request = [
            {
                "rid": r.rid,
                "tokens": list(r.tokens),
                "n_tokens": len(r.tokens),
                "latency_s": r.latency_s,
                "queue_s": r.queue_s,
                "ttft_s": r.first_token_s - r.submit_s,
                "enqueue_tick": r.enqueue_tick,
                "first_token_tick": r.first_token_tick,
                "finish_tick": r.finish_tick,
                "decode_ticks": r.decode_ticks,
                "finished_by": r.finished_by,
                "status": r.status,
                "rejected": r.rejected,
                "slo_met": r.slo_met(self._requests[r.rid]),
            }
            for r in results
        ]
        steps = max(self.decode_steps, 1)
        mean_wire = self._wire_bytes_sum / steps
        latency = {
            "queue_s": self.queue_sketch.percentiles(),
            "ttft_s": self.ttft_sketch.percentiles(),
            "token_s": self.token_sketch.percentiles(),
            "ticks": self.tick,
            # fraction of scheduler ticks that reached a decode dispatch
            "tick_utilization": self.decode_steps / self.tick if self.tick else 0.0,
        }
        return {
            "per_request": per_request,
            "latency": latency,
            "device": str(self.device),
            "ticks": self.tick,
            "kv_mean_wire_bytes": mean_wire,
            "kv_mean_density": self._density_sum / steps,
            "kv_traffic_reduction_vs_fp32": (
                stats["kv_dense_fp32_bytes"] / mean_wire if mean_wire else 0.0),
            "decode_steps": self.decode_steps,
            "prefill_s": self.prefill_s,
            "decode_s": self.decode_s,
            "tokens_per_s": (self.tokens_emitted / self.decode_s
                             if self.decode_s else 0.0),
            "mean_occupancy": (self.occupancy_sum / self.decode_steps
                               if self.decode_steps else 0.0),
            "peak_kv_wire_bytes": self.peak_kv_wire_bytes,
            "peak_active": self.peak_active,
            "finite": self.finite,
            # spring-survive: shedding / preemption / elasticity counters
            "elastic": {
                "rejected": dict(self.n_rejected),
                "n_rejected": sum(self.n_rejected.values()),
                "n_spills": self.sched.n_spills,
                "n_resumes": self.sched.n_resumes,
                "n_rescales": self.n_rescales,
                "n_snapshots": self.n_snapshots,
                "n_restores": self.n_restores,
                "slow_ticks": self.slow_ticks,
            },
            **stats,
        }
