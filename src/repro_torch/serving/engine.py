"""ServingEngine: continuous batching over a fixed slot pool (port of
``repro/serving/engine.py``).

One engine owns a :class:`SlotScheduler` (FCFS admission, mid-flight
join and retire) and a packed :mod:`kvpool`.  Each tick admits queued
requests into free slots (batch-1 prefill, then the slot's KV is packed
into the pool) and runs one pooled decode step: unpack the pool, decode
every slot, keep the updates of active slots, repack.  On the card every
projection is a ``masked_matmul`` kernel launch and every pack a
``mask_pack`` launch.

Serving numerics: quantized modes round to nearest, so a request's tokens
are a function of the request alone, never of its batch co-tenants.
Decoding is greedy.  Token accounting is the reference's: the prefill's
argmax is fed as the first decode input (not reported), every decode step
emits one reported token, ``max_tokens`` bounds them and EOS is included.

Not ported yet: sampled decode (it draws from ``jax.random``), snapshots,
rescale, spill/resume, shedding, the paged pool, telemetry spans and
latency sketches.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch.serving import kvpool
from repro_torch.serving.request import Request, RequestResult
from repro_torch.serving.scheduler import SlotScheduler
from repro_torch.serving.steps import make_decode_step, make_prefill_step


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (no silent
    move to the CPU: the caller asks for the CPU explicitly)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port serves on the GPU by default "
            "(pass device='cpu' to run the plain versions on the CPU)")
    return device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServingEngine:
    """Continuous-batching engine for the ported decoder-only LMs.

    ``cfg`` is an ``LMConfig``; ``spring`` the serving ``SpringConfig``
    (``launch.serve.serving_config``).  ``params`` default to
    ``lm_init(cfg, seed)`` on ``device``.
    """

    def __init__(self, cfg, spring, *, params: Optional[dict] = None, n_slots: int = 4,
                 max_len: int = 256, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        cfg.check_supported()
        self.cfg = cfg
        self.spring = spring
        self.n_slots = n_slots
        self.max_len = max_len
        if params is None:
            from repro_torch.models.lm import lm_init

            params = lm_init(cfg, seed, device=self.device)
        elif params["embed"]["embedding"].device != self.device:
            raise ValueError(f"params live on {params['embed']['embedding'].device}, "
                             f"engine on {self.device}")
        self.params = params

        self.sched = SlotScheduler(n_slots)
        self._ledger = kvpool.SlotLedger(n_slots)
        self._next_tok = np.zeros((n_slots,), np.int64)
        self._results: dict[int, RequestResult] = {}
        self._requests: dict[int, Request] = {}
        self._next_rid = 0
        self._t0 = time.monotonic()

        self._prefill = make_prefill_step(cfg, spring)
        self._decode = make_decode_step(cfg, spring)
        self.pool = kvpool.init_pool(cfg, n_slots, max_len, device=self.device)

        self.decode_steps = 0
        self.tick = 0
        self.prefill_s = 0.0
        self.decode_s = 0.0
        self.occupancy_sum = 0.0
        self.tokens_emitted = 0
        self.peak_kv_wire_bytes = 0.0
        self._peak_stats: Optional[dict] = None
        self._wire_bytes_sum = 0.0
        self._density_sum = 0.0
        self.finite = True
        self.peak_active = 0

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
        self.sched.submit(req, tick=self.tick)
        return req.rid

    def submit_prompt(self, prompt, max_tokens: int, **kw) -> int:
        rid = self._next_rid
        self._next_rid = rid + 1
        return self.submit(Request(rid=rid, prompt=tuple(int(t) for t in prompt),
                                   max_tokens=max_tokens, **kw))

    # -- one scheduler tick: admissions + one pooled decode step ------------

    def release_slot(self, slot: int) -> None:
        self._ledger.release(slot)
        kvpool.release_packed(self.pool, slot)

    def _admit_one(self, tracker) -> None:
        req = tracker.req
        t0 = time.monotonic()
        tokens = torch.tensor([req.prompt], dtype=torch.int64, device=self.device)
        logits, pcache = self._prefill(self.params, tokens)
        self._ledger.install(tracker.slot)
        kvpool.install_packed(self.pool, pcache, tracker.slot, len(req.prompt))
        # the prefill token is fed, not reported (static-path contract)
        self._next_tok[tracker.slot] = int(torch.argmax(logits[0]))
        self.finite &= bool(torch.isfinite(logits).all())
        self.prefill_s += time.monotonic() - t0
        res = self._results[req.rid]
        res.admit_s = self._now()
        res.slot = tracker.slot

    def step(self) -> None:
        for tracker in self.sched.admit():
            self._admit_one(tracker)
        self.peak_active = max(self.peak_active, len(self.sched.active))
        slots = sorted(self.sched.active)
        if slots:
            self._decode_tick(slots)
        self.tick += 1

    def _decode_tick(self, slots: list) -> None:
        active = np.zeros((self.n_slots,), bool)
        active[slots] = True
        active_t = torch.as_tensor(active, device=self.device)
        tokens = torch.as_tensor(self._next_tok, device=self.device)
        _sync(self.device)
        t0 = time.monotonic()
        cache = kvpool.unpack_cache(self.pool)
        logits, new_cache = self._decode(self.params, tokens, cache)
        self.pool = kvpool.pack_cache(kvpool.merge_active(new_cache, cache, active_t))
        greedy = logits.argmax(dim=-1).cpu().numpy()  # waits for the device
        step_s = time.monotonic() - t0
        self.decode_s += step_s
        self.decode_steps += 1
        self.occupancy_sum += len(slots) / self.n_slots
        self.finite &= bool(torch.isfinite(logits[torch.as_tensor(slots)]).all())

        token_by_slot = {}
        for slot in slots:
            tracker = self.sched.active[slot]
            tok = int(greedy[slot])
            token_by_slot[slot] = tok
            self._next_tok[slot] = tok
            res = self._results[tracker.req.rid]
            if not tracker.tokens:
                res.first_token_s = self._now()
                res.first_token_tick = self.tick
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

    def run(self) -> dict:
        """Drain the queue; returns :meth:`summary`."""
        while self.sched.has_work():
            self.step()
            self.sched.check_invariants()
        return self.summary()

    # -- metrics ------------------------------------------------------------

    def summary(self) -> dict:
        results = [self._results[r] for r in sorted(self._results)]
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
            }
            for r in results
        ]
        steps = max(self.decode_steps, 1)
        mean_wire = self._wire_bytes_sum / steps
        return {
            "per_request": per_request,
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
            **stats,
        }
