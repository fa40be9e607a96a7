"""PagedServingEngine: the serving engine on the paged copy-on-write KV
pool (port of ``repro/serving/paging/engine.py``).

Same contract as :class:`repro_torch.serving.engine.ServingEngine`
(submit / step / run / summary, the same tokens per request) with the
slot-monolithic pool swapped for fixed-size packed pages:

  * KV rows live in :class:`PagedKVStore` frames; a :class:`BlockTable`
    maps (request, block) -> frame and shares pure prefix blocks
    copy-on-write between requests;
  * prompts install page by page (*chunked prefill*): at most
    ``prefill_chunk`` page writes land per tick engine-wide, so a long
    prompt never stalls the decode tick of requests already resident;
    a request decodes once its last page is in;
  * admission is *density-aware*: logical frames overcommit the physical
    page budget, and requests are admitted while their pages, costed at
    the pool's measured packed density, fit the physical bits.  When
    density rises and live bits exceed the budget, the most recently
    admitted requests spill: their exact packed page bits move to host
    memory and resume bit-identically once the pool drains.

Per-tick decode is gather -> compute -> scatter (``store.py``); the
gather table is captured *before* the write page is claimed, so a COW
fork reads the shared frame's content while its write-back lands in the
private copy (the "copy" is the full-page write-back itself).  The
working cache is ``max_len`` rows, the monolithic pool's length, so a
request's tokens are the monolithic engine's on the card too (the
decode's reductions run at one shape whatever the page padding).

Admission reads the live nonzeros exactly (int64) once a tick, the
engine's one device read besides the decode's tokens; page budgets are
float64 on the host, as the reference's Python floats are.
"""

from __future__ import annotations

import collections
import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import telemetry
from repro_torch.serving import kvpool
from repro_torch.serving.engine import ServingEngine, _sync
from repro_torch.serving.paging.admission import AdmissionController
from repro_torch.serving.paging.allocator import PageAllocator, PageError
from repro_torch.serving.paging.blocktable import BlockTable, chain_keys
from repro_torch.serving.paging.scheduler import PagedScheduler
from repro_torch.serving.paging.store import PagedKVStore, prompt_rows
from repro_torch.telemetry.sketch import QuantileSketch


def extract_slot_state(state: dict, slot: int) -> dict:
    """One slot's dense (non-paged) cache state as host copies, for spill
    payloads (``None`` holes stay ``None``)."""

    def one(path, leaf):
        if isinstance(leaf, dict):
            return {k: one(path + (k,), v) for k, v in leaf.items()}
        if leaf is None:
            return None
        return kvpool.host_copy(leaf.narrow(kvpool.slot_axis(path), slot, 1))

    return one((), state)


def restore_slot_state(state: dict, payload: dict, slot: int) -> dict:
    """Inverse of :func:`extract_slot_state` into (possibly another) slot,
    in place; values are converted to each leaf's dtype."""

    def one(path, leaf):
        if isinstance(leaf, dict):
            for k, v in leaf.items():
                one(path + (k,), v)
        elif leaf is not None:
            p = kvpool.as_tensor(kvpool.lookup(payload, path))
            leaf.narrow(kvpool.slot_axis(path), slot, 1).copy_(p.to(leaf.dtype))

    one((), state)
    return state


class PagedServingEngine(ServingEngine):
    """Continuous batching over paged, copy-on-write packed KV storage."""

    backend_kind = "paged"

    def __init__(self, cfg, spring, *, page_tokens: int = 8,
                 num_pages: Optional[int] = None, overcommit: float = 1.5,
                 prefix_cache: bool = True, prefill_chunk: Optional[int] = 8, **kw):
        if page_tokens < 1:
            raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
        if overcommit < 1.0:
            raise ValueError(f"overcommit must be >= 1.0, got {overcommit}")
        self.page_tokens = page_tokens
        self._num_pages_arg = num_pages
        self.overcommit = overcommit
        self.prefix_cache = prefix_cache
        self.prefill_chunk = prefill_chunk
        super().__init__(cfg, spring, **kw)

    # -- backend construction ------------------------------------------------

    def _make_scheduler(self, n_slots: int) -> PagedScheduler:
        return PagedScheduler(n_slots, policy=self.shed_policy)

    def _build_pool(self) -> None:
        pt = self.page_tokens
        self.max_blocks = -(-self.max_len // pt)
        # default physical budget: the dense equivalent of the monolithic
        # pool (every slot can hold max_len rows with nothing shared)
        num_pages = (self.n_slots * self.max_blocks
                     if self._num_pages_arg is None else self._num_pages_arg)
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        logical = int(math.ceil(num_pages * self.overcommit))

        self.store = PagedKVStore(self.cfg, self.n_slots, pt, self.max_blocks,
                                  n_frames=PageAllocator.RESERVED + logical,
                                  rows=self.max_len, device=self.device, heads=self.heads)
        self.alloc = PageAllocator(logical)
        self.table = BlockTable(self.alloc, pt, prefix_cache=self.prefix_cache)
        self.admission = AdmissionController(self.store.page_elems,
                                             self.store.page_mask_bits, num_pages)
        self.store_arrays = self.store.init_arrays()
        self.state = self.store.init_state()

        # host-side paging state
        self._pos = np.zeros((self.n_slots,), np.int64)  # device pos mirror
        self._slot_rid: dict[int, int] = {}
        self._resident_order: list[int] = []  # slots, admission order
        self._installing: dict = {}  # slot -> (prefill pages, pending deque)
        self._pending_frame_set: set = set()  # allocated, not yet written
        self._install_budget = 0
        self._reserved_frames = 0
        self._reserved_bits = 0.0
        self._live_bits = 0.0
        self._density: Optional[float] = None  # None until first measurement
        self.page_util_sketch = QuantileSketch()
        self.peak_page_utilization = 0.0

    def pool_bytes(self) -> int:
        """The bytes of this rank's page arrays and slot state."""
        return sum(t.numel() * t.element_size()
                   for t in kvpool.pool_leaves([self.store_arrays, self.state]))

    def state_bytes(self) -> int:
        """The bytes of this rank's recurrent state leaves (its slot state)."""
        return kvpool.state_bytes(self.state)

    # -- submission ----------------------------------------------------------

    def submit(self, req) -> int:
        # one request alone must fit the physical budget, or admission
        # could never make progress on it
        rows = prompt_rows(self.cfg, len(req.prompt)) + req.max_tokens + 1
        pages_needed = -(-rows // self.page_tokens)
        if pages_needed > self.admission.num_pages:
            raise ValueError(
                f"request {req.rid}: needs {pages_needed} pages ({rows} rows at "
                f"{self.page_tokens} tokens/page), physical budget is "
                f"{self.admission.num_pages} pages")
        return super().submit(req)

    # -- admission -----------------------------------------------------------

    def _density_est(self) -> float:
        """Measured pool density for admission projections: conservative
        1.0 while nothing has been measured."""
        return 1.0 if self._density is None else self._density

    def _projected_live(self) -> float:
        """Live bits plus the projected cost of allocated-but-unwritten
        (pending-install) frames, costed at the measured density."""
        return (self._live_bits + len(self._pending_frame_set)
                * self.admission.page_bits(self._density_est()))

    def _plan(self, req):
        n_fill = prompt_rows(self.cfg, len(req.prompt))
        n_blocks = -(-n_fill // self.page_tokens)
        # VLM prompts never share: chain keys hash tokens only
        share = self.prefix_cache and req.img_embeds is None
        keys = (chain_keys(req.prompt, self.page_tokens, n_fill) if share
                else [None] * n_blocks)
        plan = (self.table.plan_prompt(req.prompt, n_fill) if share
                else [None] * n_blocks)
        return plan, keys

    def _can_admit(self, req) -> bool:
        plan, _ = self._plan(req)
        n_new = sum(1 for hit in plan if hit is None)
        if n_new > self.alloc.n_free - self._reserved_frames:
            return False
        d = self._density_est()
        if not self.admission.admits(self._projected_live() + self._reserved_bits, n_new, d):
            return False
        self._reserved_frames += n_new
        self._reserved_bits += n_new * self.admission.page_bits(d)
        return True

    def _can_resume(self, spilled) -> bool:
        pay = spilled.payload
        if pay["n_frames"] > self.alloc.n_free - self._reserved_frames:
            return False
        if not self.admission.admits_exact(self._projected_live() + self._reserved_bits,
                                           pay["wire_bits"]):
            return False
        self._reserved_frames += pay["n_frames"]
        self._reserved_bits += pay["wire_bits"]
        return True

    def _admit_phase(self) -> None:
        self._shed_phase()
        self._install_budget = 10 ** 9 if self.prefill_chunk is None else self.prefill_chunk
        self._reserved_frames = 0
        self._reserved_bits = 0.0
        with telemetry.span("serve.tick.schedule"):
            admitted = self.sched.admit_paged(self._can_resume, self._can_admit)
        # drain older requests' pending page installs before new prompts
        # compete for the per-tick chunk budget
        for slot in [s for s in self._resident_order if s in self._installing]:
            self._pump_installs(slot)
        for tracker, spilled in admitted:
            if spilled is not None:
                self._resume_one(tracker, spilled)
            else:
                self._admit_one(tracker)  # base prefill/sample/bookkeeping
        self._reserved_frames = 0
        self._reserved_bits = 0.0

    def _install_request(self, tracker, pcache: dict) -> None:
        """Admission commit: open the block table, adopt shared prefix
        frames, queue the rest for chunked install, write slot state."""
        req, slot, rid = tracker.req, tracker.slot, tracker.req.rid
        plan, keys = self._plan(req)
        self.table.open(rid)
        pending = collections.deque()
        for b, hit in enumerate(plan):
            if hit is not None:
                self.table.adopt_block(rid, hit)
            else:
                f = self.table.append_block(rid)
                self._pending_frame_set.add(f)
                pending.append((b, f, keys[b]))
        kvpool.install_prefill(self.state, pcache, slot, len(req.prompt))
        self._installing[slot] = (self.store.pad_prefill(pcache), pending)
        self._slot_rid[slot] = rid
        self._resident_order.append(slot)
        self._pos[slot] = len(req.prompt)
        self._pump_installs(slot)
        _sync(self.device)

    def _pump_installs(self, slot: int) -> None:
        """Write pending prompt pages for ``slot`` while the per-tick chunk
        budget lasts (one ``kv_pack`` a leaf for them all); a fully
        installed slot starts decoding."""
        pages, pending = self._installing[slot]
        batch = []
        while pending and self._install_budget > 0:
            batch.append(pending.popleft())
            self._install_budget -= 1
        if batch:
            self.store.install_blocks(self.store_arrays, pages, [b for b, _, _ in batch],
                                      [f for _, f, _ in batch])
        for _, f, key in batch:
            self._pending_frame_set.discard(f)
            if key is not None:
                # the content is now really there: safe to share from
                self.table.register(f, key)
        if not pending:
            del self._installing[slot]

    def _resume_one(self, tracker, spilled) -> None:
        """Restore a spilled request into a fresh slot: exact packed page
        bits and slot state back onto the device, nothing recomputed, so
        resuming is bit-identical."""
        req, slot, pay = tracker.req, tracker.slot, spilled.payload
        with telemetry.span("serve.tick.resume", rid=req.rid, slot=slot):
            self._ledger.install(slot)
            self.table.open(req.rid)
            frames = [self.table.grow(req.rid) for _ in pay["frames"]]
            self.store.restore_frames(self.store_arrays, pay["frames"], frames)
            restore_slot_state(self.state, pay["state"], slot)
            _sync(self.device)
        self._pos[slot] = pay["pos"]
        self._next_tok[slot] = pay["next_tok"]
        self._slot_rid[slot] = req.rid
        self._resident_order.append(slot)
        self._results[req.rid].slot = slot

    # -- spill ---------------------------------------------------------------

    def _spill_slot(self, slot: int) -> None:
        """Preempt the request in ``slot``: its exact packed page bits and
        slot state move to host memory, its frames free at once."""
        tracker = self.sched.active[slot]
        rid = tracker.req.rid
        with telemetry.span("serve.tick.spill", rid=rid, slot=slot):
            frames = self.table.frames_of(rid)
            contents = self.store.extract_frames(self.store_arrays, frames)
            nnz = self.store.total(sum(int(leaf["nnz"].sum(dtype=torch.int64))
                                       for c in contents for leaf in c.values()))
            payload = {
                "frames": contents,
                "state": extract_slot_state(self.state, slot),
                "pos": int(self._pos[slot]),
                "next_tok": int(self._next_tok[slot]),
                # exact resume cost: shared frames were copied out, so the
                # request pays for private copies when it comes back
                "wire_bits": (float(nnz) * self.admission.value_bits
                              + len(frames) * self.store.page_mask_bits),
                "n_frames": len(frames),
            }
            self._ledger.release(slot)
            self.table.release(rid)
            del self._slot_rid[slot]
            self._resident_order.remove(slot)
            self._pos[slot] = 0
            self.sched.preempt(slot, payload)

    # -- decode tick ---------------------------------------------------------

    def _decode_slots(self) -> list:
        # a request decodes only once every prompt page is installed
        return sorted(s for s in self.sched.active if s not in self._installing)

    def _claim_write_page(self, s: int, candidates: set):
        """Secure the frame slot ``s`` writes this tick (growing or
        copy-on-write-forking its current block), spilling the most
        recently admitted unprepared request on page exhaustion.  Returns
        ``(write_frame, write_block, read_frames)`` or None if ``s`` itself
        was the spill victim.  ``read_frames`` is captured *before* the
        claim: a COW fork gathers the shared frame's content while its
        write-back lands in the private copy, and a freshly grown block
        gathers the null page (exact zeros)."""
        rid = self._slot_rid[s]
        wb = int(self._pos[s]) // self.page_tokens
        row = self.table.frames_of(rid)
        n0 = len(row)
        while True:
            try:
                while self.table.n_blocks(rid) <= wb:
                    self.table.grow(rid)
                frame, _cow = self.table.ensure_writable(rid, wb)
                return frame, wb, row
            except PageError:
                victim = next((v for v in reversed(self._resident_order)
                               if v in candidates and v in self.sched.active), None)
                if victim is None:  # unreachable: s itself is a candidate
                    raise
                if victim == s:
                    self.table.truncate(rid, n0)  # drop half-grown blocks
                    self._spill_slot(s)
                    return None
                self._spill_slot(victim)
                candidates.discard(victim)

    def _dispatch_decode(self, slots: list) -> tuple:
        wframe = np.ones((self.n_slots,), np.int64)  # default: the scratch sink
        wblock = np.zeros((self.n_slots,), np.int64)
        read_rows, prepared = {}, []
        unprepared = set(slots)
        for s in list(slots):
            if s not in self.sched.active:
                continue  # spilled while an earlier slot claimed its page
            got = self._claim_write_page(s, unprepared)
            unprepared.discard(s)
            if got is None:
                continue
            wframe[s], wblock[s], read_rows[s] = got
            prepared.append(s)
        if not prepared:
            return None, None, [], 0.0
        table_np = np.zeros((self.n_slots, self.max_blocks), np.int64)
        for s, row in read_rows.items():
            table_np[s, :len(row)] = row  # the tail stays 0: the null page
        active = np.zeros((self.n_slots,), bool)
        active[prepared] = True
        active_t = torch.as_tensor(active, device=self.device)
        tokens = torch.as_tensor(self._next_tok, device=self.device)
        table = torch.as_tensor(table_np, device=self.device)
        _sync(self.device)
        t0 = time.monotonic()
        with telemetry.span("serve.tick.decode", active=len(prepared)):
            cache = self.store.assemble(self.store_arrays, self.state, table)
            logits, new_cache = self._decode(self.params, tokens, cache)
            merged = kvpool.merge_active(new_cache, cache, active_t)
            self.store.writeback(self.store_arrays, merged, wframe, wblock)
            self.state = self.store.strip(merged)
            host = (logits.argmax(dim=-1) if self.greedy else logits).cpu()
        return logits, host, prepared, time.monotonic() - t0

    def _post_sample(self, slots: list) -> None:
        for s in slots:
            self._pos[s] += 1

    def release_slot(self, slot: int) -> None:
        self._ledger.release(slot)
        rid = self._slot_rid.pop(slot)
        self.table.release(rid)
        self._resident_order.remove(slot)
        self._pos[slot] = 0
        # no device work: freed frames drop out of the accounting and are
        # fully rewritten before any table references them again

    # -- accounting / spill-on-over-budget -----------------------------------

    def _pool_stats(self) -> dict:
        """Wire stats over *written* allocated frames (pending-install
        frames hold stale bits until their page write lands); one device
        read, like the monolithic pool's stats."""
        counted = [f for f in self.alloc.allocated_frames()
                   if f not in self._pending_frame_set]
        nnz = self.store.live_nnz(self.store_arrays, counted)
        return self.store.wire_stats(nnz, len(counted), self.admission.num_pages)

    def _post_stats(self, stats: dict) -> None:
        self._live_bits = stats["kv_wire_bytes"] * 8.0
        if stats["kv_elems"]:
            self._density = max(stats["kv_density"], 0.05)
        util = self.admission.utilization(self._live_bits)
        self.page_util_sketch.add(util)
        self.peak_page_utilization = max(self.peak_page_utilization, util)
        # the defined spill path: measured live bits exceeded the physical
        # budget (density spiked past the admission-time projection), so
        # preempt the most recently admitted residents until the pool fits
        while (self.admission.over_budget(self._live_bits)
               and len(self._resident_order) > 1):
            victim = next((s for s in reversed(self._resident_order)
                           if s not in self._installing), None)
            if victim is None:
                break
            self._spill_slot(victim)
            self._live_bits = self._pool_stats()["kv_wire_bytes"] * 8.0

    def _backend_gauges(self, m) -> None:
        m.set("spring_pages_allocated", self.alloc.n_allocated, help="allocated page frames")
        m.set("spring_pages_free", self.alloc.n_free, help="free page frames")
        m.set("spring_pages_utilization", self.admission.utilization(self._live_bits),
              help="live packed bits / physical page budget")
        m.set("spring_pages_shared", len(self.table.shared_frames()),
              help="frames referenced by more than one request")
        m.set("spring_pages_prefix_hits_total", self.table.prefix_hits,
              help="prompt blocks adopted from the prefix cache")
        m.set("spring_pages_cow_copies_total", self.table.cow_copies,
              help="copy-on-write page forks")
        m.set("spring_pages_spills_total", self.sched.n_spills,
              help="requests preempted to host memory")

    # -- elastic: rescale / snapshot / restore -------------------------------

    def _whole_store(self, n_slots: int, n_frames: int) -> PagedKVStore:
        """A store of the whole pool's layout (every kv head; built and read
        in :meth:`_whole_context`): what a snapshot holds under a kv-head
        split."""
        return PagedKVStore(self.cfg, n_slots, self.page_tokens, self.max_blocks,
                            n_frames=n_frames, rows=self.max_len, device=self.device)

    def _map_payload(self, payload: dict, fn) -> dict:
        """A spill payload with its frames (stacked, one ``map_heads`` a
        leaf) and slot state mapped by ``fn``, as host copies."""
        frames = payload["frames"]
        if frames:
            stacked = {key: {part: torch.stack([kvpool.word_view(kvpool.as_tensor(f[key][part]))
                                                for f in frames], dim=s.lead_n)
                             for part in ("values", "mask", "nnz")}
                       for key, s in self.store.leaves.items()}
            for key in stacked:
                stacked[key]["mask"] = stacked[key]["mask"].view(torch.uint32)
            mapped = self.store.map_heads(stacked, fn)
            frames = [{key: {part: kvpool.host_copy(t.select(s.lead_n, i))
                             for part, t in mapped[key].items()}
                       for key, s in self.store.leaves.items()} for i in range(len(frames))]
        return {**payload, "frames": frames,
                "state": kvpool.map_dense_heads(payload["state"], fn)}

    def _whole_payload(self, payload: dict) -> dict:
        """A spilled request's frames and slot state in the whole pool's
        layout under a kv-head split (its ``wire_bits`` are the whole
        pool's already)."""
        return payload if self.heads is None else self._map_payload(payload, self.heads.whole)

    def _rank_payload(self, payload: dict) -> dict:
        return payload if self.heads is None else self._map_payload(payload, self.heads.local)

    def _flush_installs(self) -> None:
        """Land every pending chunked prompt-page write now.  Page content
        is fixed at prefill and a request's tokens do not depend on its
        batch, so landing installs early changes no request's output."""
        self._install_budget = 10 ** 9
        for slot in [s for s in self._resident_order if s in self._installing]:
            self._pump_installs(slot)
        self._install_budget = 0

    def _pre_snapshot(self) -> None:
        self._flush_installs()

    def _pre_rescale(self) -> None:
        self._flush_installs()

    def rescale(self, slots: Optional[int] = None, num_pages: Optional[int] = None) -> None:
        """Grow or shrink slots and/or the physical page budget live.  Every
        in-flight or queued request must still fit the new budget alone
        (checked before any state changes: a too-small budget would park a
        request on the spill path forever)."""
        new_pages = self.admission.num_pages if num_pages is None else int(num_pages)
        if new_pages < 1:
            raise ValueError(f"rescale: num_pages must be >= 1, got {new_pages}")
        inflight = ([t.req for t in self.sched.active.values()] + list(self.sched._queue)
                    + [s.req for s in self.sched._spilled])
        for req in inflight:
            rows = prompt_rows(self.cfg, len(req.prompt)) + req.max_tokens + 1
            need = -(-rows // self.page_tokens)
            if need > new_pages:
                raise ValueError(
                    f"rescale: request {req.rid} needs {need} pages, new physical budget "
                    f"is {new_pages} — drain or shed it first")
        # page-utilization history survives the pool rebuild
        sketch, peak = self.page_util_sketch, self.peak_page_utilization
        self._num_pages_arg = new_pages
        super().rescale(slots)
        self.page_util_sketch, self.peak_page_utilization = sketch, peak

    def _signature(self) -> dict:
        sig = super()._signature()
        sig.update(page_tokens=self.page_tokens, num_pages=self.admission.num_pages,
                   overcommit=self.overcommit, prefix_cache=self.prefix_cache,
                   max_blocks=self.max_blocks)
        return sig

    def _check_backend(self, sig: dict, b: dict) -> None:
        """Refuse a snapshot whose logical frame count or leaves do not fit
        this engine at the snapshot's geometry (before any state changes)."""
        from repro_torch.serving.elastic.snapshot import SnapshotError, check_leaves

        capacity = int(math.ceil(int(sig["num_pages"]) * self.overcommit))
        if int(b["alloc"]["capacity"]) != capacity:
            raise SnapshotError(f"snapshot has {b['alloc']['capacity']} logical frames, "
                                f"engine has {capacity}")
        if self.heads is None:
            arrays, state = self.store.shapes(int(sig["n_slots"]),
                                              PageAllocator.RESERVED + capacity)
        else:
            with self._whole_context():
                arrays, state = self._whole_store(1, 1).shapes(
                    int(sig["n_slots"]), PageAllocator.RESERVED + capacity)
        check_leaves(arrays, b["store"], "page store")
        check_leaves(state, b["state"], "slot state")

    def _reconfigure(self, sig: dict) -> None:
        if (int(sig["n_slots"]) != self.n_slots
                or int(sig["num_pages"]) != self.admission.num_pages):
            self.n_slots = int(sig["n_slots"])
            self._num_pages_arg = int(sig["num_pages"])
            self._build_pool()

    def _snapshot_backend(self) -> dict:
        from repro_torch.serving.elastic.snapshot import tree_to_host_leaves

        assert not self._installing and not self._pending_frame_set, (
            "_pre_snapshot must flush chunked installs first")
        arrays, state = self.store_arrays, self.state
        if self.heads is not None:  # the whole pool's layout
            arrays = self.store.map_heads(arrays, self.heads.whole)
            state = kvpool.map_dense_heads(state, self.heads.whole)
        return {
            "store": tree_to_host_leaves(arrays),
            "state": tree_to_host_leaves(state),
            "alloc": {
                "capacity": self.alloc.capacity,
                "free": list(self.alloc._free),
                "ref": [[f, n] for f, n in sorted(self.alloc._ref.items())],
            },
            "table": {
                "blocks": [[rid, list(fr)] for rid, fr in sorted(self.table.blocks.items())],
                "index": [[k, f] for k, f in self.table._index.items()],
                "frame_key": [[f, k] for f, k in self.table._frame_key.items()],
                "prefix_hits": self.table.prefix_hits,
                "cow_copies": self.table.cow_copies,
            },
            "pos": self._pos.copy(),
            "slot_rid": [[s, r] for s, r in sorted(self._slot_rid.items())],
            "resident_order": list(self._resident_order),
            "density": self._density,
            "live_bits": self._live_bits,
            "page_util_sketch": self.page_util_sketch.to_dict(),
            "peak_page_utilization": self.peak_page_utilization,
        }

    def _restore_backend(self, b: dict) -> None:
        from repro_torch.serving.elastic.snapshot import leaves_to_tree

        if self.heads is None:
            self.store_arrays = leaves_to_tree(self.store_arrays, b["store"], "page store")
            self.state = leaves_to_tree(self.state, b["state"], "slot state")
        else:  # the whole pool's layout, sliced to this rank's heads
            with self._whole_context():
                whole = self._whole_store(self.n_slots, self.store.n_frames)
                arrays, state = whole.init_arrays(), whole.init_state()
            self.store_arrays = self.store.map_heads(
                leaves_to_tree(arrays, b["store"], "page store"), self.heads.local)
            self.state = kvpool.map_dense_heads(
                leaves_to_tree(state, b["state"], "slot state"), self.heads.local)
        self.alloc._free = [int(f) for f in b["alloc"]["free"]]
        self.alloc._ref = {int(f): int(n) for f, n in b["alloc"]["ref"]}
        t = b["table"]
        self.table.blocks = {int(r): [int(f) for f in fr] for r, fr in t["blocks"]}
        self.table._index = {tuple(k): int(f) for k, f in t["index"]}
        self.table._frame_key = {int(f): tuple(k) for f, k in t["frame_key"]}
        self.table.prefix_hits = int(t["prefix_hits"])
        self.table.cow_copies = int(t["cow_copies"])
        self._pos = np.asarray(b["pos"]).astype(np.int64).copy()
        self._slot_rid = {int(s): int(r) for s, r in b["slot_rid"]}
        self._resident_order = [int(s) for s in b["resident_order"]]
        self._installing = {}
        self._pending_frame_set = set()
        self._install_budget = 0
        self._reserved_frames = 0
        self._reserved_bits = 0.0
        self._density = None if b["density"] is None else float(b["density"])
        self._live_bits = float(b["live_bits"])
        self.page_util_sketch = QuantileSketch.from_dict(b["page_util_sketch"])
        self.peak_page_utilization = float(b["peak_page_utilization"])

    # -- invariants / reporting ----------------------------------------------

    def step(self) -> None:
        super().step()
        self.alloc.check_invariants()
        self.table.check_invariants()

    def summary(self) -> dict:
        out = super().summary()
        out["paging"] = {
            "page_tokens": self.page_tokens,
            "num_pages": self.admission.num_pages,
            "logical_frames": self.alloc.capacity,
            "overcommit": self.overcommit,
            "prefix_cache": self.prefix_cache,
            "max_blocks": self.max_blocks,
            "peak_active": self.peak_active,
            "prefix_hits": self.table.prefix_hits,
            "cow_copies": self.table.cow_copies,
            "spills": self.sched.n_spills,
            "resumes": self.sched.n_resumes,
            "allocated_frames": self.alloc.n_allocated,
            "free_frames": self.alloc.n_free,
            "budget_bits": self.admission.budget_bits,
            "peak_page_utilization": self.peak_page_utilization,
            "page_utilization": self.page_util_sketch.percentiles(),
        }
        return out
