"""spring-survive engine snapshots (port of
``repro/serving/elastic/snapshot.py``): one versioned, spec-hash-stamped
artifact per engine, bit-exact on the packed KV pool.

A snapshot captures everything a token depends on, so the restored
engine emits the exact remaining tokens of every in-flight request:

  * the packed pool bits (the pool's leaves in the reference's order,
    copied to the host, never repacked);
  * scheduler state — queue (policy metadata included), active trackers
    with tokens so far, spill queue with exact packed payloads,
    admission / submission / shed logs;
  * per-request sampling seeds (each ``Request.seed``; draw indices are
    the trackers' token counts) and the engine's tick counters;
  * the slot ledger, per-slot next-token feed, results so far, and the
    latency sketches (bit-exact ``to_dict`` round trip).

The artifact is a host tree (dicts / lists / scalars / CPU tensors).
``save_snapshot`` / ``load_snapshot`` serialize it to one ``.npz`` in the
reference's format: arrays ``a0..`` plus a JSON header (``meta``, and a
dtype name per array), bfloat16 stored as its uint16 bit pattern under
the tag ``"bfloat16"``.  A file either package writes, the other's
``load_snapshot`` decodes to the same tree; here every array comes back
as a CPU tensor.  ``version`` gates the format, ``spec_hash`` stamps the
producing configuration, and a restore that fails a check raises
:class:`SnapshotError` before any state changes.
"""

from __future__ import annotations

import io
import json
from typing import Any

import numpy as np
import torch

SNAPSHOT_VERSION = 1

#: signature fields that must match exactly between snapshot and engine
#: (n_slots is *adapted* by rebuilding the pool instead); the paged
#: backend's fields are listed as the reference lists them
_STRICT_SIG = ("max_len", "greedy", "kv_pack_impl", "kv_unpack_impl",
               "vocab", "d_model", "page_tokens", "overcommit",
               "prefix_cache")


class SnapshotError(ValueError):
    """Snapshot format/compatibility violation (wrong version, wrong
    spec hash, structural mismatch with the restoring engine)."""


# -- pure-tree codec: nested python tree <-> (JSON meta, array list) ---------


def _encode(node, arrays: list) -> Any:
    if node is None or isinstance(node, (bool, int, str)):
        return node
    if isinstance(node, float):
        return node
    if isinstance(node, (np.bool_, np.integer, np.floating)):
        return node.item()
    if isinstance(node, (torch.Tensor, np.ndarray)):
        tag = {"__a__": len(arrays)}
        arrays.append(node)
        return tag
    if isinstance(node, tuple):
        return {"__t__": [_encode(x, arrays) for x in node]}
    if isinstance(node, list):
        return [_encode(x, arrays) for x in node]
    if isinstance(node, dict):
        if all(isinstance(k, str) and not k.startswith("__") for k in node):
            return {k: _encode(v, arrays) for k, v in node.items()}
        return {"__d__": [[_encode(k, arrays), _encode(v, arrays)]
                          for k, v in node.items()]}
    raise SnapshotError(f"snapshot tree holds unsupported type {type(node)}")


def _decode(node, arrays: list) -> Any:
    if isinstance(node, dict):
        if "__a__" in node:
            return arrays[node["__a__"]]
        if "__t__" in node:
            return tuple(_decode(x, arrays) for x in node["__t__"])
        if "__d__" in node:
            return {_decode(k, arrays): _decode(v, arrays)
                    for k, v in node["__d__"]}
        return {k: _decode(v, arrays) for k, v in node.items()}
    if isinstance(node, list):
        return [_decode(x, arrays) for x in node]
    return node


#: torch dtypes numpy has no array type for (or no conversion from torch):
#: stored as their bits under the reference's dtype name
_BITS = {torch.bfloat16: (torch.int16, np.uint16, "bfloat16"),
         torch.uint32: (torch.int32, np.uint32, "uint32")}


def _storable(a) -> tuple[np.ndarray, str]:
    """npz-safe array + dtype tag (bfloat16 as its uint16 bit pattern, the
    reference's tag; uint32 words through an int32 view): byte-exact."""
    if isinstance(a, np.ndarray):
        return np.ascontiguousarray(a), a.dtype.name
    a = a.detach().cpu().contiguous()
    if a.dtype in _BITS:
        view, np_dtype, name = _BITS[a.dtype]
        return a.view(view).numpy().view(np_dtype), name
    stored = a.numpy()
    return stored, stored.dtype.name


def _unstore(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if dtype_name == "uint32":
        return torch.from_numpy(a.view(np.int32)).view(torch.uint32)
    return torch.from_numpy(a)


def save_snapshot(snap: dict, path: str) -> str:
    """Write a snapshot tree to one ``.npz`` file; byte-exact round trip
    with :func:`load_snapshot` (and with the reference's)."""
    arrays: list = []
    meta = _encode(snap, arrays)
    payload = {}
    dtypes = []
    for i, a in enumerate(arrays):
        stored, name = _storable(a)
        payload[f"a{i}"] = stored
        dtypes.append(name)
    header = json.dumps({"meta": meta, "dtypes": dtypes})
    payload["__meta__"] = np.frombuffer(header.encode("utf-8"), np.uint8)
    buf = io.BytesIO()
    np.savez(buf, **payload)
    with open(path, "wb") as f:  # one write of the whole buffer
        f.write(buf.getvalue())
    return path


def load_snapshot(path: str) -> dict:
    with np.load(path) as z:
        header = json.loads(bytes(z["__meta__"]).decode("utf-8"))
        arrays = [_unstore(z[f"a{i}"], name)
                  for i, name in enumerate(header["dtypes"])]
        return _decode(header["meta"], arrays)


# -- request / result / scheduler (de)serialization ---------------------------


def _req_dict(req) -> dict:
    return {
        "rid": req.rid, "prompt": list(req.prompt),
        "max_tokens": req.max_tokens, "eos_id": req.eos_id,
        "slo_ms": req.slo_ms, "seed": req.seed,
        "img_embeds": (None if req.img_embeds is None
                       else np.asarray(req.img_embeds)),
        "priority": req.priority, "deadline_ticks": req.deadline_ticks,
    }


def _req_from(d: dict):
    from repro_torch.serving.request import Request

    return Request(
        rid=int(d["rid"]), prompt=tuple(int(t) for t in d["prompt"]),
        max_tokens=int(d["max_tokens"]),
        eos_id=None if d["eos_id"] is None else int(d["eos_id"]),
        slo_ms=d["slo_ms"], seed=int(d["seed"]),
        img_embeds=d["img_embeds"], priority=int(d["priority"]),
        deadline_ticks=(None if d["deadline_ticks"] is None
                        else int(d["deadline_ticks"])))


def _result_dict(r) -> dict:
    return {
        "rid": r.rid, "tokens": list(r.tokens), "submit_s": r.submit_s,
        "admit_s": r.admit_s, "first_token_s": r.first_token_s,
        "done_s": r.done_s, "enqueue_tick": r.enqueue_tick,
        "first_token_tick": r.first_token_tick, "finish_tick": r.finish_tick,
        "slot": r.slot, "finished_by": r.finished_by, "rejected": r.rejected,
    }


def _result_from(d: dict):
    from repro_torch.serving.request import RequestResult

    return RequestResult(rid=int(d["rid"]),
                         tokens=[int(t) for t in d["tokens"]],
                         submit_s=d["submit_s"], admit_s=d["admit_s"],
                         first_token_s=d["first_token_s"], done_s=d["done_s"],
                         enqueue_tick=int(d["enqueue_tick"]),
                         first_token_tick=int(d["first_token_tick"]),
                         finish_tick=int(d["finish_tick"]),
                         slot=int(d["slot"]), finished_by=d["finished_by"],
                         rejected=d["rejected"])


def _sched_dict(sched) -> dict:
    return {
        "n_slots": sched.n_slots,
        "queue": [_req_dict(r) for r in sched._queue],
        "queue_meta": [[rid, tick, deadline] for rid, (tick, deadline)
                       in sched._queue_meta.items()],
        "active": [{"slot": s, "rid": t.req.rid, "tokens": list(t.tokens)}
                   for s, t in sorted(sched.active.items())],
        "admission_log": list(sched.admission_log),
        "submit_log": list(sched._submit_log),
        "shed_log": [[rid, reason] for rid, reason in sched.shed_log],
        "spilled": [{"req": _req_dict(s.req), "tokens": list(s.tokens),
                     "payload": s.payload} for s in sched._spilled],
        "n_spills": sched.n_spills,
        "n_resumes": sched.n_resumes,
    }


def _sched_restore(engine, d: dict, requests: dict):
    """Fresh scheduler of the engine's class, repopulated exactly."""
    from repro_torch.serving.scheduler import RequestTracker, SpilledRequest

    sched = type(engine.sched)(int(d["n_slots"]), policy=engine.shed_policy)
    import collections

    sched._queue = collections.deque(
        requests.get(int(q["rid"])) or _req_from(q) for q in d["queue"])
    sched._queue_meta = {
        int(rid): (int(tick), None if deadline is None else int(deadline))
        for rid, tick, deadline in d["queue_meta"]}
    for row in d["active"]:
        slot, rid = int(row["slot"]), int(row["rid"])
        tracker = RequestTracker(requests[rid], slot)
        tracker.tokens = [int(t) for t in row["tokens"]]
        sched.active[slot] = tracker
    sched._free = sorted(set(range(sched.n_slots)) - set(sched.active))
    sched.admission_log = [int(r) for r in d["admission_log"]]
    sched._submit_log = [int(r) for r in d["submit_log"]]
    sched.shed_log = [(int(rid), reason) for rid, reason in d["shed_log"]]
    sched._spilled = [
        SpilledRequest(req=requests.get(int(s["req"]["rid"]))
                       or _req_from(s["req"]),
                       tokens=[int(t) for t in s["tokens"]],
                       payload=s["payload"])
        for s in d["spilled"]]
    sched.n_spills = int(d["n_spills"])
    sched.n_resumes = int(d["n_resumes"])
    return sched


# -- sketches -----------------------------------------------------------------


def _sketch_dict(sk) -> dict:
    return sk.to_dict()


def _sketch_from(d: dict):
    from repro_torch.telemetry.sketch import QuantileSketch

    return QuantileSketch.from_dict(d)


# -- engine snapshot / restore ------------------------------------------------


def build_snapshot(engine) -> dict:
    """One pure host tree capturing the engine's full serving state."""
    snap = {
        "version": SNAPSHOT_VERSION,
        "kind": engine.backend_kind,
        "spec_hash": engine.spec_hash,
        "signature": engine._signature(),
        "tick": engine.tick,
        "decode_steps": engine.decode_steps,
        "next_rid": engine._next_rid,
        "next_tok": np.asarray(engine._next_tok).copy(),
        "ledger": list(engine._ledger.occupied),
        "scheduler": _sched_dict(engine.sched),
        "requests": [_req_dict(r) for _, r in sorted(engine._requests.items())],
        "results": [_result_dict(r) for _, r in sorted(engine._results.items())],
        "metrics": {
            "now_s": engine._now(),
            "prefill_s": engine.prefill_s,
            "decode_s": engine.decode_s,
            "occupancy_sum": engine.occupancy_sum,
            "tokens_emitted": engine.tokens_emitted,
            "peak_kv_wire_bytes": engine.peak_kv_wire_bytes,
            "peak_stats": engine._peak_stats,
            "wire_bytes_sum": engine._wire_bytes_sum,
            "density_sum": engine._density_sum,
            "finite": engine.finite,
            "peak_active": engine.peak_active,
            "queue_sketch": _sketch_dict(engine.queue_sketch),
            "ttft_sketch": _sketch_dict(engine.ttft_sketch),
            "token_sketch": _sketch_dict(engine.token_sketch),
            "n_rejected": dict(engine.n_rejected),
            "n_rescales": engine.n_rescales,
            "slow_ticks": engine.slow_ticks,
        },
        "backend": engine._snapshot_backend(),
    }
    return snap


def check_compatible(engine, snap: dict) -> None:
    """Reject a snapshot the engine cannot restore, before touching any
    state.  Version gate, backend kind, spec-hash stamp, then the strict
    structural signature (pool geometry that cannot be adapted)."""
    if not isinstance(snap, dict) or "version" not in snap:
        raise SnapshotError("not an engine snapshot (no version field)")
    if snap["version"] != SNAPSHOT_VERSION:
        raise SnapshotError(
            f"snapshot version {snap['version']} != supported "
            f"{SNAPSHOT_VERSION}")
    if snap["kind"] != engine.backend_kind:
        raise SnapshotError(
            f"snapshot is for a {snap['kind']} pool, engine is "
            f"{engine.backend_kind}")
    ours, theirs = engine.spec_hash, snap.get("spec_hash")
    if ours is not None and theirs is not None and ours != theirs:
        raise SnapshotError(
            f"snapshot spec_hash {theirs} != engine spec_hash {ours}: "
            "refusing to restore state produced under a different RunSpec")
    sig, mine = snap["signature"], engine._signature()
    for key in _STRICT_SIG:
        if key in sig or key in mine:
            if sig.get(key) != mine.get(key):
                raise SnapshotError(
                    f"snapshot signature mismatch on {key!r}: "
                    f"{sig.get(key)!r} != {mine.get(key)!r}")


def apply_snapshot(engine, snap: dict) -> None:
    """Restore ``engine`` to the snapshot's exact state.  The pool is
    adapted (rebuilt) if the snapshot was taken at a different
    ``n_slots``; everything else must match (see :func:`check_compatible`,
    and the engine's ``_check_backend`` for the pool's leaves: both run
    before any state changes)."""
    check_compatible(engine, snap)
    engine._check_backend(snap["signature"], snap["backend"])
    engine._reconfigure(snap["signature"])

    requests = {int(d["rid"]): _req_from(d) for d in snap["requests"]}
    engine._requests = requests
    engine._results = {int(d["rid"]): _result_from(d)
                       for d in snap["results"]}
    engine._next_rid = int(snap["next_rid"])
    engine.tick = int(snap["tick"])
    engine.decode_steps = int(snap["decode_steps"])
    engine._next_tok = np.asarray(snap["next_tok"]).astype(np.int64).copy()

    from repro_torch.serving import kvpool

    ledger = kvpool.SlotLedger(engine.n_slots)
    for slot in snap["ledger"]:
        ledger.install(int(slot))
    engine._ledger = ledger
    engine.sched = _sched_restore(engine, snap["scheduler"], requests)

    m = snap["metrics"]
    import time

    engine._t0 = time.monotonic() - float(m["now_s"])
    engine.prefill_s = float(m["prefill_s"])
    engine.decode_s = float(m["decode_s"])
    engine.occupancy_sum = float(m["occupancy_sum"])
    engine.tokens_emitted = int(m["tokens_emitted"])
    engine.peak_kv_wire_bytes = float(m["peak_kv_wire_bytes"])
    engine._peak_stats = m["peak_stats"]
    engine._wire_bytes_sum = float(m["wire_bytes_sum"])
    engine._density_sum = float(m["density_sum"])
    engine.finite = bool(m["finite"])
    engine.peak_active = int(m["peak_active"])
    engine.queue_sketch = _sketch_from(m["queue_sketch"])
    engine.ttft_sketch = _sketch_from(m["ttft_sketch"])
    engine.token_sketch = _sketch_from(m["token_sketch"])
    engine.n_rejected = {k: int(v) for k, v in m["n_rejected"].items()}
    engine.n_rescales = int(m["n_rescales"])
    engine.slow_ticks = int(m["slow_ticks"])

    engine._restore_backend(snap["backend"])


# -- pool leaf helpers (the engine's backend hooks) -----------------------------


def tree_to_host_leaves(tree) -> list:
    """The tree's leaves in the reference's order as host copies (the
    structure is implied by the engine's own pool at restore time)."""
    from repro_torch.serving import kvpool

    return [kvpool.host_copy(leaf) for leaf in kvpool.pool_leaves(tree)]


def check_leaves(shapes: list, leaves: list, what: str) -> None:
    """Refuse ``leaves`` unless they are as many as ``shapes`` and each has
    its shape (an architecture or pool mismatch)."""
    if len(shapes) != len(leaves):
        raise SnapshotError(
            f"{what}: snapshot has {len(leaves)} leaves, engine expects "
            f"{len(shapes)} — architecture mismatch")
    for i, (s, l) in enumerate(zip(shapes, leaves)):
        if tuple(s) != tuple(l.shape):
            raise SnapshotError(
                f"{what} leaf {i}: snapshot shape {tuple(l.shape)}"
                f" != engine shape {tuple(s)}")


def leaves_to_tree(template, leaves: list, what: str):
    """A new tree of ``template``'s structure, dtypes and device holding
    ``leaves`` (tensors or numpy arrays, in the reference's order), each
    leaf's count and shape checked first (:func:`check_leaves`): a
    mismatch means the snapshot was taken under another architecture and
    is refused before anything is built.  Values are converted to the template's dtype, as the
    reference's ``astype`` does (``pos``: int32 there, int64 here)."""
    from repro_torch.serving import kvpool

    check_leaves([tuple(t.shape) for t in kvpool.pool_leaves(template)], leaves, what)
    it = iter(leaves)

    def fresh(t: torch.Tensor) -> torch.Tensor:
        out = torch.empty(t.shape, dtype=t.dtype, device=t.device)
        kvpool.word_view(out).copy_(kvpool.word_view(kvpool.as_tensor(next(it))))
        return out

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, kvpool.PackedKV):
            values, mask, nnz = fresh(node.values), fresh(node.mask), fresh(node.nnz)
            return kvpool.PackedKV(values=values, mask=mask, nnz=nnz, shape=node.shape,
                                   dtype=node.dtype)
        return fresh(node)

    return build(template)
