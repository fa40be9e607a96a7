#!/usr/bin/env python3
"""GPU smoke test of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
repository around this file.  Phases, each of which exits non-zero on
failure:

  1. build   — compile every kernel under src/repro_torch/csrc with nvcc,
               one process per source, in parallel;
  2. kernels — each kernel's wrapper on card tensors at the serving path's
               shapes (masked_matmul at decode M = 4, prompt M = 32 and
               prefill M = 4096, each row printed with its route: the skinny
               kernel for M <= 32, bit-equal there to the tile kernel forced
               on the same operands; the tile kernel's occupancy pre-pass
               too, and once on block-pruned operands), held against its
               plain PyTorch version (tolerances below), then timed beside
               the plain version, the one PyTorch call computing the same
               function (where there is one) and the H100's bound for the
               same work;
  2c. mask_pack — both kernels bit-equal to the plain version on bf16, fp16
               and fp32 with +-0.0, NaN, +-inf and subnormals (the planner's
               route on every case, the lane route forced on stream-shaped
               ones, a misaligned view on the lane route); the prompt-32
               decode leaf, the 4096-token decode leaf and its install row,
               each route as a call and on device time with L2 flushed,
               beside the plain version and the bound; the launch floor (a
               one-word call's device time) and the host time of a call at
               the decode leaf, split into its parts;
  3. serve   — full-width llama3.2-1b, quant_sparse, random weights from a
               seed, 4 slots, 6 requests, prompt 32, gen 16, through
               ``repro_torch.launch.serve.serve_session`` on the card; the
               kernels' launch counters are zeroed just before and read just
               after, and every kernel must have launched; every product
               there has M <= 32, so tile_occupancy must not launch;
  3b. profile — a second engine over the same model, four decode ticks
               under torch.profiler: the device-busy share and the kernels
               by device time per tick; each tick launches the skinny
               kernel 7 times per layer, mask_pack twice and tile_occupancy
               never;
  4. check  — the reduced llama3.2-1b on the card against the same model on
               the CPU (plain versions), prefill and decode logits;
  5a. stochastic_round — bit-equal to its plain version on the reference's
               example shapes and a 32x224x224x64 activation, timed;
  5b. backward — masked_matmul_dx / _dw at VGG-19's c0_1, c3_0 and fc6
               backward shapes at batch 32 against the plain fp32 product
               (within 2K 2^-24 (|a|@|b|)), bit-identical across two calls,
               timed beside torch.matmul; exact on {0, 2^-8} operands at
               c0_1; a block-pruned case whose skip flags equal the plain
               version's; split-K forward with SR and the split-K reduce,
               exact (the reduce also at N = 50 from an unaligned base),
               the reduce timed as a call and on device time with L2
               flushed, each beside torch.sum's;
  5c. train  — full-width VGG-19 at 224x224, batch 32, quant_sparse with SR,
               the sparse backward and the memstash stash policy, sgdm with
               Q4.16 SR weights, 3 steps through
               ``repro_torch.launch.train.run_arm``; counters zeroed just before
               and read just after; every loss finite, every parameter on the
               grid after each step, every training kernel launched; s/step,
               images/s, peak memory, activation density and tile skip; then
               one step under torch.profiler;
  5d. check  — tiny_cnn, one nearest-rounding step on the card against the CPU;
  5e. arms   — the example's fp32 / SR / nearest arms on tiny_cnn, 150 steps,
               gaps printed (not gated);
  6a. flash_attention — the kernel against its plain version on the
               reference registry's five examples (fp32 atol 2e-5, bf16 2e-2),
               a non-causal ragged case, and llama3.2-1b's prefill shapes at
               S 32 / 128 / 512 / 4096 / 8192 and a D 128 row at S 4096 (q/k/v
               as the model passes them), each with the query tile it took,
               timed as a call, on device time with L2 flushed and on host
               time, beside the plain version, fp32
               scaled_dot_product_attention and the bound;
  6b. ssd_scan — y and the final state against the chunked plain version
               (rel 1e-4) on the registry's three examples and at mamba2-780m's
               prefill shape (x (1, 2000, 48, 64), b/c (1, 2000, 1, 128), read as
               views of one projection as the model does), also at the model's
               decays; each of the four stage kernels against its plain stage
               (rel 1e-4); timed as a call, and each stage and the total on
               device time with L2 flushed; the kernel's and
               the chunked plain version's deviation from a float64 run of the
               sequential oracle, printed (not gated);
  6c. serve_long — full-width llama3.2-1b, quant_sparse, 4 slots, 4 requests,
               prompt 4096, gen 16, counters zeroed just before and read just
               after: flash_attention, masked_matmul, tile_occupancy and
               mask_pack must launch; prefill s per request, tokens/s, peak
               memory; then three of its decode ticks profiled as in 3b;
  6d. serve_mamba2 — full-width mamba2-780m, quant_sparse, 4 slots, 6
               requests, prompt 2000, gen 16: ssd_scan, masked_matmul and
               tile_occupancy must launch; two more requests with
               deadline_ticks=0 queue behind the full pool and must be shed
               with "deadline" and no tokens;
  6e. check  — the reduced mamba2-780m and llama3.2-1b on the card against the
               CPU at a 300-token prompt, prefill and decode logits (atol 1e-3);
  6f. profile — one 4096-token llama3.2-1b prefill and one 2000-token
               mamba2-780m prefill under torch.profiler: device time by kernel;
  6g. survive — full-width llama3.2-1b, quant_sparse, 4 slots, 8 requests,
               prompt 512, gen 16, greedy: the uninterrupted run (the oracle),
               then the same requests through ChaosHarness (an .npz round
               trip, a rescale to 2 slots that spills, a snapshot, a rescale
               back to 4, a rewind, a kill into a fresh engine over the same
               parameter tensors): every request's tokens must equal the
               oracle's and requests must have spilled and resumed; an
               explicit .npz round trip timed (bytes, save and load s);
               slots 0-1's decode logits at 4 and at 2 slots must be
               bit-equal; one _spill_slot and one _resume_one timed, the
               payload's and the pool's bytes; sampled decode (4 requests)
               twice and through a snapshot and a rewind, equal; the
               oracle's workload with telemetry on: span count, tokens/s,
               equal tokens; then full-width mamba2-780m (6 requests, prompt
               256) through rescale 4 -> 2 -> 4, a snapshot and a rewind in
               memory, with the same gates; counters zeroed just before
               each model's chaos run and read just after: the skinny and
               tile kernels and tile_occupancy (both models),
               flash_attention and mask_pack (llama) and ssd_scan (mamba2)
               must launch there;
  7a. dangling_filter — bit-equal to its plain version on the registry's
               examples, -0.0 / NaN / inf entries at a length with a scalar
               tail, unaligned views, bf16 and 32x224x224x64 fp32; timed there
               beside the plain version and the bound;
  7b. sweep  — ``repro_torch.benchmarks.bench_kernels.smoke_rows`` on the card:
               every op's kernel against its plain version on the reference's
               examples under the op's compare; counters zeroed just before and
               read just after, every kernel of the sweep must launch;
  7c. paper  — ``sparsity_probe(density=0.5, size=512)`` on the card's kernels,
               then Table 1 and the Figs. 11-16 geomeans of the model with and
               without the measured tile-skip fractions, beside the paper's.

Then it prints one ``{"kernels": [...]}`` line, the card's name and power
limit from nvidia-smi, and, last, the ``{"ok": true, "device": ...}`` line.
TF32 is off throughout: Q4.16 values carry 21 significant bits, TF32 keeps
11.  The full report is also written to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import itertools
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, 700 W): device memory and fp32 on the
# CUDA cores (the kernels use no tensor cores)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12

# llama3.2-1b projections, (K, N) in the reference's (d_in, d_out) layout
LAYER_SHAPES = {"q": (2048, 2048), "k": (2048, 512), "v": (2048, 512),
                "o": (2048, 2048), "gate": (2048, 8192), "up": (2048, 8192),
                "down": (8192, 2048)}
DECODE_M, PREFILL_M = 4, 32
SLOTS, REQUESTS, PROMPT, GEN = 4, 6, 32, 16


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound(nbytes: float, flops: float) -> tuple:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def timed(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call of ``fn`` on the card: CUDA events around ``iters``
    calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


#: bytes read ahead of each call that :func:`cold_device_ms` times: ten
#: times the H100's 50 MB L2, so none of the call's operands is left there,
#: and about 0.17 ms of the card's time, in which the host queues the call
L2_FLUSH_BYTES = 512 * 2**20


def cold_device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device ms of one call of ``fn`` with its operands out of L2:
    CUDA events just around each call, each call queued behind a read of
    :data:`L2_FLUSH_BYTES`.  A read leaves L2 holding clean lines, so the
    call pays no write-back of the flush's own data.  The card is still
    reading while the host queues the call, so the events time the call's
    kernels and not its host time.  :func:`timed` times a loop of calls
    instead, which the host paces when a call is shorter than its host
    time and which finds a repeated call's operands in L2."""
    import torch

    flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    for _ in range(warmup):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters)]
    for start, end in events:
        flush.amax()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in events) / iters


def host_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean host ms per call of ``fn``: the wall time of ``iters`` calls
    queued without a wait (the card runs each in less time than the host
    takes to queue it, so the host never waits on a full queue)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    return wall * 1e3 / iters


def device_time_by_kernel(prof, per: int = 1) -> list:
    """(name, device ms, calls) of the device-side events of a profile,
    divided by ``per``, busiest first."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        # device-side events only: a CPU op's device time repeats its kernels'
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            rows.append((ev.key, ev.self_device_time_total / 1e3 / per, ev.count // per))
    rows.sort(key=lambda r: -r[1])
    return rows


def profile_decode(dev, prompt: int = PROMPT, ticks: int = 4) -> dict:
    """Where a decode tick's time goes: a full-width llama3.2-1b engine of
    SLOTS slots with ``prompt``-token requests, all slots admitted first,
    then ``ticks`` pooled decode ticks under torch.profiler.  Prints the
    wall time per tick, the device-busy share of the window, the kernels by
    device time and the launches per tick: the skinny kernel 7 per layer,
    tile_occupancy never, mask_pack twice (the pool's k and v leaves)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serving_config, synthetic_prompts
    from repro_torch.serving.engine import ServingEngine

    cfg = get_arch("llama3.2-1b").resolve(False)
    torch.cuda.empty_cache()
    eng = ServingEngine(cfg, serving_config("quant_sparse"), n_slots=SLOTS,
                        max_len=prompt + GEN + 1, seed=0, device=dev)
    for p in synthetic_prompts(SLOTS, prompt, cfg.vocab, 0):
        eng.submit_prompt(p, GEN)
    eng.step()  # admissions (prefill + install) and the first decode tick
    eng.step()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    del eng
    per_tick = {k: v / ticks for k, v in kernels.launch_counts().items() if v}
    tag = f"profile prompt {prompt}"
    print(f"[{tag}] launches per decode tick {per_tick}", flush=True)
    if per_tick.get("masked_matmul_skinny") != 7 * cfg.n_layers or "tile_occupancy" in per_tick \
            or per_tick.get("mask_pack") != 2:
        fail(f"a decode tick must launch the skinny kernel {7 * cfg.n_layers} times, "
             f"mask_pack twice and tile_occupancy never: {per_tick}")
    rows = device_time_by_kernel(prof, ticks)
    busy_ms = sum(r[1] for r in rows)
    tick_ms = wall_ms / ticks
    if busy_ms == 0:
        print(f"[{tag}] decode tick {tick_ms:.2f} ms wall; device time not measured "
              f"(the profiler recorded no device activity)", flush=True)
    else:
        print(f"[{tag}] decode tick {tick_ms:.2f} ms wall (profiled), device busy "
              f"{busy_ms:.2f} ms = {busy_ms / tick_ms:.1%}; top kernels per tick:", flush=True)
        for name, ms, n in rows[:12]:
            print(f"[{tag}]   {ms:8.3f} ms  x{n:<4d} {name[:90]}", flush=True)
    return {"prompt": prompt, "tick_ms": tick_ms, "device_busy_ms": busy_ms,
            "launches_per_tick": per_tick,
            "kernels": [{"name": n, "ms_per_tick": ms, "calls_per_tick": c}
                        for n, ms, c in rows[:40]]}


# -- 2c. mask_pack ----------------------------------------------------------------

#: one (layer, slot) k/v block of llama3.2-1b's pool is max_len x 8 kv heads
#: x 64 values, max_len = prompt + GEN + 1
KV_ROW = 8 * 64
#: exactness cases (n_blocks, block_len): the prompt-32 pool's decode and
#: install leaves, ragged lengths, a sweep-like 1-D length, one word, a
#: partial last warp step
MP_CASES = ((64, (PROMPT + GEN + 1) * KV_ROW), (16, (PROMPT + GEN + 1) * KV_ROW), (7, 1000),
            (3, 33), (1, 4096), (1, 32), (5, 288))


def _pack_operand(n_blocks: int, block_len: int, dtype, g):
    """Values with 40% zeros, every 7th -0.0, and +-0.0, NaN, +-inf and
    +-subnormals of ``dtype`` at one place in 16, made on the card from
    the generator ``g``."""
    import torch

    dev = g.device
    x = torch.randn(n_blocks, block_len, generator=g, device=dev)
    x *= torch.rand(n_blocks, block_len, generator=g, device=dev) > 0.4
    x[:, ::7] = -0.0
    sub = torch.finfo(dtype).smallest_normal / 4
    specials = torch.tensor([0.0, -0.0, float("nan"), float("inf"), float("-inf"), sub, -sub],
                            device=dev)
    flat = x.view(-1)
    at = torch.randint(0, flat.numel(), (max(1, flat.numel() // 16),), generator=g, device=dev)
    flat[at] = specials[torch.randint(0, len(specials), at.shape, generator=g, device=dev)]
    return x.to(dtype)


def phase_mask_pack(dev) -> dict:
    """(2c) both kernels of ``mask_pack`` against its plain version, exact,
    on bf16 / fp16 / fp32 with special values: the planner's route on every
    case, the lane route forced on stream-shaped ones, and a misaligned
    view (which must take the lane route); then the timed rows: the
    prompt-32 decode leaf, the 4096-token decode leaf and its install row,
    each route as a call and on device time with L2 flushed, beside the
    plain version and the bound; the launch floor (a one-word call's device
    time); the host time of one call at the decode leaf, split into its
    parts."""
    import math

    import torch

    from repro_torch.kernels import cuda
    from repro_torch.kernels.mask_compress import ops as mc

    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(2)
    n_sms = cuda.sm_count(dev.index)
    err = 0  # max |kernel - plain| over the words, as unsigned integers
    n_checked = 0

    def check(x, route, tag):
        nonlocal err, n_checked
        got, want = mc._launch(x, route=route), mc.mask_pack_reference(x)
        torch.cuda.synchronize()
        if got.shape != want.shape:
            fail(f"mask_pack {tag}: shape {tuple(got.shape)}, plain {tuple(want.shape)}")
        words = [w.view(torch.int32).to(torch.int64) & 0xFFFFFFFF for w in (got, want)]
        e = int((words[0] - words[1]).abs().max()) if got.numel() else 0
        if e:
            fail(f"mask_pack {tag} route={route} disagrees with its plain version")
        err = max(err, e)
        n_checked += 1

    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        elem = mc._ELEM_BYTES[dtype]
        for n_blocks, blen in MP_CASES:
            x = _pack_operand(n_blocks, blen, dtype, g)
            check(x, None, f"{dtype} ({n_blocks},{blen})")
            if mc.plan(n_blocks, blen, elem, True, n_sms).route == "stream":
                check(x, "lane", f"{dtype} ({n_blocks},{blen})")
        base = _pack_operand(1, 6 * 1024 + 1, dtype, g)
        view = base.view(-1)[1:].view(6, 1024)  # contiguous, off 16-byte alignment
        if mc.plan(6, 1024, elem, view.data_ptr() % 16 == 0, n_sms).route != "lane":
            fail("mask_pack: a misaligned view did not plan the lane route")
        check(view, None, f"{dtype} misaligned view (6,1024)")
    print(f"[mask_pack] exact on bf16/fp16/fp32 with +-0/NaN/+-inf/subnormals, both routes, "
          f"lengths {sorted({b for _, b in MP_CASES})}, a misaligned view: {n_checked} "
          f"cases ok", flush=True)

    rows = []
    for tag, n_blocks, max_len in (("decode leaf, prompt 32", 4 * 16, PROMPT + GEN + 1),
                                   ("decode leaf, prompt 4096", 4 * 16, LONG_PROMPT + GEN + 1),
                                   ("install row, prompt 4096", 16, LONG_PROMPT + GEN + 1)):
        blen = max_len * KV_ROW
        x = _pack_operand(n_blocks, blen, torch.bfloat16, g)
        p = mc.plan(n_blocks, blen, 2, True, n_sms)
        check(x, None, tag)
        check(x, "lane", tag)
        long = blen > 2**20
        iters = 50 if long else 200
        row = {"row": tag, "shape": [n_blocks, blen], "dtype": "bf16", "route": p.route,
               "ctas": p.ctas,
               "ms": timed(lambda: mc.mask_pack(x), iters),
               "device_ms": cold_device_ms(lambda: mc.mask_pack(x)),
               "lane_ms": timed(lambda: mc._launch(x, route="lane"), iters),
               "lane_device_ms": cold_device_ms(lambda: mc._launch(x, route="lane")),
               "plain_ms": timed(lambda: mc.mask_pack_reference(x), 5 if long else 50)}
        n_words = n_blocks * blen // 32
        row["bound_ms"], row["bound_by"] = bound(2.0 * x.numel() + 4.0 * n_words, x.numel())
        row["bound_share"] = row["bound_ms"] / row["device_ms"]
        rows.append(row)
        print(f"[mask_pack] {tag} ({n_blocks},{blen}) bf16: stream {row['ms']:.4f} ms a call, "
              f"{row['device_ms']:.4f} ms device time with L2 flushed ({p.ctas} CTAs, "
              f"{row['bound_share']:.0%} of the bound's rate); lane {row['lane_ms']:.4f} / "
              f"{row['lane_device_ms']:.4f} ms; plain {row['plain_ms']:.4f} ms, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
        del x
    torch.cuda.empty_cache()

    # the launch floor: one word's call on device time
    one = _pack_operand(1, 32, torch.bfloat16, g)
    floor_ms = cold_device_ms(lambda: mc.mask_pack(one))

    # the host time of one call at the decode leaf, and its parts: the
    # wrapper's Python (dtype, contiguity, shape, plan, stream and device
    # lookups, counter), the output's torch.empty, the ctypes call with its
    # launch
    n_blocks, blen = 4 * 16, (PROMPT + GEN + 1) * KV_ROW
    x = _pack_operand(n_blocks, blen, torch.bfloat16, g)
    p = mc.plan(n_blocks, blen, 2, True, n_sms)
    out = torch.empty((n_blocks, blen // 32), dtype=torch.uint32, device=dev)
    lib, ptr, out_ptr, stream = mc._lib(), x.data_ptr(), out.data_ptr(), cuda.stream(dev)

    def enter_device():
        with cuda.on_device(dev):
            pass

    split = {
        "call": host_ms(lambda: mc.mask_pack(x)),
        "empty": host_ms(lambda: torch.empty((n_blocks, blen // 32), dtype=torch.uint32,
                                             device=dev)),
        "ctypes_launch": host_ms(lambda: lib.mask_pack_launch(ptr, out_ptr, n_blocks, blen, 2, 1,
                                                              p.ctas, stream)),
        "plan": host_ms(lambda: mc.plan(n_blocks, blen, 2, ptr % 16 == 0,
                                        cuda.sm_count(dev.index))),
        "stream": host_ms(lambda: cuda.stream(dev)),
        "on_device": host_ms(enter_device),
        "shape": host_ms(lambda: (x.is_contiguous(), math.prod(x.shape[:-1]), x.data_ptr())),
    }
    split["python"] = split["call"] - split["empty"] - split["ctypes_launch"]
    print(f"[mask_pack] launch floor: a one-word (1,32) call takes {floor_ms:.4f} ms of device "
          f"time with L2 flushed (decode leaf {rows[0]['device_ms']:.4f})", flush=True)
    print("[mask_pack] host time of a call at the decode leaf, ms: "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items()), flush=True)
    main = rows[1]
    return {"max_abs_err": float(err), "cases": n_checked, "rows": rows, "floor_ms": floor_ms,
            "host_split": split, "host_ms": split["call"],
            **{k: main[k] for k in ("ms", "device_ms", "lane_ms", "lane_device_ms", "plain_ms",
                                    "bound_ms", "bound_by")}}


# -- slice 2: CNN training ------------------------------------------------------

# VGG-19 at 224 x 224, the paper's training batch (CNNDef.train_batch)
VGG_HW, VGG_BATCH, VGG_STEPS = 224, 32, 3
# backward GEMMs of three VGG-19 layers at batch 32: conv c0_1 (224 x 224,
# 64 -> 64), conv c3_0 (28 x 28, 256 -> 512) and fc6 (25088 -> 4096)
BWD_LAYERS = {"c0_1": ("conv", 224, 64, 64), "c3_0": ("conv", 28, 256, 512),
              "fc6": ("fc", 25088, 4096)}
# prompt 32 and decode ticks of 4 slots: every product on the skinny kernel
SERVE_KERNELS = ("masked_matmul", "masked_matmul_skinny", "mask_pack", "flash_attention")
# the fc forward and fc6 dX at batch 32 take the skinny kernel
TRAIN_KERNELS = ("masked_matmul", "masked_matmul_dx", "masked_matmul_dw", "masked_matmul_skinny",
                 "tile_occupancy", "splitk_reduce", "stochastic_round")


def phase_stochastic_round(dev, gen) -> dict:
    """(a) the SR kernel bit-equal to its plain version on the reference's
    example shapes and on a 32 x 224 x 224 x 64 activation, then timed."""
    import torch

    from repro_torch.kernels.stochastic_round.ops import sr_reference, stochastic_round

    cases = [((128,), 4, 16), ((333, 17), 4, 16), ((8, 1024), 4, 16), ((3, 5, 9), 4, 16),
             ((256, 64), 2, 6), ((VGG_BATCH, VGG_HW, VGG_HW, 64), 4, 16)]
    err = 0.0  # max |kernel - plain| over every case
    for shape, il, fl in cases:
        x = (torch.randn(shape, generator=gen) * 3).to(dev)
        got, want = stochastic_round(x, 9, il=il, fl=fl), sr_reference(x, 9, il=il, fl=fl)
        torch.cuda.synchronize()
        err = max(err, float((got - want).abs().max()))
        if not torch.equal(got, want):
            fail(f"stochastic_round {shape} Q{il}.{fl} differs from its plain version")
        del got, want
    print("[stochastic_round] bit-equal to its plain version on the example shapes "
          f"and on {tuple(x.shape)}: ok", flush=True)
    ms = timed(lambda: stochastic_round(x, 9), 20)
    plain_ms = timed(lambda: sr_reference(x, 9), 3, warmup=1)
    b_ms, b_by = bound(8.0 * x.numel(), 10.0 * x.numel())
    print(f"[stochastic_round] {tuple(x.shape)}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by})", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": err, "shape": list(x.shape)}


def _relu_sparse(gen, shape, dev):
    import torch

    return torch.relu(torch.randn(shape, generator=gen)).to(dev)


def _coarse01(gen, shape, dev):
    """Values in {0, 2^-8}, half of them zero: every product is 0 or
    2^-16, so a sum of fewer than 2^24 of them is exact in fp32 in any
    order and the kernel must equal the plain product bit for bit."""
    import torch

    return ((torch.rand(shape, generator=gen) < 0.5).to(torch.float32) * 2.0**-8).to(dev)


def phase_backward(dev, gen) -> dict:
    """(b) dx / dw at VGG-19's backward shapes, each operand laid out as the
    training path passes it (conv dW reads the im2col patches transposed,
    conv dX the row-major rot180 weights, fc dX the weights transposed),
    against the plain fp32 product (within 2 K 2^-24 (|a| @ |b|)
    elementwise), bit-identical across two calls, timed beside the plain
    version and torch.matmul; exact on {0, 2^-8} operands at c0_1, where
    a dropped K chunk would show; a block-pruned case whose skip flags must
    equal the plain version's; a split-K forward with SR and the split-K
    reduce, exact on coarse-grid operands."""
    import torch

    from repro_torch.kernels.masked_matmul import ops as mm
    from repro_torch.kernels.masked_matmul.backward import (
        masked_matmul_dw, masked_matmul_dw_reference, masked_matmul_dx,
        masked_matmul_dx_reference)

    rows, err_max = [], {"dx": 0.0, "dw": 0.0}
    for layer, spec in BWD_LAYERS.items():
        if spec[0] == "conv":
            _, hw, cin, cout = spec
            m = VGG_BATCH * hw * hw
            # dW = patches^T @ g: patches (m, cin*9) of a ReLU-sparse input;
            # dX = cotangent patches (m, cout*9) @ rot180 weights wt, which
            # _ConvSparseBackward passes as wt.T (masked_matmul_dx(g, w)
            # computes g @ w.T, so the kernel reads wt row-major)
            dw_ops = (_relu_sparse(gen, (m, cin * 9), dev), _relu_sparse(gen, (m, cout), dev))
            dx_ops = (_relu_sparse(gen, (m, cout * 9), dev),
                      torch.randn(cout * 9, cin, generator=gen).to(dev).T)
        else:
            _, k, n = spec
            dw_ops = (_relu_sparse(gen, (VGG_BATCH, k), dev),
                      _relu_sparse(gen, (VGG_BATCH, n), dev))
            dx_ops = (_relu_sparse(gen, (VGG_BATCH, n), dev),
                      torch.randn(k, n, generator=gen).to(dev))
        for op, (a, b), fn, ref in (
                ("dw", dw_ops, masked_matmul_dw, masked_matmul_dw_reference),
                ("dx", dx_ops, masked_matmul_dx, masked_matmul_dx_reference)):
            # the product's operands as the kernel reads them: (M, K) @ (K, N)
            lhs, rhs = (a.T, b) if op == "dw" else (a, b.T)
            mm_m, mm_k = lhs.shape
            mm_n = rhs.shape[1]
            got, again = fn(a, b), fn(a, b)
            want = ref(a, b)
            tol = 2 * mm_k * 2.0**-24 * (lhs.abs() @ rhs.abs())
            err = (got - want).abs()
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"masked_matmul_{op} at {layer} is not deterministic")
            if not bool((err <= tol).all()):
                fail(f"masked_matmul_{op} at {layer} off by {float(err.max()):.3g}")
            del tol, want
            err_max[op] = max(err_max[op], float(err.max()))
            iters = 3 if mm_m * mm_n * mm_k > 1e10 else 20
            ms = timed(lambda: fn(a, b), iters, warmup=1)
            plain_ms = timed(lambda: ref(a, b), iters, warmup=1)
            lib_ms = timed(lambda: torch.matmul(lhs, rhs), iters, warmup=1)
            skip = mm.tile_skip_fraction(lhs, rhs, mm.KERNEL_TILES)
            b_ms, b_by = bound(4.0 * (mm_m * mm_k + mm_k * mm_n + mm_m * mm_n),
                               2.0 * mm_m * mm_n * mm_k * (1 - skip))
            chunks = mm.split_k(mm_k)[1]
            kernel = mm.route(mm_m, mm_n, mm_k)
            rows.append({"op": op, "layer": layer, "shape": [mm_m, mm_k, mm_n],
                         "route": kernel, "chunks": chunks, "ms": ms, "plain_ms": plain_ms,
                         "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                         "skip": skip, "max_abs_err": float(err.max())})
            print(f"[backward] {op} {layer} ({mm_m},{mm_k})@({mm_k},{mm_n}) {kernel} kernel, "
                  f"split {chunks}: "
                  f"err={float(err.max()):.3g}, deterministic; kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms, torch.matmul {lib_ms:.3f} ms, bound {b_ms:.3f} ms "
                  f"({b_by}), {ms / lib_ms:.2f}x torch.matmul", flush=True)
            del got, again, err
        del dw_ops, dx_ops, a, b, lhs, rhs
    torch.cuda.empty_cache()

    # exact at c0_1 on {0, 2^-8} operands: dw sums K = 1.6 M products over
    # 196 split-K chunks, dx reads the row-major rot180 weights
    m, cin, cout = VGG_BATCH * 224 * 224, 64, 64
    exact_ops = (("dw", masked_matmul_dw, masked_matmul_dw_reference,
                  _coarse01(gen, (m, cin * 9), dev), _coarse01(gen, (m, cout), dev)),
                 ("dx", masked_matmul_dx, masked_matmul_dx_reference,
                  _coarse01(gen, (m, cout * 9), dev), _coarse01(gen, (cout * 9, cin), dev).T))
    for op, fn, ref, a, b in exact_ops:
        got, want = fn(a, b), ref(a, b)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        err_max[op] = max(err_max[op], e)
        if not torch.equal(got, want):
            fail(f"masked_matmul_{op} at c0_1 on {{0, 2^-8}} operands is off by {e:.3g}")
        print(f"[backward] {op} c0_1 on {{0, 2^-8}} operands: bit-equal to the plain product",
              flush=True)
        del got, want
    del exact_ops, a, b
    torch.cuda.empty_cache()

    # block-pruned: whole 64-row tiles of x (dw reads x^T) and of the
    # cotangent are zero; the kernel's flags of the transposed operand must
    # equal the plain flags of the transpose, and tiles must be skipped
    tm, tn, tk = mm.KERNEL_TILES
    x = _relu_sparse(gen, (4096, 576), dev)
    g = _relu_sparse(gen, (4096, 64), dev)
    x[: 4096 // 2] = 0.0
    g[1024:1536] = 0.0
    flags = mm.tile_occupancy(x, tk, tm).t()
    if not torch.equal(flags, mm.tile_occupancy_reference(x.T, tm, tk)):
        fail("masked_matmul_dw: transposed-operand skip flags differ from the plain version's")
    with mm.record_tile_skip() as rec:
        got = masked_matmul_dw(x, g)
    skip = 1.0 - rec["masked_matmul_dw"][0] / rec["masked_matmul_dw"][1]
    want_skip = mm.tile_skip_fraction(x.T, g, mm.KERNEL_TILES)
    err = float((got - masked_matmul_dw_reference(x, g)).abs().max())
    print(f"[backward] block-pruned dw (576,4096)@(4096,64): flags equal to the plain "
          f"version's, skip {skip:.3f} (plain {want_skip:.3f}), err {err:.3g}", flush=True)
    if skip <= 0.0 or abs(skip - want_skip) > 1e-12:
        fail("masked_matmul_dw on block-pruned operands: skipped tiles disagree")

    # split-K forward with the SR epilogue (fc6 at batch 32): exact on the
    # 2^-8 grid, where every sum is exact whatever its order
    xs = torch.round(torch.randn(VGG_BATCH, 25088, generator=gen) * 2**2) / 2**8
    ws = torch.round(torch.randn(25088, 64, generator=gen) * 2**2) / 2**8
    xs, ws = xs.to(dev), ws.to(dev)
    got, want = mm.masked_matmul(xs, ws, 5), mm.masked_matmul_reference(xs, ws, 5)
    red_err = float((got - want).abs().max())  # max |kernel - plain| over every reduce
    if not torch.equal(got, want):
        fail("masked_matmul split-K forward with SR differs from its plain version")
    part = torch.randn(196, 576, 64, generator=gen).to(dev)
    # c0_1's dW partials, then N = 50 from a base 4 bytes past 16-byte
    # alignment (scalar loads) and an M * N that fills no block
    flat = torch.randn(1 + 7 * 70 * 50, generator=gen).to(dev)
    for pt in (part, flat[1:].view(7, 70, 50), flat[:17 * 5 * 50].view(17, 5, 50)):
        for sr in (False, True):
            got = mm.splitk_reduce(pt, 3, apply_sr=sr)
            want = mm.splitk_reduce_reference(pt, 3, apply_sr=sr)
            red_err = max(red_err, float((got - want).abs().max()))
            if not torch.equal(got, want):
                fail(f"splitk_reduce {tuple(pt.shape)} differs from its plain version")
    # ms: a loop of calls, as every row has it (the call is about as short
    # on the card as its host time, so it is long enough for the host to
    # pace); device_ms: the kernel alone with the partials out of L2, to
    # hold against the byte bound
    red_ms = timed(lambda: mm.splitk_reduce(part), 200, warmup=20)
    red_lib_ms = timed(lambda: torch.sum(part, 0), 200, warmup=20)
    red_plain_ms = timed(lambda: mm.splitk_reduce_reference(part), 3, warmup=1)
    red_dev_ms = cold_device_ms(lambda: mm.splitk_reduce(part))
    red_lib_dev_ms = cold_device_ms(lambda: torch.sum(part, 0))
    red_host_ms = host_ms(lambda: mm.splitk_reduce(part))
    red_lib_host_ms = host_ms(lambda: torch.sum(part, 0))
    red_b, red_by = bound(4.0 * (part.numel() + part[0].numel()), part.numel())
    print(f"[backward] split-K forward with SR (32,25088)@(25088,64) exact; splitk_reduce "
          f"(196,576,64), (7,70,50) unaligned and (17,5,50) exact; at c0_1 a call: kernel "
          f"{red_ms:.5f} ms, torch.sum {red_lib_ms:.5f} ms; device time, L2 flushed: kernel "
          f"{red_dev_ms:.5f} ms, torch.sum {red_lib_dev_ms:.5f} ms; host time a call: kernel "
          f"{red_host_ms:.5f} ms, torch.sum {red_lib_host_ms:.5f} ms; plain {red_plain_ms:.4f} "
          f"ms, bound {red_b:.5f} ms ({red_by})", flush=True)
    return {"rows": rows, "err": err_max,
            "reduce": {"ms": red_ms, "device_ms": red_dev_ms, "plain_ms": red_plain_ms,
                       "library_ms": red_lib_ms, "library_device_ms": red_lib_dev_ms,
                       "host_ms": red_host_ms, "library_host_ms": red_lib_host_ms,
                       "bound_ms": red_b, "bound_by": red_by, "max_abs_err": red_err,
                       "shape": "c0_1 dw partial sums (196, 576, 64)"}}


def profile_train_step(dev, params, memstash) -> dict:
    """One VGG-19 train step under torch.profiler: device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.fixedpoint import SPRING_FORMAT
    from repro_torch.core.spring_ops import QUANT_SPARSE
    from repro_torch.data.pipeline import DataConfig, SyntheticImageTask
    from repro_torch.launch.train import MODELS
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.runtime.train import StepConfig, init_train_state, make_cnn_train_step

    step_cfg = StepConfig(spring=QUANT_SPARSE, memstash=memstash,
                          optimizer=OptimizerConfig(kind="sgdm", lr=0.05, momentum=0.9,
                                                    weight_format=SPRING_FORMAT))
    step = make_cnn_train_step(MODELS["vgg19"].fn, step_cfg)
    state = init_train_state(params, step_cfg, seed=1)
    x, y = SyntheticImageTask(DataConfig(seed=1, global_batch=VGG_BATCH), hw=VGG_HW,
                              device=dev).batch(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step(state, x, y)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    rows = device_time_by_kernel(prof)
    busy = sum(r[1] for r in rows)
    if busy == 0:
        print(f"[train-profile] step {wall_ms:.1f} ms wall; device time not measured", flush=True)
    else:
        print(f"[train-profile] step {wall_ms:.1f} ms wall (profiled), device busy "
              f"{busy:.1f} ms = {busy / wall_ms:.1%}; top kernels:", flush=True)
        for name, ms, n in rows[:14]:
            print(f"[train-profile]   {ms:9.2f} ms  x{n:<5d} {name[:90]}", flush=True)
    return {"step_ms": wall_ms, "device_busy_ms": busy,
            "kernels": [{"name": n, "ms": ms, "calls": c} for n, ms, c in rows[:40]]}


def phase_train(dev) -> dict:
    """(c) full-width VGG-19, quant_sparse, SR, sparse backward, the stash
    policy, sgdm with Q4.16 SR weights, through repro_torch.launch.train;
    the kernels' launch counters are zeroed just before and read just
    after; then one profiled step."""
    import torch

    from repro_torch import kernels
    from repro_torch.launch.train import run_arm
    from repro_torch.memstash.config import STASH_ALL

    kernels.reset_launch_counts()
    t0 = time.monotonic()
    out = run_arm("vgg19", "vgg19", "quant_sparse", True, VGG_STEPS, VGG_HW, VGG_BATCH, dev,
                  STASH_ALL, seed=0, probe_step=0)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = kernels.launch_counts()
    probe = out["probe"]
    print(f"[train] vgg19 {VGG_HW}x{VGG_HW} batch {VGG_BATCH} quant_sparse SR stash: losses "
          f"{[round(v, 4) for v in out['losses']]}, on grid {out['on_grid']}, "
          f"{out['s_per_step']:.3f} s/step, {out['images_per_s']:.2f} images/s, peak "
          f"{out['peak_mem_bytes'] / 2**30:.2f} GiB, wall {wall:.1f}s", flush=True)
    print(f"[train] activation density {probe['stash']['mean_density']:.3f} over "
          f"{probe['stash']['stash_points']} stash points; tile skip "
          f"{ {k: round(v, 4) for k, v in probe['tile_skip'].items()} }; launches {launches}",
          flush=True)
    if not (out["finite"] and all(out["on_grid"]) and len(out["on_grid"]) == VGG_STEPS):
        fail("train phase: a loss is not finite or a parameter left the Q4.16 grid")
    for name in TRAIN_KERNELS:
        if launches[name] <= 0:
            fail(f"train phase never launched the {name} kernel")
    prof = profile_train_step(dev, out.pop("params"), STASH_ALL)
    return {"run": out, "launches": launches, "wall_s": wall, "profile": prof}


def phase_cnn_card_vs_cpu(dev) -> dict:
    """(d) the reduced CNN (the example's tiny_cnn) one train step on the
    card against the same step on the CPU: quant_sparse, nearest rounding,
    fp32 weights, stash.  Tolerance: the CPU parity tests' gradient
    contract (rtol 1e-5, floor 1e-5 x max), since the conv and the products
    sum in another order and a rounding can move one 2^-16 step."""
    import dataclasses

    import torch

    from repro_torch.core.spring_ops import QUANT_SPARSE
    from repro_torch.data.pipeline import DataConfig, SyntheticImageTask
    from repro_torch.launch.train import MODELS, tiny_cnn
    from repro_torch.models.cnn import cnn_init
    from repro_torch.memstash.config import STASH_ALL
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.runtime.train import StepConfig, init_train_state, make_cnn_train_step

    step_cfg = StepConfig(spring=dataclasses.replace(QUANT_SPARSE, stochastic=False),
                          memstash=STASH_ALL,
                          optimizer=OptimizerConfig(kind="sgdm", lr=0.05, momentum=0.9))
    params = cnn_init(0, MODELS["tiny_cnn"], 16)
    x, y = SyntheticImageTask(DataConfig(seed=0, global_batch=8), hw=16).batch(0)
    res = {}
    for d in ("cpu", dev):
        state = init_train_state({k: v.to(d) for k, v in params.items()}, step_cfg, 0)
        state, m = make_cnn_train_step(tiny_cnn, step_cfg)(state, x.to(d), y.to(d))
        res[str(d)] = (float(m["loss"]), {k: v.cpu() for k, v in state.params.items()})
    (l_cpu, p_cpu), (l_gpu, p_gpu) = res["cpu"], res[str(dev)]
    worst = 0.0
    for k in p_cpu:
        tol = 1e-5 * (float(p_cpu[k].abs().max()) + 1.0) + 1e-5 * p_cpu[k].abs()
        diff = (p_gpu[k] - p_cpu[k]).abs()
        worst = max(worst, float(diff.max()))
        if not bool((diff <= tol).all()):
            fail(f"tiny_cnn step on the card disagrees with the CPU at {k}")
    print(f"[check] tiny_cnn one step card vs CPU: loss {l_gpu:.6f} vs {l_cpu:.6f}, params "
          f"max_abs_err {worst:.3g} (rtol 1e-5, floor 1e-5 x max)", flush=True)
    if abs(l_gpu - l_cpu) > 1e-5 * abs(l_cpu):
        fail("tiny_cnn loss on the card disagrees with the CPU")
    return {"loss_card": l_gpu, "loss_cpu": l_cpu, "params_max_abs_err": worst}


def phase_arms(dev) -> dict:
    """(e) the example's three arms on tiny_cnn; printed, not gated."""
    from repro_torch.launch.train import parity_arms

    out = parity_arms(steps=150, device=dev)
    print(f"[arms] tiny_cnn 150 steps tail loss: fp32 {out['fp32']['tail']:.4f}, SR "
          f"{out['sr']['tail']:.4f}, nearest {out['nearest']['tail']:.4f}; SR gap "
          f"{out['sr_gap']:+.4f}, nearest gap {out['nearest_gap']:+.4f}", flush=True)
    return out


# -- slice 3: long-prompt prefill and Mamba-2 serving -----------------------------

# llama3.2-1b's attention (H 32, HKV 8, D 64) at prefill lengths; the long
# serve; mamba2-780m's SSD (H 48, P 64, N 128, G 1) and its serve
FA_HEADS, FA_KV_HEADS, FA_DIM = 32, 8, 64
# 6a's timed (S, D) rows at B 1, H 32, HKV 8, causal, fp32: llama3.2-1b's
# prefills (S 32 and 128 as in the prompt-32 serve, up to S 8192), and head
# dim 128 (minitron-4b's and mistral-nemo-12b's) at S 4096
FA_ROWS = ((32, 64), (128, 64), (512, 64), (4096, 64), (8192, 64), (4096, 128))
LONG_SLOTS, LONG_REQUESTS, LONG_PROMPT = 4, 4, 4096
SSD_HEADS, SSD_DIM, SSD_STATE, SSD_CHUNK = 48, 64, 128, 128
MAMBA_SLOTS, MAMBA_REQUESTS, MAMBA_PROMPT = 4, 6, 2000
MAMBA_LATE = 2  # requests with an admission deadline of 0 ticks, shed behind the full pool
CHECK_PROMPT = 300
LONG_KERNELS = ("flash_attention", "masked_matmul", "tile_occupancy", "mask_pack")
MAMBA_KERNELS = ("ssd_scan", "masked_matmul", "tile_occupancy")


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def phase_flash_attention(dev, gen) -> dict:
    """(6a) flash_attention against its plain version on the reference
    registry's examples (``flash_attention/ops.py:39-55``, its compare:
    fp32 atol 2e-5, bf16 atol 2e-2) and a non-causal ragged case, then at
    the :data:`FA_ROWS` shapes, q/k/v as ``gqa_apply`` passes them
    (transposed (B, S, H, D) projections): each row's query tile, its call
    time (a timed loop), device time with L2 flushed and host time, beside
    the plain version, fp32 scaled_dot_product_attention and the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ops import attention_reference, flash_attention, plan

    def qkv(b, h, hkv, s, d, dtype=torch.float32):
        return tuple(torch.randn(shape, generator=gen).to(dev, dtype)
                     for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d)))

    cases = [("causal (2,4,2,256,64)", qkv(2, 4, 2, 256, 64), {"causal": True}, 2e-5),
             ("ragged (1,4,1,300,64)", qkv(1, 4, 1, 300, 64), {"causal": True}, 2e-5),
             ("window 128 (2,2,2,256,64)", qkv(2, 2, 2, 256, 64),
              {"causal": True, "window": 128}, 2e-5),
             ("non-causal (1,8,4,384,128)", qkv(1, 8, 4, 384, 128), {"causal": False}, 2e-5),
             ("bf16 (1,2,2,128,64)", qkv(1, 2, 2, 128, 64, torch.bfloat16), {}, 2e-2),
             ("non-causal ragged (1,4,2,200,64)", qkv(1, 4, 2, 200, 64), {"causal": False}, 2e-5)]
    err, case_errs = 0.0, {}
    for name, (q, k, v), kw, atol in cases:
        e = _max_err(flash_attention(q, k, v, **kw), attention_reference(q, k, v, **kw))
        err, case_errs[name] = max(err, e), e
        print(f"[flash_attention] {name} {kw}: max_abs_err {e:.3g} (atol {atol:g})", flush=True)
        if not e <= atol:
            fail(f"flash_attention {name} disagrees with its plain version")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for s, d in FA_ROWS:
        q = torch.randn(1, s, FA_HEADS, d, generator=gen).to(dev).transpose(1, 2)
        k, v = (torch.randn(1, s, FA_KV_HEADS, d, generator=gen).to(dev).transpose(1, 2)
                for _ in range(2))
        tile = plan(1, FA_HEADS, FA_KV_HEADS, s, d, n_sms)

        def kernel():
            return flash_attention(q, k, v)

        def lib():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

        want = attention_reference(q, k, v)
        e, lib_e = _max_err(kernel(), want), _max_err(lib(), want)
        del want
        err, case_errs[f"llama prefill S={s} D={d}"] = max(err, e), e
        if not e <= 2e-5:
            fail(f"flash_attention at S={s} D={d} off by {e:.3g}")
        iters = 200 if s <= 512 else 20 if s * d <= 4096 * 128 else 5
        ms, dev_ms = timed(kernel, iters), cold_device_ms(kernel)
        host = host_ms(kernel, iters=50, warmup=5)
        plain_ms = timed(lambda: attention_reference(q, k, v), 2, warmup=1)
        lib_ms, lib_dev_ms = timed(lib, iters), cold_device_ms(lib)
        torch.cuda.empty_cache()
        pairs = s * (s + 1) / 2  # live (query, key) pairs under the causal mask
        flops = 4.0 * FA_HEADS * pairs * d
        b_ms, b_by = bound(4.0 * 2 * s * d * (FA_HEADS + FA_KV_HEADS), flops)
        rows.append({"seq": s, "head_dim": d, "tile": tile._asdict(), "ms": ms,
                     "device_ms": dev_ms, "host_ms": host, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "library_device_ms": lib_dev_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "max_abs_err": e, "library_max_abs_err": lib_e,
                     "tflops": flops / ms / 1e9, "device_tflops": flops / dev_ms / 1e9})
        print(f"[flash_attention] llama prefill B1 H{FA_HEADS} HKV{FA_KV_HEADS} D{d} S{s} "
              f"causal fp32, tile {tile.rows} rows = {tile.heads_per_cta} heads x "
              f"{tile.positions} positions, {tile.ctas} CTAs: err {e:.3g}; kernel {ms:.4f} ms "
              f"({rows[-1]['tflops']:.2f} TFLOP/s), device {dev_ms:.4f} ms with L2 flushed, "
              f"host {host:.4f} ms; plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms "
              f"(device {lib_dev_ms:.4f}, err {lib_e:.3g}), bound {b_ms:.4f} ms ({b_by})",
              flush=True)
        del q, k, v
    return {"rows": rows, "err": err, "case_errs": case_errs}


def phase_ssd_scan(dev, gen) -> dict:
    """(6b) ssd_scan against its chunked plain version (y and the final
    state, rel 1e-4: the registry's compare, ``ssd_scan/ops.py:126-127``)
    on the registry's three examples (``ops.py:112-123``) and at
    mamba2-780m's prefill shape, x / b / c read as views of one projection
    as ``ssm_apply`` splits them; each of the four stage kernels against its
    plain stage there (rel 1e-4, fed the plain outputs of the stages before
    it); timed, each stage beside the total, the plain version and the
    bound; and, not gated, the deviation of the kernel and of the chunked
    plain version from a float64 run of the sequential oracle at the model's
    decays.  No single PyTorch call computes the scan."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import ops, ref
    from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_chunked, ssd_scan_reference

    def rel(got, want) -> float:
        return float((got.double() - want.double()).abs().max() / want.double().abs().max())

    def check(name, args) -> float:
        (y, st), (wy, wst) = (ssd_scan(*args, return_state=True),
                              ssd_scan_chunked(*args, return_state=True))
        r = max(rel(y, wy), rel(st, wst))
        e = max(_max_err(y, wy), _max_err(st, wst))
        print(f"[ssd_scan] {name}: y and state rel err {r:.3g} (rel 1e-4), max_abs_err "
              f"{e:.3g}", flush=True)
        if not r <= 1e-4:
            fail(f"ssd_scan {name} disagrees with its plain version")
        return e

    def decay_inputs(bsz, s, h):
        dt = F.softplus(torch.randn(bsz, s, h, generator=gen))
        return dt.to(dev), (-torch.exp(torch.randn(h, generator=gen) * 0.5)).to(dev)

    err = 0.0
    for bsz, s, h, p, g, n in ((2, 320, 4, 64, 2, 32), (1, 128, 2, 32, 1, 16),
                               (1, 96, 2, 32, 1, 16)):
        x = torch.randn(bsz, s, h, p, generator=gen).to(dev)
        dt, a = decay_inputs(bsz, s, h)
        b, c = ((torch.randn(bsz, s, g, n, generator=gen) / n**0.5).to(dev) for _ in range(2))
        err = max(err, check(f"({bsz},{s},{h},{p}) g{g} n{n}", (x, dt, a, b, c)))
    s, h, p, n = MAMBA_PROMPT, SSD_HEADS, SSD_DIM, SSD_STATE
    xbc = torch.randn(1, s, h * p + 2 * n, generator=gen)
    xbc[..., h * p:] /= n**0.5
    xbc = xbc.to(dev)
    x = xbc[..., :h * p].reshape(1, s, h, p)
    b = xbc[..., h * p:h * p + n].reshape(1, s, 1, n)
    c = xbc[..., h * p + n:].reshape(1, s, 1, n)
    dt, a = decay_inputs(1, s, h)
    args = (x, dt, a, b, c)
    err = max(err, check(f"mamba2-780m prefill x {tuple(x.shape)} b/c {tuple(b.shape)}", args))
    # the model's own decays: ssm_init's a = -linspace(1, 16) and dt =
    # softplus(dt_raw + 0), so cumulative log decays reach about -2000 per chunk
    model_dt = F.softplus(torch.randn(1, s, h, generator=gen)).to(dev)
    model_a = -torch.linspace(1.0, 16.0, h, device=dev)
    model_args = (x, model_dt, model_a, b, c)
    err = max(err, check("mamba2-780m prefill, the model's decays a = -linspace(1, 16)",
                         model_args))

    # each stage kernel's launcher, on the operands ssd_scan checks and
    # hands it, against its plain stage fed the plain outputs of the stages
    # before it (the fp32 workspaces made contiguous, as the kernels write
    # them), at the prefill shape
    ops._check_cuda(x, dt, a, b, c)
    xr, dtr, br, cr = ops._rows(x, dt, b, c)
    cb = ref.ssd_chunk_scores(br, cr).contiguous()
    st, cum = (t.contiguous() for t in ref.ssd_chunk_state(xr, dtr, a, br))
    h_prev, final = (t.contiguous() for t in ref.ssd_state_passing(st, cum))
    stages = {"chunk_scores": (lambda: ops._scores(br, cr), cb),
              "chunk_state": (lambda: ops._state(xr, dtr, a, br), (st, cum)),
              "state_passing": (lambda: ops._passing(st, cum), (h_prev, final)),
              "chunk_scan": (lambda: ops._scan(xr, dtr, cr, cb, cum, h_prev),
                             ref.ssd_chunk_scan(xr, dtr, cr, cb, cum, h_prev))}
    stage_rows = {}
    for name, (fn, want) in stages.items():
        got = fn()
        pairs = list(zip(got, want)) if isinstance(want, tuple) else [(got, want)]
        r = max(rel(g_, w_) for g_, w_ in pairs)
        e = max(_max_err(g_, w_) for g_, w_ in pairs)
        err = max(err, e)
        print(f"[ssd_scan] stage {name}: rel err {r:.3g} (rel 1e-4) against its plain stage",
              flush=True)
        if not r <= 1e-4:
            fail(f"ssd_scan stage {name} disagrees with its plain stage")
        stage_rows[name] = {"rel_err": r, "max_abs_err": e,
                            "device_ms": cold_device_ms(fn)}
    del cb, st, cum, h_prev, final, stages

    ms = timed(lambda: ssd_scan(*args, return_state=True), 20)
    dev_ms = cold_device_ms(lambda: ssd_scan(*args, return_state=True))
    plain_ms = timed(lambda: ssd_scan_chunked(*args, return_state=True), 5, warmup=1)
    nc = -(-s // SSD_CHUNK)
    # live (t, j <= t) pairs over the S real steps; C·B^T once for the one
    # group, and per head the masked scores @ x, the chunk state and C @ h_prev
    pairs = sum(l * (l + 1) / 2 for l in (min(SSD_CHUNK, s - i) for i in range(0, s, SSD_CHUNK)))
    flops = 2.0 * (pairs * n + h * (pairs * p + 2 * s * n * p))
    nbytes = 4.0 * (2 * s * h * p + 2 * s * n + s * h + h + h * n * p)
    b_ms, b_by = bound(nbytes, flops)
    print(f"[ssd_scan] mamba2-780m prefill: kernel {ms:.4f} ms a call, {dev_ms:.4f} ms of "
          f"device time with L2 flushed ({flops / ms / 1e9:.2f} TFLOP/s a call; stages' device "
          "ms " + ", ".join(f"{k} {v['device_ms']:.4f}" for k, v in stage_rows.items())
          + f"), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)

    # which drifts from the recurrence: the kernel or the chunked plain
    # version, against a float64 run of the sequential oracle (not gated)
    y64 = ssd_scan_reference(*(t.double() for t in model_args))
    drift = {"kernel": rel(ssd_scan(*model_args), y64),
             "ssd_scan_chunked": rel(ssd_scan_chunked(*model_args), y64)}
    del y64
    print(f"[ssd_scan] the model's decays against the float64 sequential oracle: kernel rel "
          f"{drift['kernel']:.3g}, ssd_scan_chunked rel {drift['ssd_scan_chunked']:.3g} "
          f"(printed, not gated)", flush=True)
    return {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": err, "stages": stage_rows,
            "float64_oracle_rel": drift,
            "shape": f"x {tuple(x.shape)}, b/c {tuple(b.shape)}, {nc} chunks, with the final "
                     "state"}


def phase_serve(dev, arch: str, slots: int, requests: int, prompt: int, needed: tuple,
                tag: str, late: int = 0) -> dict:
    """(6c/6d) full-width ``arch`` served in quant_sparse, gen GEN, through
    ``serve_session``; the counters are zeroed just before and read just
    after, and every kernel in ``needed`` must have launched.  ``late``
    more requests with an admission deadline of 0 ticks queue behind the
    full pool: each must be shed with ``"deadline"`` and no tokens."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serve_session, serving_config, synthetic_prompts
    from repro_torch.serving.engine import ServingEngine

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    if late:
        # serve_session's own body (launch/serve.py), which takes no
        # deadline, with the late requests submitted after its own
        cfg = get_arch(arch).resolve(False)
        engine = ServingEngine(cfg, serving_config("quant_sparse"), n_slots=slots,
                               max_len=prompt + GEN + 1, seed=0, device=dev)
        for i, p in enumerate(synthetic_prompts(requests + late, prompt, cfg.vocab, 0)):
            engine.submit_prompt(p, GEN, seed=i, deadline_ticks=0 if i >= requests else None)
        out = engine.run()
    else:
        out = serve_session(arch, reduced=False, mode="quant_sparse", slots=slots,
                            queue=requests, prompt_len=prompt, gen=GEN, seed=0, device=dev)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    served, shed = out["per_request"][:requests], out["per_request"][requests:]
    done = [r for r in served if r["n_tokens"] == GEN]
    print(f"[{tag}] {arch} quant_sparse {slots} slots, prompt {prompt}: {len(done)}/{requests} "
          f"requests with {GEN} tokens, finite={out['finite']}, prefill "
          f"{out['prefill_s'] / requests:.3f} s per request, tokens_per_s="
          f"{out['tokens_per_s']:.2f}, decode_s={out['decode_s']:.3f}, decode_steps="
          f"{out['decode_steps']}, peak {peak / 2**30:.2f} GiB, wall {wall:.1f}s", flush=True)
    print(f"[{tag}] launches {launches}", flush=True)
    if len(done) != requests or not out["finite"]:
        fail(f"{tag} phase: not every request finished with finite logits")
    if late:
        print(f"[{tag}] {late} requests with deadline_ticks=0 behind the full pool: "
              f"{[(r['rid'], r['rejected'], r['n_tokens']) for r in shed]}, "
              f"{out['elastic']}", flush=True)
        if any(r["rejected"] != "deadline" or r["tokens"] for r in shed) \
                or out["elastic"]["n_rejected"] != late:
            fail(f"{tag} phase: the late requests were not shed with 'deadline' and no tokens")
    for name in needed:
        if launches[name] <= 0:
            fail(f"{tag} phase never launched the {name} kernel")
    res = {k: v for k, v in out.items() if k != "per_request"}
    res.update(tokens=[r["tokens"] for r in out["per_request"]], launches=launches,
               peak_mem_bytes=peak, wall_s=wall,
               prefill_s_per_request=out["prefill_s"] / requests)
    return res


def check_lm_card_vs_cpu(dev, gen, arch: str, prompt_len: int) -> dict:
    """The reduced ``arch`` on the card against the same model on the CPU
    (plain versions): prefill logits of two rows, then one decode step.
    Logits of a 3-4 layer model: the fp32 sums of kernel and plain version
    differ in order, which moves a quantized activation by one 2**-16 step
    at most, far below 1e-3 at the logits."""
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serving_config
    from repro_torch.models.layers import SpringContext
    from repro_torch.models.lm import lm_decode_step, lm_init, lm_prefill, pad_cache

    cfg = get_arch(arch).resolve(reduced=True)
    ctx = SpringContext(cfg=serving_config("quant_sparse"))
    p_cpu = lm_init(cfg, 0, device="cpu")

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, device) for v in tree]
        return tree.to(device)

    toks = torch.randint(0, cfg.vocab, (2, prompt_len), generator=gen)
    lg_cpu, c_cpu = lm_prefill(p_cpu, cfg, toks, ctx)
    lg_gpu, c_gpu = lm_prefill(to(p_cpu, dev), cfg, toks.to(dev), ctx)
    nxt = lg_cpu.argmax(-1)
    d_cpu, _ = lm_decode_step(p_cpu, cfg, nxt, pad_cache(c_cpu, 1), ctx)
    d_gpu, _ = lm_decode_step(to(p_cpu, dev), cfg, nxt.to(dev), pad_cache(c_gpu, 1), ctx)
    e_pre = float((lg_gpu.cpu() - lg_cpu).abs().max())
    e_dec = float((d_gpu.cpu() - d_cpu).abs().max())
    print(f"[check] reduced {arch} card vs CPU, prompt {prompt_len}: prefill logits "
          f"max_abs_err={e_pre:.3g}, decode {e_dec:.3g} (atol 1e-3), argmax equal "
          f"{bool(torch.equal(lg_gpu.argmax(-1).cpu(), nxt))}", flush=True)
    if not (e_pre <= 1e-3 and e_dec <= 1e-3):
        fail(f"the reduced {arch} on the card disagrees with the CPU plain versions")
    return {"prefill_max_abs_err": e_pre, "decode_max_abs_err": e_dec}


def profile_prefill(dev, arch: str, prompt: int) -> dict:
    """(6f) one full-width ``arch`` prefill of ``prompt`` tokens under
    torch.profiler, after one warm-up prefill: device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serving_config
    from repro_torch.models.layers import SpringContext
    from repro_torch.models.lm import lm_init, lm_prefill

    torch.cuda.empty_cache()
    cfg = get_arch(arch).resolve(False)
    params = lm_init(cfg, 0, device=dev)
    ctx = SpringContext(cfg=serving_config("quant_sparse"))
    toks = torch.randint(0, cfg.vocab, (1, prompt),
                         generator=torch.Generator().manual_seed(1)).to(dev)
    lm_prefill(params, cfg, toks, ctx)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        lm_prefill(params, cfg, toks, ctx)
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    rows = device_time_by_kernel(prof)
    busy = sum(r[1] for r in rows)
    tag = f"prefill-profile {arch} {prompt}"
    if busy == 0:
        print(f"[{tag}] {wall_ms:.1f} ms wall; device time not measured", flush=True)
    else:
        print(f"[{tag}] {wall_ms:.1f} ms wall (profiled), device busy {busy:.1f} ms = "
              f"{busy / wall_ms:.1%}; top kernels:", flush=True)
        for name, ms, n in rows[:12]:
            print(f"[{tag}]   {ms:9.2f} ms  x{n:<5d} {name[:90]}", flush=True)
    del params
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "kernels": [{"name": n, "ms": ms, "calls": c} for n, ms, c in rows[:40]]}


# -- slice 9: the rest of the serving engine ---------------------------------------

# 6g: llama3.2-1b with 8 requests of prompt 512 over 4 slots (a rescale to 2
# spills two of them), mamba2-780m with 6 of prompt 256; gen GEN
SURVIVE_SLOTS, SURVIVE_REQUESTS, SURVIVE_PROMPT = 4, 8, 512
SURVIVE_SAMPLED = 4  # requests of the sampled-decode runs
SURVIVE_MAMBA_REQUESTS, SURVIVE_MAMBA_PROMPT = 6, 256
SURVIVE_KERNELS = ("masked_matmul_skinny", "masked_matmul", "tile_occupancy",
                   "flash_attention", "mask_pack")
SURVIVE_MAMBA_KERNELS = ("masked_matmul_skinny", "masked_matmul", "tile_occupancy", "ssd_scan")


def _bytes_by_part(tree: dict) -> dict:
    """Bytes of a pool or a slot payload by part: the KV leaves' values,
    mask words and nnz, and the dense leaves (``pos`` and SSM state)."""
    from repro_torch.serving.kvpool import PackedKV

    out = dict.fromkeys(("values", "mask", "nnz", "dense"), 0)
    for node in tree.values():
        for leaf in (node.values() if isinstance(node, dict) else [node]):
            if isinstance(leaf, PackedKV):
                leaf = {part: getattr(leaf, part) for part in ("values", "mask", "nnz")}
            if isinstance(leaf, dict):
                for part, x in leaf.items():
                    out[part] += x.nbytes
            else:
                out["dense"] += leaf.nbytes
    out["total"] = sum(out.values())
    return out


def _decode_logits(engine, slots: list, width: int):
    """Decode logits of the engine's ``slots`` computed in a pool of ``width``
    slots holding their exact packed bits (slot i of it = slots[i]) and
    nothing else, with each slot's next token fed: the engine's own decode
    step, unpack to repack."""
    import torch

    from repro_torch.serving import kvpool

    pool = kvpool.init_pool(engine.cfg, width, engine.max_len, device=engine.device)
    tokens = torch.zeros(width, dtype=torch.int64)
    for i, slot in enumerate(slots):
        kvpool.restore_slot_packed(pool, kvpool.extract_slot_packed(engine.pool, slot), i)
        tokens[i] = int(engine._next_tok[slot])
    logits, _ = engine._decode(engine.params, tokens.to(engine.device),
                               kvpool.unpack_cache(pool))
    return logits[:len(slots)].float().cpu()


def _batch_invariance(engine, tag: str) -> dict:
    """Slots 0 and 1's decode logits in a pool of 4 slots (all four
    resident) and of 2 (those two alone): the largest difference and
    whether the bits agree."""
    import torch

    four = _decode_logits(engine, [0, 1, 2, 3], 4)[:2]
    two = _decode_logits(engine, [0, 1], 2)
    diff = float((four - two).abs().max())
    equal = bool(torch.equal(four, two))
    print(f"[survive] {tag}: decode logits of slots 0-1 at 4 slots vs at 2 slots: max |diff| "
          f"= {diff:.3g}, bit-equal {equal}", flush=True)
    if not equal:
        fail(f"survive phase: {tag}'s decode logits depend on the number of slots")
    return {"max_abs_diff": diff, "bit_equal": equal}


def _survive_model(dev, arch: str, requests: int, prompt: int, schedule: list, tag: str,
                   roundtrip: bool, needed: tuple) -> tuple:
    """One model of 6g: the oracle run, then the same requests under
    ``schedule`` through ChaosHarness (a kill builds a fresh engine over the
    same parameter tensors); every request's tokens must equal the oracle's
    and requests must have spilled and resumed.  With ``roundtrip`` an
    explicit snapshot -> .npz -> load -> restore at tick 3 is timed first.
    The launch counters are zeroed just before the chaos run and read just
    after it; each kernel in ``needed`` must have launched there.  Returns
    the report and ``submitted(n, greedy)``, which builds an engine over the
    model with its first ``n`` requests queued."""
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serving_config, synthetic_prompts
    from repro_torch.models.lm import lm_init
    from repro_torch.serving import kvpool
    from repro_torch.serving.elastic import ChaosHarness, load_snapshot, save_snapshot
    from repro_torch.serving.engine import ServingEngine

    torch.cuda.empty_cache()
    cfg = get_arch(arch).resolve(False)
    params = lm_init(cfg, 0, device=dev)
    prompts = synthetic_prompts(requests, prompt, cfg.vocab, 0)

    def make(greedy: bool = True):
        return ServingEngine(cfg, serving_config("quant_sparse"), params=params,
                             n_slots=SURVIVE_SLOTS, max_len=prompt + GEN + 1, greedy=greedy,
                             spec_hash=f"chip-smoke-{arch}", device=dev)

    def submitted(n: int = requests, greedy: bool = True):
        eng = make(greedy)
        for i, p in enumerate(prompts[:n]):
            eng.submit_prompt(p, GEN, seed=i)
        return eng

    def tokens(out) -> list:
        return [r["tokens"] for r in out["per_request"]]

    res: dict = {"arch": arch, "requests": requests, "prompt": prompt,
                 "schedule": [(e.at, e.kind, e.slots) for e in schedule]}
    t0 = time.monotonic()
    oracle = submitted().run()
    res["oracle_s"] = time.monotonic() - t0
    res["oracle_tokens_per_s"] = oracle["tokens_per_s"]
    want = tokens(oracle)
    if not oracle["finite"] or any(len(t) != GEN for t in want):
        fail(f"survive phase: {tag}'s uninterrupted run did not finish every request")

    eng = submitted()
    for _ in range(3):
        eng.step()
    res["pool_bytes"] = _bytes_by_part(eng.pool)
    res["payload_bytes"] = _bytes_by_part(kvpool.extract_slot_packed(eng.pool, 0))
    res["batch_invariance"] = _batch_invariance(eng, tag)
    if roundtrip:
        path = ROOT / "build" / f"survive_{arch}.npz"
        path.parent.mkdir(exist_ok=True)
        t1 = time.monotonic()
        snap = eng.snapshot()
        t2 = time.monotonic()
        save_snapshot(snap, str(path))
        t3 = time.monotonic()
        loaded = load_snapshot(str(path))
        t4 = time.monotonic()
        eng.restore(loaded)
        torch.cuda.synchronize()
        t5 = time.monotonic()
        res.update(snapshot_s=t2 - t1, save_s=t3 - t2, load_s=t4 - t3, restore_s=t5 - t4,
                   npz_bytes=path.stat().st_size)
        path.unlink()
        print(f"[survive] {tag}: .npz round trip at tick 3: {res['npz_bytes']} bytes, snapshot "
              f"{res['snapshot_s']:.3f} s, save {res['save_s']:.3f} s, load {res['load_s']:.3f} s, "
              f"restore {res['restore_s']:.3f} s", flush=True)
    harness = ChaosHarness(eng, schedule, make_engine=make, max_steps=500)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t1 = time.monotonic()
    out = harness.run()
    torch.cuda.synchronize()
    res["chaos_s"] = time.monotonic() - t1
    res["launches"] = kernels.launch_counts()
    print(f"[survive] {tag}: launches in the chaos run {res['launches']}", flush=True)
    for name in needed:
        if res["launches"][name] <= 0:
            fail(f"survive phase: {tag}'s chaos run never launched the {name} kernel")
    got = tokens(out)
    res["elastic"] = out["elastic"]
    res["tokens_equal"] = got == want
    print(f"[survive] {tag}: {requests} requests, prompt {prompt}, {SURVIVE_SLOTS} slots; oracle "
          f"{res['oracle_s']:.1f} s ({oracle['tokens_per_s']:.1f} tokens/s); chaos "
          f"{res['schedule']} {res['chaos_s']:.1f} s: tokens equal {res['tokens_equal']}, "
          f"{out['elastic']}", flush=True)
    if not res["tokens_equal"]:
        fail(f"survive phase: {tag}'s tokens under chaos differ from the uninterrupted run's")
    if out["elastic"]["n_spills"] <= 0 or out["elastic"]["n_resumes"] <= 0:
        fail(f"survive phase: {tag}'s chaos schedule did not both spill and resume")
    print(f"[survive] {tag}: bytes of the pool {res['pool_bytes']}, of one slot's payload "
          f"{res['payload_bytes']}", flush=True)
    res["spill_resume"] = _time_spill_resume(submitted(SURVIVE_SLOTS), want[:SURVIVE_SLOTS], tag)
    res["oracle_tokens"] = want
    return res, submitted


def _time_spill_resume(eng, want: list, tag: str, reps: int = 5) -> dict:
    """One ``_spill_slot`` and one ``_resume_one`` (through the admit phase,
    whose only work is the resume), each ending at a device sync, ``reps``
    times on slot 0 of a full pool after one tick; then the run finishes
    with the uninterrupted run's tokens."""
    import torch

    eng.step()
    spill, resume = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        eng._spill_slot(0)
        torch.cuda.synchronize()
        t1 = time.monotonic()
        eng._admit_phase()
        torch.cuda.synchronize()
        spill.append((t1 - t0) * 1e3)
        resume.append((time.monotonic() - t1) * 1e3)
    got = [r["tokens"] for r in eng.run()["per_request"]]
    print(f"[survive] {tag}: _spill_slot {min(spill):.2f} ms (min of {reps}; "
          f"mean {sum(spill) / reps:.2f}), _resume_one {min(resume):.2f} ms (mean "
          f"{sum(resume) / reps:.2f}); tokens after {reps} spills equal {got == want}", flush=True)
    if got != want:
        fail(f"survive phase: {tag}'s tokens after repeated spills differ")
    return {"spill_ms": spill, "resume_ms": resume}


def phase_survive(dev) -> dict:
    """(6g) spill/resume, live rescale, exact snapshots, the chaos harness,
    sampled decode and telemetry, on full-width llama3.2-1b and
    mamba2-780m; each model's launch counts are those of its chaos run
    alone."""
    import torch

    from repro_torch import telemetry
    from repro_torch.serving.elastic import ChaosEvent, ChaosHarness

    t_phase = time.monotonic()
    llama, submitted = _survive_model(
        dev, "llama3.2-1b", SURVIVE_REQUESTS, SURVIVE_PROMPT,
        [ChaosEvent(2, "roundtrip"), ChaosEvent(4, "rescale", slots=2),
         ChaosEvent(6, "snapshot"), ChaosEvent(9, "rescale", slots=4),
         ChaosEvent(12, "rewind"), ChaosEvent(15, "kill")], "llama3.2-1b", roundtrip=True,
        needed=SURVIVE_KERNELS)

    # sampled decode: twice, then through a snapshot and a rewind
    sampled = []
    for schedule in ([], [], [ChaosEvent(3, "snapshot"), ChaosEvent(8, "rewind")]):
        eng = submitted(SURVIVE_SAMPLED, greedy=False)
        out = ChaosHarness(eng, schedule).run()
        sampled.append([r["tokens"] for r in out["per_request"]])
    greedy_first = llama["oracle_tokens"][:SURVIVE_SAMPLED]
    print(f"[survive] sampled decode, {SURVIVE_SAMPLED} requests: two runs and a rewound one "
          f"equal {sampled[0] == sampled[1] == sampled[2]}; differ from greedy "
          f"{sampled[0] != greedy_first}; first {sampled[0][0][:8]}", flush=True)
    if not sampled[0] == sampled[1] == sampled[2]:
        fail("survive phase: sampled decode gave other tokens on a rerun or after a rewind")

    # telemetry on: the oracle's workload inside a scope
    tel_eng = submitted()
    t0 = time.monotonic()
    with telemetry.scope(telemetry.TelemetryConfig(enabled=True)) as tracer:
        tel_out = tel_eng.run()
        n_spans = len(tracer)
    tel_s = time.monotonic() - t0
    tel_equal = [r["tokens"] for r in tel_out["per_request"]] == llama["oracle_tokens"]
    print(f"[survive] telemetry on: {n_spans} spans, {tel_out['tokens_per_s']:.1f} tokens/s "
          f"against {llama['oracle_tokens_per_s']:.1f} off, run {tel_s:.1f} s against "
          f"{llama['oracle_s']:.1f} s; tokens equal {tel_equal}", flush=True)
    if not tel_equal:
        fail("survive phase: telemetry changed a token")
    del submitted, eng, tel_eng  # the model's parameters go with them
    torch.cuda.empty_cache()

    mamba, submitted = _survive_model(
        dev, "mamba2-780m", SURVIVE_MAMBA_REQUESTS, SURVIVE_MAMBA_PROMPT,
        [ChaosEvent(2, "rescale", slots=2), ChaosEvent(4, "snapshot"),
         ChaosEvent(7, "rescale", slots=4), ChaosEvent(10, "rewind")], "mamba2-780m",
        roundtrip=False, needed=SURVIVE_MAMBA_KERNELS)
    del submitted
    torch.cuda.empty_cache()
    wall = time.monotonic() - t_phase
    print(f"[survive] phase 6g wall {wall:.1f} s", flush=True)
    return {"llama": llama, "mamba2": mamba, "sampled_tokens": sampled,
            "telemetry": {"spans": n_spans, "tokens_per_s": tel_out["tokens_per_s"],
                          "tokens_per_s_off": llama["oracle_tokens_per_s"], "run_s": tel_s,
                          "run_s_off": llama["oracle_s"], "tokens_equal": tel_equal},
            "launches": {name: llama["launches"][name] + mamba["launches"][name]
                         for name in llama["launches"]},
            "wall_s": wall}


# -- slice 4: the kernel sweep and the paper evaluation ----------------------------

# the dangling filter at VGG-19's first activation at batch 32 (the size
# stochastic_round is timed at)
DF_SHAPE = (VGG_BATCH, VGG_HW, VGG_HW, 64)
SWEEP_KERNELS = ("masked_matmul", "masked_matmul_dx", "masked_matmul_dw", "tile_occupancy",
                 "mask_pack", "dangling_filter", "stochastic_round", "flash_attention",
                 "ssd_scan")
PAPER_KERNELS = ("masked_matmul", "masked_matmul_dx", "masked_matmul_dw")


def phase_dangling_filter(dev, gen) -> dict:
    """(7a) dangling_filter bit for bit against its plain version on the
    table's examples, on -0.0 / NaN / inf entries at a length that is not a
    multiple of 4 (the scalar tail), on an unaligned view, in bf16, and at
    32 x 224 x 224 x 64 fp32; then timed there beside its plain version and
    its bound."""
    import torch

    from repro_torch.kernels import registry
    from repro_torch.kernels.mask_compress.ops import dangling_filter, dangling_filter_reference

    def bits(t):
        return t.view(torch.int32) if t.element_size() == 4 else t.view(torch.int16)

    err = 0.0  # max |kernel - plain| over every case (NaN positions equal)

    def check(name, a, w) -> None:
        nonlocal err
        got, want = dangling_filter(a, w), dangling_filter_reference(a, w)
        torch.cuda.synchronize()
        for g, p in zip(got, want):
            if g.dtype != p.dtype or g.shape != p.shape or not torch.equal(bits(g), bits(p)):
                fail(f"dangling_filter {name} differs from its plain version")
            err = max(err, float((g.float() - p.float()).nan_to_num(0.0).abs().max()))
        print(f"[dangling_filter] {name}: bit-equal to the plain version", flush=True)

    for i, ((a, w), _) in enumerate(registry.op_spec("dangling_filter").examples()):
        check(f"example {i} {tuple(a.shape)}", a.to(dev), w.to(dev))
    n = 4099  # 1024 16-byte vectors and a 3-element tail
    a = torch.randn(n, generator=gen) * (torch.rand(n, generator=gen) > 0.4)
    w = torch.randn(n, generator=gen) * (torch.rand(n, generator=gen) > 0.4)
    a[::5], w[::7] = -0.0, -0.0
    a[1::11], w[2::13] = float("nan"), float("nan")
    a[3::17], w[4::19] = float("inf"), float("-inf")
    a[-3:], w[-3:] = torch.tensor([float("nan"), -0.0, 1.5]), torch.tensor([2.0, 3.0, -0.0])
    a, w = a.to(dev), w.to(dev)
    check(f"-0.0 / NaN / inf, length {n}", a, w)
    check(f"unaligned views, length {n - 1}", a[1:], w[1:])
    check(f"bf16, length {n}", a.to(torch.bfloat16), w.to(torch.bfloat16))
    del a, w
    cgen = torch.Generator(device=dev).manual_seed(0)
    a = torch.relu(torch.randn(DF_SHAPE, device=dev, generator=cgen))
    w = torch.randn(DF_SHAPE, device=dev, generator=cgen)
    w *= torch.rand(DF_SHAPE, device=dev, generator=cgen) > 0.5
    check(f"{DF_SHAPE} fp32", a, w)
    ms = timed(lambda: dangling_filter(a, w), 20)
    plain_ms = timed(lambda: dangling_filter_reference(a, w), 5, warmup=1)
    # two fp32 reads and two fp32 writes per element; two tests, an AND and
    # two selects
    b_ms, b_by = bound(16.0 * a.numel(), 5.0 * a.numel())
    print(f"[dangling_filter] {DF_SHAPE} fp32: kernel {ms:.4f} ms "
          f"({16.0 * a.numel() / ms / 1e6:.0f} GB/s), plain {plain_ms:.4f} ms, bound "
          f"{b_ms:.4f} ms ({b_by}), {ms / b_ms:.2f}x the bound", flush=True)
    del a, w
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": err, "shape": f"{DF_SHAPE} fp32, ReLU-sparse a, half-sparse w"}


def phase_sweep(dev) -> dict:
    """(7b) the kernel parity sweep, ``bench_kernels.smoke_rows`` on the
    card: every op of the table, its kernel against its plain version on
    every example under the op's compare; counters zeroed just before and
    read just after, every kernel of the sweep must have launched."""
    import torch

    from repro_torch import kernels
    from repro_torch.benchmarks.bench_kernels import smoke_rows

    kernels.reset_launch_counts()
    t0 = time.monotonic()
    rows, failures = smoke_rows(dev)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = kernels.launch_counts()
    for name, us, worst, route, n in rows:
        print(f"[sweep] {name.split('.')[2]:17s} {route:5s} {n} cases, worst deviation "
              f"{worst:.3g}, {'kernel' if route == 'cuda' else 'plain'} "
              f"{us / 1e3:.4f} ms per case", flush=True)
    print(f"[sweep] {wall:.1f}s, launches {launches}", flush=True)
    for f in failures:
        print(f"[sweep] FAILURE {f}", file=sys.stderr, flush=True)
    if failures:
        fail(f"the kernel sweep failed on {len(failures)} op(s)")
    for name in SWEEP_KERNELS:
        if launches[name] <= 0:
            fail(f"the kernel sweep never launched the {name} kernel")
    return {"rows": [dict(zip(("name", "us_per_case", "worst", "route", "cases"), r))
                     for r in rows], "launches": launches, "wall_s": wall}


def phase_paper(dev) -> dict:
    """(7c) the paper's evaluation path: ``sparsity_probe`` on the card's
    kernels (counters zeroed just before and read just after), then Table 1
    and the Figs. 11-16 geomeans of the model with and without the measured
    skip fractions, beside the paper's."""
    import math

    from repro_torch import kernels
    from repro_torch.benchmarks import bench_paper_figs, bench_table1
    from repro_torch.kernels.masked_matmul.backward import sparsity_probe

    kernels.reset_launch_counts()
    probe = sparsity_probe(density=0.5, size=512, device=dev)
    launches = kernels.launch_counts()
    print(f"[paper] sparsity_probe(density=0.5, size=512) on the card: {probe}; "
          f"launches {launches}", flush=True)
    skips = (probe["forward_tile_skip"], probe["backward_tile_skip"])
    if not all(v is not None and 0.0 <= v < 1.0 for v in skips):
        fail(f"sparsity_probe measured no valid skip fraction: {probe}")
    for name in PAPER_KERNELS:
        if launches[name] <= 0:
            fail(f"sparsity_probe never launched the {name} kernel")
    table1 = bench_table1.rows()
    print("[paper] Table 1: " + ", ".join(f"{n.split('.')[1]} {v:g}" for n, _, v in table1),
          flush=True)

    def geomeans(rows, tag):
        return {n.rsplit(".", 1)[0]: v for n, _, v in rows if n.endswith("." + tag)}

    analytic = bench_paper_figs.rows()
    measured = bench_paper_figs.rows(compute_skip_fraction=skips[0],
                                     backward_skip_fraction=skips[1])
    model, grounded = geomeans(analytic, "GEOMEAN"), geomeans(measured, "GEOMEAN")
    paper = geomeans(analytic, "PAPER_GEOMEAN")
    for fig in model:
        print(f"[paper] {fig} geomean: model {model[fig]:.4f}, with the measured skips "
              f"{grounded[fig]:.4f}, paper {paper[fig]:g}", flush=True)
    if not all(math.isfinite(v) and v > 0 for v in (*model.values(), *grounded.values())):
        fail("the paper figures' geomeans are not finite and positive")
    return {"probe": probe, "launches": launches, "table1": {n: v for n, _, v in table1},
            "geomean_model": model, "geomean_measured_skips": grounded, "geomean_paper": paper,
            "rows_measured_skips": [list(r) for r in measured]}


def main() -> None:
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"the port's sources are not next to this script ({SRC / 'repro_torch'})")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    report: dict = {"device": torch.cuda.get_device_name(0)}

    from repro_torch import kernels
    from repro_torch.core.fixedpoint import quantize_nearest
    from repro_torch.kernels import cuda
    from repro_torch.kernels.masked_matmul.ops import (
        KERNEL_TILES, launch_skinny, launch_tile, masked_matmul, masked_matmul_reference, route,
        tile_occupancy, tile_occupancy_reference, tile_skip_fraction)

    # -- 1. build -------------------------------------------------------------
    t0 = time.monotonic()
    built = cuda.build()
    build_s = time.monotonic() - t0
    for name, info in built.items():
        for line in info["ptxas"]:
            print(f"[build] {name}: {line.strip()}")
    print(f"[build] {sorted(built) or 'already built'} from {cuda.CSRC} in {build_s:.1f}s "
          f"(nvcc {cuda.nvcc_path()})", flush=True)
    report["build_s"] = build_s
    tiles = KERNEL_TILES

    gen = torch.Generator(device="cpu").manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    tm, tn, tk = tiles

    def check_occupancy(a, tile_rows: int, tile_cols: int) -> tuple:
        """masked_matmul's occupancy pre-pass kernel against its plain
        version, exact: (max |kernel - plain| over the flags, empty tiles)."""
        got = tile_occupancy(a, tile_rows, tile_cols)
        want = tile_occupancy_reference(a, tile_rows, tile_cols)
        err = int((got - want).abs().max())
        if err:
            fail(f"tile_occupancy {tuple(a.shape)} disagrees with its plain version")
        return err, int((want == 0).sum())

    # -- 2a. masked_matmul, SR on: exact on coarse-grid operands --------------
    # operands shaped like repro/kernels/masked_matmul/ops.py:52-71: values
    # on the 2**-8 grid, so every product and sum is exact in fp32 and the
    # SR epilogue must agree bit for bit
    def coarse(shape, sparsity):
        v = torch.round(torch.randn(shape, generator=gen) * 2**6) / 2**8
        keep = torch.rand(shape, generator=gen) > sparsity
        return (v * keep).to(dev)

    cases = [(coarse((m, k), 0.5), coarse((k, n), 0.5), 5, True)
             for m, k, n in [(128, 128, 128), (100, 70, 50), (64, 512, 200)]]
    xp, wp = coarse((256, 384), 0.3), coarse((384, 256), 0.3)
    xp[:128, :256] = 0.0  # whole tiles skipped
    wp[256:, 128:] = 0.0
    cases += [(xp, wp, 3, True), (xp, wp, 3, False)]
    occ_err = 0
    for x, w, seed, sr in cases:
        for a, tr, tc in ((x, tm, tk), (w, tk, tn)):
            occ_err = max(occ_err, check_occupancy(a, tr, tc)[0])
        got = masked_matmul(x, w, seed, apply_sr=sr)
        want = masked_matmul_reference(x, w, seed, apply_sr=sr)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = torch.equal(got, want) if sr else err <= 1e-6
        print(f"[masked_matmul] exact-grid {tuple(x.shape)}@{tuple(w.shape)} sr={sr} "
              f"max_abs_err={err:.3g} skip={tile_skip_fraction(x, w, tiles):.3f} "
              f"{'ok' if ok else 'MISMATCH'}", flush=True)
        if not ok:
            fail(f"masked_matmul SR={sr} disagrees with its plain version on the grid case")

    # -- 2b. masked_matmul, SR off: allclose at the serving path's shapes -----
    # Q4.16 operands; fp32 sums in another order differ by at most
    # gamma_K * (|x| @ |w|) per side, gamma_K ~ K * 2**-24: tolerance
    # 2 * K * 2**-24 * (|x| @ |w|), elementwise.  M = 4 and 32 take the
    # skinny kernel, which must give the tile kernel's bits on the same
    # operands (SR off and on); M = 4096 (a long prompt's prefill) takes
    # the tile kernel.
    mm_rows, mm_err = [], 0.0
    for m in (DECODE_M, PREFILL_M, LONG_PROMPT):
        for name, (k, n) in LAYER_SHAPES.items():
            x = quantize_nearest(randn(m, k))
            w = quantize_nearest(randn(k, n) / k**0.5)
            for a, tr, tc in ((x, tm, tk), (w, tk, tn)):
                occ_err = max(occ_err, check_occupancy(a, tr, tc)[0])
            kernel = route(m, n, k)
            got = masked_matmul(x, w, apply_sr=False)
            want = masked_matmul_reference(x, w, apply_sr=False)
            tol = 2 * k * 2.0**-24 * (x.abs() @ w.abs())
            err = (got - want).abs()
            if not bool((err <= tol).all()):
                fail(f"masked_matmul ({m},{k})@({k},{n}) off by {float(err.max()):.3g}")
            mm_err = max(mm_err, float(err.max()))
            if kernel == "skinny":
                for sr in (False, True):
                    if not torch.equal(launch_skinny(x, w, 7, 4, 16, sr),
                                       launch_tile(x, w, 7, 4, 16, sr)):
                        fail(f"masked_matmul ({m},{k})@({k},{n}) sr={sr}: the skinny and the "
                             "tile kernel disagree")
            del tol, want
            # time against cold weights, as decode finds them: rotate copies
            # of w through more than the 50 MB L2
            copies = [w] + [w.clone() for _ in range(max(1, (256 << 20) // (k * n * 4)))]
            cyc = itertools.cycle(copies)
            iters = 50 if m <= PREFILL_M else 5
            ms = timed(lambda: masked_matmul(x, next(cyc), apply_sr=False), iters)
            plain_ms = timed(lambda: masked_matmul_reference(x, next(cyc), apply_sr=False), iters)
            lib_ms = timed(lambda: torch.matmul(x, next(cyc)), iters)
            # the skinny rows: the tile kernel forced on the same operands
            tile_ms = (timed(lambda: launch_tile(x, next(cyc), 0, 4, 16, False), iters)
                       if kernel == "skinny" else ms)
            # the tile kernel's pre-pass alone: both operands' flags
            occ_ms = timed(lambda: (tile_occupancy(x, tm, tk),
                                    tile_occupancy(next(cyc), tk, tn)), iters)
            occ_plain_ms = timed(lambda: (tile_occupancy_reference(x, tm, tk),
                                          tile_occupancy_reference(next(cyc), tk, tn)), iters)
            n_flags = -(-m // tm) * -(-k // tk) + -(-k // tk) * -(-n // tn)
            occ_b_ms, occ_b_by = bound(4.0 * (m * k + k * n + n_flags), m * k + k * n)
            skip = tile_skip_fraction(x, w, tiles)
            b_ms, b_by = bound(4.0 * (m * k + k * n + m * n), 2.0 * m * n * k * (1 - skip))
            tflops = 2.0 * m * n * k / ms / 1e9
            mm_rows.append({"shape": [m, k, n], "proj": name, "route": kernel, "ms": ms,
                            "plain_ms": plain_ms, "library_ms": lib_ms, "tile_ms": tile_ms,
                            "bound_ms": b_ms, "bound_by": b_by, "tflops": tflops,
                            "max_abs_err": float(err.max()), "skip": skip,
                            "occ_ms": occ_ms, "occ_plain_ms": occ_plain_ms,
                            "occ_bound_ms": occ_b_ms, "occ_bound_by": occ_b_by})
            print(f"[masked_matmul] {name:4s} ({m},{k})@({k},{n}) {kernel} kernel "
                  f"err={float(err.max()):.3g}: {ms:.4f} ms ({tflops:.2f} TFLOP/s), "
                  + (f"tile kernel {tile_ms:.4f} ms (bit-equal), " if kernel == "skinny" else "")
                  + f"plain {plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}); occupancy pre-pass {occ_ms:.4f} ms, plain {occ_plain_ms:.4f} ms, "
                  f"bound {occ_b_ms:.4f} ms ({occ_b_by})", flush=True)
            del copies, x, w, got, err
        torch.cuda.empty_cache()
    report["masked_matmul_shapes"] = mm_rows

    # -- 2b'. block-pruned operands at the widest projection's shape ---------
    # whole tiles of x and w are zero: the pre-pass must flag them empty (an
    # occupancy flag wrongly set would only lose skipping, so it is checked
    # against the plain version) and the product must still agree
    k, n = LAYER_SHAPES["gate"]
    x = quantize_nearest(randn(DECODE_M, k))
    x[:, : k // 4] = 0.0
    keep = (torch.rand(-(-k // tk), -(-n // tn), generator=gen) > 0.5).to(dev)
    keep = keep.repeat_interleave(tk, 0).repeat_interleave(tn, 1)[:k, :n]
    w = quantize_nearest(randn(k, n) / k**0.5) * keep
    empty = 0
    for a, tr, tc in ((x, tm, tk), (w, tk, tn)):
        e, z = check_occupancy(a, tr, tc)
        occ_err, empty = max(occ_err, e), empty + z
    got = masked_matmul(x, w, apply_sr=False)
    want = masked_matmul_reference(x, w, apply_sr=False)
    err = (got - want).abs()
    close = bool((err <= 2 * k * 2.0**-24 * (x.abs() @ w.abs())).all())
    skip = tile_skip_fraction(x, w, tiles)
    print(f"[masked_matmul] block-pruned ({DECODE_M},{k})@({k},{n}): {empty} empty tiles "
          f"flagged as the plain version flags them, skip={skip:.3f} at the kernel's tiles, "
          f"err={float(err.max()):.3g}", flush=True)
    if empty == 0 or skip <= 0.0 or not close:
        fail("masked_matmul on block-pruned operands: no tile skipped or results disagree")
    mm_err = max(mm_err, float(err.max()))

    # -- 2c. mask_pack: both routes exact, timed at the pool's leaves -------
    report["mask_pack"] = mp = phase_mask_pack(dev)

    # -- 3. serve: full-width llama3.2-1b through the port's entry point ------
    from repro_torch.launch.serve import serve_session

    kernels.reset_launch_counts()
    t0 = time.monotonic()
    out = serve_session("llama3.2-1b", reduced=False, mode="quant_sparse", slots=SLOTS,
                        queue=REQUESTS, prompt_len=PROMPT, gen=GEN, seed=0, device=dev)
    torch.cuda.synchronize()
    serve_wall = time.monotonic() - t0
    launches = kernels.launch_counts()
    done = [r for r in out["per_request"] if r["n_tokens"] == GEN]
    print(f"[serve] llama3.2-1b quant_sparse {SLOTS} slots: {len(done)}/{REQUESTS} requests "
          f"with {GEN} tokens, finite={out['finite']}, tokens_per_s={out['tokens_per_s']:.2f}, "
          f"prefill_s={out['prefill_s']:.3f}, decode_s={out['decode_s']:.3f}, "
          f"decode_steps={out['decode_steps']}, wall {serve_wall:.1f}s", flush=True)
    print(f"[serve] launches {launches}; kv wire {out['kv_mean_wire_bytes']:.0f} B/step mean, "
          f"density {out['kv_mean_density']:.3f}, "
          f"{out['kv_traffic_reduction_vs_fp32']:.2f}x less than a dense fp32 pool", flush=True)
    report["serve"] = {k: v for k, v in out.items() if k != "per_request"}
    report["serve"]["tokens"] = [r["tokens"] for r in out["per_request"]]
    report["launches"] = launches
    if len(done) != REQUESTS or not out["finite"]:
        fail("serve phase: not every request finished with finite logits")
    for name in SERVE_KERNELS:
        if launches[name] <= 0:
            fail(f"serve phase never launched the {name} kernel")
    if launches["tile_occupancy"] != 0:
        fail("serve phase (M <= 32 throughout) launched the tile kernel's occupancy pre-pass")
    report["decode_profile"] = profile_decode(dev)

    # -- 4. check: reduced model on the card vs the CPU plain versions --------
    report["check"] = check_lm_card_vs_cpu(dev, gen, "llama3.2-1b", 12)

    # -- 5. slice 2: CNN training ----------------------------------------------
    report["stochastic_round"] = sr = phase_stochastic_round(dev, gen)
    report["backward"] = bwd = phase_backward(dev, gen)
    report["train"] = train = phase_train(dev)
    report["cnn_card_vs_cpu"] = phase_cnn_card_vs_cpu(dev)
    report["arms"] = phase_arms(dev)

    # -- 6. slice 3: long-prompt prefill, Mamba-2 ------------------------------
    report["flash_attention"] = fa = phase_flash_attention(dev, gen)
    report["ssd_scan"] = ssd = phase_ssd_scan(dev, gen)
    report["serve_long"] = serve_long = phase_serve(
        dev, "llama3.2-1b", LONG_SLOTS, LONG_REQUESTS, LONG_PROMPT, LONG_KERNELS, "serve_long")
    report["decode_profile_long"] = profile_decode(dev, LONG_PROMPT, ticks=3)
    report["serve_mamba2"] = serve_mamba2 = phase_serve(
        dev, "mamba2-780m", MAMBA_SLOTS, MAMBA_REQUESTS, MAMBA_PROMPT, MAMBA_KERNELS,
        "serve_mamba2", late=MAMBA_LATE)
    report["check_long"] = {arch: check_lm_card_vs_cpu(dev, gen, arch, CHECK_PROMPT)
                            for arch in ("mamba2-780m", "llama3.2-1b")}
    report["prefill_profile"] = {
        "llama3.2-1b": profile_prefill(dev, "llama3.2-1b", LONG_PROMPT),
        "mamba2-780m": profile_prefill(dev, "mamba2-780m", MAMBA_PROMPT)}

    # -- 6g. slice 9: spill/resume, rescale, snapshots, chaos, sampling --------
    report["survive"] = survive = phase_survive(dev)

    # -- 7. slice 4: the kernel sweep and the paper evaluation -----------------
    report["dangling_filter"] = df = phase_dangling_filter(dev, gen)
    report["sweep"] = sweep = phase_sweep(dev)
    report["paper"] = paper = phase_paper(dev)

    # -- kernel line, card, result -------------------------------------------
    # launches: the sum over the main paths' runs (serve, train, serve_long,
    # serve_mamba2, survive, the kernel sweep, the paper path's probe), each
    # zeroed just before its run and read just after (the comparisons above
    # count in none)
    by_path = {name: {"serve": launches[name], "serve_long": serve_long["launches"][name],
                      "serve_mamba2": serve_mamba2["launches"][name],
                      "survive": survive["launches"][name],
                      "train": train["launches"][name], "sweep": sweep["launches"][name],
                      "paper": paper["launches"][name]}
               for name in launches}
    total = {name: sum(v.values()) for name, v in by_path.items()}

    def bwd_entry(op: str) -> dict:
        rows = [r for r in bwd["rows"] if r["op"] == op]
        return {"name": f"masked_matmul_{op}", "route": "cuda",
                "source": "src/repro_torch/csrc/masked_matmul.cu",
                "replaces": "src/repro/kernels/masked_matmul/backward.py:85",
                "launches": total[f"masked_matmul_{op}"], "max_abs_err": bwd["err"][op],
                "ms": sum(r["ms"] for r in rows), "plain_ms": sum(r["plain_ms"] for r in rows),
                "bound_ms": sum(r["bound_ms"] for r in rows),
                # the kind that bounds most of the summed bound
                "bound_by": max(("operations", "bytes"), key=lambda by: sum(
                    r["bound_ms"] for r in rows if r["bound_by"] == by)),
                "library_ms": sum(r["library_ms"] for r in rows),
                "shape": f"VGG-19 batch {VGG_BATCH} backward {op} of c0_1 + c3_0 + fc6 "
                         "(per-layer rows, each with its route, in chip_smoke.json)",
                "launches_by_path": by_path[f"masked_matmul_{op}"]}

    decode_rows = [r for r in mm_rows if r["shape"][0] == DECODE_M]
    prefill_rows = [r for r in mm_rows if r["shape"][0] == LONG_PROMPT]
    fa_main = next(r for r in fa["rows"] if (r["seq"], r["head_dim"]) == (LONG_PROMPT, FA_DIM))

    def layer_entry(rows, pre: str = "") -> dict:
        return {"ms": sum(r[pre + "ms"] for r in rows),
                "plain_ms": sum(r[pre + "plain_ms"] for r in rows),
                "bound_ms": sum(r[pre + "bound_ms"] for r in rows),
                "bound_by": max(("operations", "bytes"), key=lambda by: sum(
                    r[pre + "bound_ms"] for r in rows if r[pre + "bound_by"] == by))}

    line = {"kernels": [
        {"name": "masked_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/masked_matmul.cu",
         "replaces": "src/repro/kernels/masked_matmul/mm_kernel.py:91",
         "launches": total["masked_matmul"], "max_abs_err": mm_err,
         **layer_entry(prefill_rows),
         "library_ms": sum(r["library_ms"] for r in prefill_rows),
         "shape": f"the tile kernel (masked_mm_kernel): one prefill layer, q,k,v,o,gate,up,down "
                  f"at M={LONG_PROMPT}, the wrapper's time with its occupancy pre-pass",
         "note": "launches: every forward product, on either kernel; those with M <= 32 are "
                 "also counted under masked_matmul_skinny",
         "launches_by_path": by_path["masked_matmul"]},
        {"name": "masked_matmul_skinny", "route": "cuda",
         "source": "src/repro_torch/csrc/masked_matmul.cu",
         "replaces": "src/repro/kernels/masked_matmul/mm_kernel.py:91",
         "launches": total["masked_matmul_skinny"], "max_abs_err": mm_err,
         **layer_entry(decode_rows),
         "library_ms": sum(r["library_ms"] for r in decode_rows),
         "tile_ms": sum(r["tile_ms"] for r in decode_rows),
         "shape": f"the skinny kernel (masked_mm_skinny_kernel): one decode layer, "
                  f"q,k,v,o,gate,up,down at M={DECODE_M}, cold weights, the wrapper's time",
         "note": "every product with M <= 32 (forward, dx, dw); bit-equal to the tile kernel "
                 "on the same operands; tile_ms: the tile kernel forced on them",
         "launches_by_path": by_path["masked_matmul_skinny"]},
        {"name": "tile_occupancy", "route": "cuda",
         "source": "src/repro_torch/csrc/masked_matmul.cu",
         "replaces": "src/repro/kernels/masked_matmul/ops.py:43",
         "launches": total["tile_occupancy"], "max_abs_err": float(occ_err),
         **layer_entry(prefill_rows, "occ_"), "library_ms": None,
         "shape": f"one prefill layer: x and w flags of the 7 projections at M={LONG_PROMPT}",
         "note": "the tile kernel's occupancy pre-pass (the jnp _occupancy ahead of "
                 "masked_matmul_pallas), two launches per product with M > 32",
         "launches_by_path": by_path["tile_occupancy"]},
        {"name": "mask_pack", "route": "cuda",
         "source": "src/repro_torch/csrc/mask_pack.cu",
         "replaces": "src/repro/kernels/mask_compress/mc_kernel.py:36",
         "launches": total["mask_pack"], "library_ms": None,
         **{k: mp[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                               "bound_by", "lane_ms", "lane_device_ms", "host_ms", "floor_ms",
                               "host_split", "rows")},
         "shape": f"one 4096-token decode-tick KV leaf ({16 * LONG_SLOTS},"
                  f"{(LONG_PROMPT + GEN + 1) * KV_ROW}) bf16, the stream route",
         "note": "ms and lane_ms: a timed loop of calls; device_ms and lane_device_ms: one "
                 "call's kernel with L2 flushed ahead of it (lane: the lane route forced on "
                 "the same input); host_ms: the host's time to queue one call at the "
                 "prompt-32 decode leaf, host_split its parts; floor_ms: a one-word call's "
                 "device time; rows: the prompt-32 decode leaf, this leaf and the 4096-token "
                 "install row",
         "launches_by_path": by_path["mask_pack"]},
        bwd_entry("dx"),
        bwd_entry("dw"),
        {"name": "splitk_reduce", "route": "cuda",
         "source": "src/repro_torch/csrc/masked_matmul.cu",
         "replaces": "src/repro/kernels/masked_matmul/mm_kernel.py:91",
         "launches": total["splitk_reduce"], **bwd["reduce"],
         "note": "masked_matmul's split-K reduce, one launch per product with K > 8192; "
                 "the Pallas kernel carries its K sum across the sequential grid axis; "
                 "library: torch.sum(partials, 0); ms and library_ms: a timed loop of calls; "
                 "device_ms and library_device_ms: one call's kernel with L2 flushed ahead "
                 "of it, to hold against the byte bound; host_ms and library_host_ms: the "
                 "host's time to queue one call",
         "launches_by_path": by_path["splitk_reduce"]},
        {"name": "stochastic_round", "route": "cuda",
         "source": "src/repro_torch/csrc/stochastic_round.cu",
         "replaces": "src/repro/kernels/stochastic_round/sr_kernel.py:51",
         "launches": total["stochastic_round"], **sr, "library_ms": None,
         "launches_by_path": by_path["stochastic_round"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention/fa_kernel.py:99",
         "launches": total["flash_attention"], "max_abs_err": fa["err"],
         **{k: fa_main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                    "device_ms", "host_ms", "library_device_ms", "tile")},
         "shape": f"one llama3.2-1b prefill attention: B 1, H {FA_HEADS}, HKV {FA_KV_HEADS}, "
                  f"D {FA_DIM}, S {LONG_PROMPT}, causal, fp32; library: fp32 "
                  "scaled_dot_product_attention (enable_gqa, is_causal)",
         "note": "ms and library_ms: a timed loop of calls; device_ms and library_device_ms: "
                 "one call with L2 flushed ahead of it; host_ms: the host's time to queue a "
                 "call; tile: the query tile the wrapper's plan chose; every row of 6a in "
                 "chip_smoke.json",
         "launches_by_path": by_path["flash_attention"]},
        {"name": "ssd_scan", "route": "cuda", "source": "src/repro_torch/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan/ssd_kernel.py:71",
         "launches": total["ssd_scan"], **ssd, "library_ms": None,
         "note": "one counted launch per call runs four stage kernels: chunk scores (once "
                 "per group), chunk state, state passing, chunk scan; ms: a timed loop of "
                 "calls; device_ms: one call's kernels with L2 flushed ahead of it; stage "
                 "times in chip_smoke.json",
         "launches_by_path": by_path["ssd_scan"]},
        {"name": "dangling_filter", "route": "cuda",
         "source": "src/repro_torch/csrc/dangling_filter.cu",
         "replaces": "src/repro/kernels/mask_compress/mc_kernel.py:58",
         "launches": total["dangling_filter"], **df, "library_ms": None,
         "note": "on the kernel sweep's path alone: the model paths (serve, serve_long, "
                 "serve_mamba2, train) launch it 0 times, as the reference's model code "
                 "never calls it; no single PyTorch call computes it",
         "launches_by_path": by_path["dangling_filter"]},
    ]}
    report["kernels"] = line["kernels"]
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        smi = f"nvidia-smi unavailable: {e}"
    report["nvidia_smi"] = smi
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=float))
    print(json.dumps(line))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
