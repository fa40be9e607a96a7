#!/usr/bin/env python3
"""GPU smoke test of the PyTorch + CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
repository around this file.  Phases, each of which exits non-zero on
failure:

  1. build   — compile every kernel under src/repro_torch/csrc with nvcc,
               one process per source, in parallel;
  2. kernels — each kernel's wrapper on card tensors at the serving path's
               shapes (masked_matmul's occupancy pre-pass too, and once on
               block-pruned operands), held against its plain PyTorch
               version (tolerances below), then timed beside the plain
               version, the one PyTorch call computing the same function
               (where there is one) and the H100's bound for the same work;
  3. serve   — full-width llama3.2-1b, quant_sparse, random weights from a
               seed, 4 slots, 6 requests, prompt 32, gen 16, through
               ``repro_torch.launch.serve.serve_session`` on the card; the
               kernels' launch counters are zeroed just before and read just
               after, and every kernel must have launched;
  3b. profile — a second engine over the same model, four decode ticks
               under torch.profiler: the device-busy share and the kernels
               by device time per tick;
  4. check  — the reduced llama3.2-1b on the card against the same model on
               the CPU (plain versions), prefill and decode logits.

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


def profile_decode(dev, ticks: int = 4) -> dict:
    """Where a decode tick's time goes: the same full-width engine, all
    slots admitted first, then ``ticks`` pooled decode ticks under
    torch.profiler.  Prints the device-busy share of the window and the
    kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serving_config, synthetic_prompts
    from repro_torch.serving.engine import ServingEngine

    cfg = get_arch("llama3.2-1b").resolve(False)
    eng = ServingEngine(cfg, serving_config("quant_sparse"), n_slots=SLOTS,
                        max_len=PROMPT + GEN + 1, seed=0, device=dev)
    for p in synthetic_prompts(SLOTS, PROMPT, cfg.vocab, 0):
        eng.submit_prompt(p, GEN)
    eng.step()  # admissions (prefill + install) and the first decode tick
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.monotonic() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # device-side events only: a CPU op's device time repeats its kernels'
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            rows.append((ev.key, ev.self_device_time_total / 1e3 / ticks, ev.count // ticks))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    tick_ms = wall_ms / ticks
    if busy_ms == 0:
        print(f"[profile] decode tick {tick_ms:.2f} ms wall; device time not measured "
              f"(the profiler recorded no device activity)", flush=True)
    else:
        print(f"[profile] decode tick {tick_ms:.2f} ms wall (profiled), device busy "
              f"{busy_ms:.2f} ms = {busy_ms / tick_ms:.1%}; top kernels per tick:", flush=True)
        for name, ms, n in rows[:12]:
            print(f"[profile]   {ms:8.3f} ms  x{n:<4d} {name[:90]}", flush=True)
    return {"tick_ms": tick_ms, "device_busy_ms": busy_ms,
            "kernels": [{"name": n, "ms_per_tick": ms, "calls_per_tick": c}
                        for n, ms, c in rows[:40]]}


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
    from repro_torch.kernels.mask_compress.ops import mask_pack, mask_pack_reference
    from repro_torch.kernels.masked_matmul.ops import (
        kernel_tiles, masked_matmul, masked_matmul_reference, tile_occupancy,
        tile_occupancy_reference, tile_skip_fraction)

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
    tiles = kernel_tiles()

    def timed(fn, iters: int) -> float:
        for _ in range(3):
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
    # 2 * K * 2**-24 * (|x| @ |w|), elementwise
    mm_rows, mm_err = [], 0.0
    for m in (DECODE_M, PREFILL_M):
        for name, (k, n) in LAYER_SHAPES.items():
            x = quantize_nearest(randn(m, k))
            w = quantize_nearest(randn(k, n) / k**0.5)
            for a, tr, tc in ((x, tm, tk), (w, tk, tn)):
                occ_err = max(occ_err, check_occupancy(a, tr, tc)[0])
            got = masked_matmul(x, w, apply_sr=False)
            want = masked_matmul_reference(x, w, apply_sr=False)
            tol = 2 * k * 2.0**-24 * (x.abs() @ w.abs())
            err = (got - want).abs()
            if not bool((err <= tol).all()):
                fail(f"masked_matmul ({m},{k})@({k},{n}) off by {float(err.max()):.3g}")
            mm_err = max(mm_err, float(err.max()))
            # time against cold weights, as decode finds them: rotate copies
            # of w through more than the 50 MB L2
            copies = [w] + [w.clone() for _ in range(max(1, (256 << 20) // (k * n * 4)))]
            cyc = itertools.cycle(copies)
            iters = 50
            ms = timed(lambda: masked_matmul(x, next(cyc), apply_sr=False), iters)
            plain_ms = timed(lambda: masked_matmul_reference(x, next(cyc), apply_sr=False), iters)
            lib_ms = timed(lambda: torch.matmul(x, next(cyc)), iters)
            # the pre-pass alone: both operands' flags, as one wrapper call makes them
            occ_ms = timed(lambda: (tile_occupancy(x, tm, tk),
                                    tile_occupancy(next(cyc), tk, tn)), iters)
            occ_plain_ms = timed(lambda: (tile_occupancy_reference(x, tm, tk),
                                          tile_occupancy_reference(next(cyc), tk, tn)), iters)
            n_flags = -(-m // tm) * -(-k // tk) + -(-k // tk) * -(-n // tn)
            occ_b_ms, occ_b_by = bound(4.0 * (m * k + k * n + n_flags), m * k + k * n)
            skip = tile_skip_fraction(x, w, tiles)
            b_ms, b_by = bound(4.0 * (m * k + k * n + m * n), 2.0 * m * n * k * (1 - skip))
            mm_rows.append({"shape": [m, k, n], "proj": name, "ms": ms, "plain_ms": plain_ms,
                            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                            "max_abs_err": float(err.max()), "skip": skip,
                            "occ_ms": occ_ms, "occ_plain_ms": occ_plain_ms,
                            "occ_bound_ms": occ_b_ms, "occ_bound_by": occ_b_by})
            print(f"[masked_matmul] {name:4s} ({m},{k})@({k},{n}) err={float(err.max()):.3g} "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms, "
                  f"bound {b_ms:.4f} ms ({b_by}); occupancy pre-pass {occ_ms:.4f} ms, "
                  f"plain {occ_plain_ms:.4f} ms, bound {occ_b_ms:.4f} ms ({occ_b_by})",
                  flush=True)
            del copies
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

    # -- 2c. mask_pack: exact on bf16 and fp32, -0.0, unaligned lengths -------
    block = 49 * 8 * 64  # one (layer, slot) k/v block: max_len 49 x 8 kv heads x 64
    mp_err = 0  # max |kernel - plain| over the words, as unsigned integers
    for dtype in (torch.bfloat16, torch.float32):
        for n_blocks, blen in [(64, block), (16, block), (7, 1000), (3, 33), (1, 4096)]:
            x = randn(n_blocks, blen) * (torch.rand(n_blocks, blen, generator=gen) > 0.4).to(dev)
            x[:, ::7] = -0.0
            x = x.to(dtype)
            got, want = mask_pack(x), mask_pack_reference(x)
            torch.cuda.synchronize()
            words = [v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF for v in (got, want)]
            err = int((words[0] - words[1]).abs().max())
            if err or got.shape != want.shape:
                fail(f"mask_pack {dtype} ({n_blocks},{blen}) disagrees with its plain version")
            mp_err = max(mp_err, err)
    print("[mask_pack] exact on bf16/fp32, -0.0, lengths 33/1000/4096/25088: ok", flush=True)
    x = (randn(16 * SLOTS, block) * (torch.rand(16 * SLOTS, block, generator=gen) > 0.4)
         .to(dev)).to(torch.bfloat16)
    mp_ms = timed(lambda: mask_pack(x), 200)
    mp_plain_ms = timed(lambda: mask_pack_reference(x), 50)
    n_words = -(-block // 32)
    mp_bound, mp_by = bound(x.numel() * 2 + x.shape[0] * n_words * 4, x.numel())
    print(f"[mask_pack] decode leaf ({x.shape[0]},{block}) bf16: kernel {mp_ms:.4f} ms, "
          f"plain {mp_plain_ms:.4f} ms, bound {mp_bound:.4f} ms ({mp_by})", flush=True)

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
    for name, n in launches.items():
        if n <= 0:
            fail(f"serve phase never launched the {name} kernel")
    report["decode_profile"] = profile_decode(dev)

    # -- 4. check: reduced model on the card vs the CPU plain versions --------
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serving_config
    from repro_torch.models.layers import SpringContext
    from repro_torch.models.lm import lm_decode_step, lm_init, lm_prefill, pad_cache

    cfg = get_arch("llama3.2-1b").resolve(reduced=True)
    ctx = SpringContext(cfg=serving_config("quant_sparse"))
    p_cpu = lm_init(cfg, 0, device="cpu")

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, device) for v in tree]
        return tree.to(device)

    toks = torch.randint(0, cfg.vocab, (2, 12), generator=gen)
    lg_cpu, c_cpu = lm_prefill(p_cpu, cfg, toks, ctx)
    lg_gpu, c_gpu = lm_prefill(to(p_cpu, dev), cfg, toks.to(dev), ctx)
    nxt = lg_cpu.argmax(-1)
    d_cpu, _ = lm_decode_step(p_cpu, cfg, nxt, pad_cache(c_cpu, 1), ctx)
    d_gpu, _ = lm_decode_step(to(p_cpu, dev), cfg, nxt.to(dev), pad_cache(c_gpu, 1), ctx)
    # logits of a 3-layer model: the fp32 sums of kernel and plain version
    # differ in order, which moves a quantized activation by one 2**-16 step
    # at most, far below 1e-3 at the logits
    e_pre = float((lg_gpu.cpu() - lg_cpu).abs().max())
    e_dec = float((d_gpu.cpu() - d_cpu).abs().max())
    print(f"[check] reduced llama3.2-1b card vs CPU: prefill logits max_abs_err={e_pre:.3g}, "
          f"decode {e_dec:.3g} (atol 1e-3), argmax equal "
          f"{bool(torch.equal(lg_gpu.argmax(-1).cpu(), nxt))}", flush=True)
    if not (e_pre <= 1e-3 and e_dec <= 1e-3):
        fail("the reduced model on the card disagrees with the CPU plain versions")

    # -- kernel line, card, result -------------------------------------------
    decode_rows = [r for r in mm_rows if r["shape"][0] == DECODE_M]
    line = {"kernels": [
        {"name": "masked_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/masked_matmul.cu",
         "replaces": "src/repro/kernels/masked_matmul/mm_kernel.py:91",
         "launches": launches["masked_matmul"], "max_abs_err": mm_err,
         "ms": sum(r["ms"] for r in decode_rows),
         "plain_ms": sum(r["plain_ms"] for r in decode_rows),
         "bound_ms": sum(r["bound_ms"] for r in decode_rows),
         "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in decode_rows)
         else "operations",
         "library_ms": sum(r["library_ms"] for r in decode_rows),
         "shape": "one decode layer: q,k,v,o,gate,up,down at M=4, cold weights; "
                  "the wrapper's time, its occupancy pre-pass included"},
        {"name": "tile_occupancy", "route": "cuda",
         "source": "src/repro_torch/csrc/masked_matmul.cu",
         "replaces": "src/repro/kernels/masked_matmul/ops.py:43",
         "launches": launches["tile_occupancy"], "max_abs_err": float(occ_err),
         "ms": sum(r["occ_ms"] for r in decode_rows),
         "plain_ms": sum(r["occ_plain_ms"] for r in decode_rows),
         "bound_ms": sum(r["occ_bound_ms"] for r in decode_rows),
         "bound_by": "bytes" if all(r["occ_bound_by"] == "bytes" for r in decode_rows)
         else "operations",
         "library_ms": None,
         "shape": "one decode layer: x and w flags of the 7 projections at M=4, cold weights",
         "note": "masked_matmul's occupancy pre-pass (the jnp _occupancy ahead of "
                 "masked_matmul_pallas), two launches per masked_matmul launch"},
        {"name": "mask_pack", "route": "cuda",
         "source": "src/repro_torch/csrc/mask_pack.cu",
         "replaces": "src/repro/kernels/mask_compress/mc_kernel.py:36",
         "launches": launches["mask_pack"], "max_abs_err": float(mp_err),
         "ms": mp_ms, "plain_ms": mp_plain_ms, "bound_ms": mp_bound, "bound_by": mp_by,
         "library_ms": None,
         "shape": f"one decode-tick KV leaf ({16 * SLOTS},{block}) bf16"},
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
