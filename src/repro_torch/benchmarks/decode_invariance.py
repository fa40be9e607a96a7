"""Batch invariance and cost of the serving decode's plain torch reductions.

    python -m repro_torch.benchmarks.decode_invariance ops [--reduced] [--device cuda|cpu]
    python -m repro_torch.benchmarks.decode_invariance decode [--reduced] [--device cuda|cpu]
    PYTHONPATH=<tree>/src python3 src/repro_torch/benchmarks/decode_invariance.py tick --label L

``ops``: every plain torch reduction of a full-width decode step
(llama3.2-1b and mamba2-780m), on random inputs from a seed, with rows 0-1
computed in a batch of 4 and alone in a batch of 2.  On the card cuBLAS
and torch's reduction kernels may choose their algorithm, and so their
summation order, by the batch's size; a serving engine whose tokens must
not depend on the pool's size (a rescale, a resume into another slot)
needs every such op to agree bit for bit.  Each op is run batched and in
fixed row blocks (``layers.fixed_rows``); the line says which form the
port's decode ships.  Prints one line per op and an ``OPS {...}`` JSON line.

``decode``: the whole decode step.  llama3.2-1b (prompt 512) and
mamba2-780m (prompt 256) engines of 4 slots, quant_sparse, random weights
from seed 0, three ticks in; slots 0-1's decode logits in a pool of 4
slots and in a pool of 2 holding their exact packed bits, once as the
port ships the step and once with every ``fixed_rows`` turned into one
batched call.  Prints a line per model and form and a ``DECODE {...}``
JSON line.

``tick``: the decode cost of whichever ``repro_torch`` is imported, so two
trees compare in one call by running this file once with each tree's
``src`` on ``PYTHONPATH``.  For full-width llama3.2-1b and mamba2-780m: a
prompt-32 decode tick of 4 slots, wall ms under torch.profiler and
without it, and device-busy ms; then ``serve_session`` twice (4 slots, 8
requests, prompt 32 for llama3.2-1b and 256 for mamba2-780m, gen 16:
tokens/s and decode seconds).  Prints an ``AB {...}`` JSON line.  It uses only entry points the port has had since its serving
slice.
"""

from __future__ import annotations

import argparse
import json
import time

SLOTS, REQUESTS, PROMPT, MAMBA_PROMPT, GEN, TICKS = 4, 8, 32, 256, 16, 4
# decode cache lengths: the 6g pool (prompt 512) and the long serve's (4096)
CACHE_LENS = (512 + GEN + 1, 4096 + GEN + 1)


def _ops(cfg_llama, cfg_mamba, dev, gen):
    """(name, fn, inputs, shipped row by row) for each plain reduction."""
    import torch

    from repro_torch.models.attention import _scores, _values

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    a, s = cfg_llama.attn, cfg_mamba.ssm
    b, g = SLOTS, a.n_heads // a.n_kv_heads
    conv_dim = s.d_inner + 2 * s.n_groups * s.d_state
    ops = []
    for tag, d in (("llama", cfg_llama.d_model), ("mamba2", cfg_mamba.d_model),
                   ("mamba2 gated", s.d_inner)):
        ops.append((f"rmsnorm mean {tag} d{d}",
                    lambda x: torch.mean(x * x, dim=-1, keepdim=True), (randn(b, 1, d),), True))
    for n in CACHE_LENS:
        ops.append((f"decode qk einsum S{n}", _scores,
                    (randn(b, a.n_kv_heads, g, a.head_dim),
                     randn(b, n, a.n_kv_heads, a.head_dim)), True))
        ops.append((f"decode softmax S{n}", lambda x: torch.softmax(x, dim=-1),
                    (randn(b, a.n_kv_heads, g, n),), False))
        ops.append((f"decode pv einsum S{n}", _values,
                    (torch.softmax(randn(b, a.n_kv_heads, g, n), -1),
                     randn(b, n, a.n_kv_heads, a.head_dim)), True))
    for cfg in (cfg_llama, cfg_mamba):
        w = randn(cfg.d_model, cfg.vocab) * 0.02
        ops.append((f"logits {cfg.d_model}x{cfg.vocab}", lambda h, w=w: torch.matmul(h, w),
                    (randn(b, cfg.d_model),), True))
    ops.append(("ssm readout bhn,bhnp", lambda c, st: torch.einsum("bhn,bhnp->bhp", c, st),
                (randn(b, s.n_heads, s.d_state), randn(b, s.n_heads, s.d_state,
                                                       s.d_inner // s.n_heads)), True))
    ops.append((f"conv sum K4 C{conv_dim}", lambda c: c.sum(dim=1), (randn(b, 4, conv_dim),),
                False))
    return ops


def run_ops(dev, reduced: bool) -> dict:
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.layers import fixed_rows

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    cfg_llama = get_arch("llama3.2-1b").resolve(reduced)
    cfg_mamba = get_arch("mamba2-780m").resolve(reduced)
    out = {}
    for name, fn, xs, shipped in _ops(cfg_llama, cfg_mamba, dev, gen):
        row = {"shipped": "fixed_rows" if shipped else "batched"}
        for form, f in (("batched", fn), ("fixed_rows", lambda *x, fn=fn: fixed_rows(fn, *x))):
            four = f(*xs)[:2]
            two = f(*(x[:2] for x in xs))
            row[form] = {"max_abs_diff": float((four - two).abs().max()),
                         "bit_equal": bool(torch.equal(four, two))}
        out[name] = row
        print(f"[ops] {name}: batched max |B4[:2]-B2| = {row['batched']['max_abs_diff']:.3g} "
              f"equal={row['batched']['bit_equal']}; fixed_rows equal="
              f"{row['fixed_rows']['bit_equal']}; the decode ships {row['shipped']}",
              flush=True)
    return out


def _decode_logits(engine, slots: list, width: int):
    """Decode logits of the engine's ``slots`` in a pool of ``width`` slots
    holding their exact packed bits (slot i of it = slots[i]) and nothing
    else, each slot's next token fed."""
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


def run_decode(dev, reduced: bool) -> dict:
    import torch

    from repro_torch.api.sessions import synthetic_prompts
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serving_config
    from repro_torch.models import attention, layers, lm, ssm
    from repro_torch.serving.engine import ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    shipped = layers.fixed_rows
    out = {}
    for arch, prompt in (("llama3.2-1b", 512), ("mamba2-780m", 256)):
        cfg = get_arch(arch).resolve(reduced)
        prompt = min(prompt, 32) if reduced else prompt
        eng = ServingEngine(cfg, serving_config("quant_sparse"), n_slots=SLOTS,
                            max_len=prompt + GEN + 1, seed=0, device=dev)
        for p in synthetic_prompts(SLOTS, SLOTS, prompt, cfg.vocab, 0):
            eng.submit_prompt(p, GEN)
        for _ in range(3):
            eng.step()
        for form, fn in (("shipped", shipped), ("batched", lambda f, *xs: f(*xs))):
            for mod in (attention, layers, lm, ssm):
                mod.fixed_rows = fn
            try:
                four = _decode_logits(eng, list(range(SLOTS)), SLOTS)[:2]
                two = _decode_logits(eng, [0, 1], 2)
            finally:
                for mod in (attention, layers, lm, ssm):
                    mod.fixed_rows = shipped
            row = {"max_abs_diff": float((four - two).abs().max()),
                   "bit_equal": bool(torch.equal(four, two)),
                   "argmax_equal": bool(torch.equal(four.argmax(-1), two.argmax(-1)))}
            out[f"{arch} {form}"] = row
            print(f"[decode] {arch} {form}: logits of slots 0-1, max |4 slots - 2 slots| = "
                  f"{row['max_abs_diff']:.3g}, bit-equal {row['bit_equal']}, argmax equal "
                  f"{row['argmax_equal']}", flush=True)
        del eng
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _tick(dev, arch: str) -> dict:
    """Wall and device ms of a prompt-32 decode tick of ``arch`` at SLOTS
    slots: TICKS ticks under torch.profiler, then 2 * TICKS without it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api.sessions import synthetic_prompts
    from repro_torch.configs import get_arch
    from repro_torch.launch.serve import serving_config
    from repro_torch.serving.engine import ServingEngine

    cfg = get_arch(arch).resolve(False)
    eng = ServingEngine(cfg, serving_config("quant_sparse"), n_slots=SLOTS,
                        max_len=PROMPT + GEN + 1, seed=0, device=dev)
    for p in synthetic_prompts(SLOTS, SLOTS, PROMPT, cfg.vocab, 0):
        eng.submit_prompt(p, GEN)
    eng.step()  # admissions and the first decode tick
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(TICKS):
            eng.step()
        torch.cuda.synchronize()
        profiled_ms = (time.monotonic() - t0) * 1e3 / TICKS
    t0 = time.monotonic()
    for _ in range(2 * TICKS):
        eng.step()
    torch.cuda.synchronize()
    plain_ms = (time.monotonic() - t0) * 1e3 / (2 * TICKS)
    del eng
    busy_ms = sum(ev.self_device_time_total for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA) / 1e3 / TICKS
    return {"tick_ms_profiled": profiled_ms, "tick_ms": plain_ms, "device_busy_ms": busy_ms}


def run_tick(dev, label: str, reps: int = 2) -> dict:
    import torch

    from repro_torch.kernels import cuda
    from repro_torch.launch.serve import serve_session

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda.build()  # every kernel, before any clock starts
    res = {"tree": label}
    for arch, key, prompt in (("llama3.2-1b", "llama", PROMPT),
                              ("mamba2-780m", "mamba", MAMBA_PROMPT)):
        torch.cuda.empty_cache()
        res.update({f"{key}_{k}": v for k, v in _tick(dev, arch).items()})
        runs = [serve_session(arch, reduced=False, mode="quant_sparse", slots=SLOTS,
                              queue=REQUESTS, prompt_len=prompt, gen=GEN, seed=0, device=dev)
                for _ in range(reps)]
        res[f"{key}_tokens_per_s"] = [r["tokens_per_s"] for r in runs]
        res[f"{key}_decode_s"] = [r["decode_s"] for r in runs]
    return res


def main(argv=None) -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("ops", "decode", "tick"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="ops and decode at the reduced widths")
    ap.add_argument("--label", default="tree", help="tick: the tree's name in the AB line")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if args.what == "ops":
        print("OPS " + json.dumps(run_ops(dev, args.reduced)), flush=True)
    elif args.what == "decode":
        print("DECODE " + json.dumps(run_decode(dev, args.reduced)), flush=True)
    else:
        if dev.type != "cuda":
            raise SystemExit("tick measures the card: --device cuda")
        print("AB " + json.dumps(run_tick(dev, args.label)), flush=True)


if __name__ == "__main__":
    main()
