"""Kernel microbenchmarks and the kernel parity sweep (port of
``benchmarks/bench_kernels.py``).

    python -m repro_torch.benchmarks.bench_kernels [--smoke] [--device cuda|cpu]

Without ``--smoke``: :func:`rows`, the reference's six timed calls at its
shapes (stochastic_round 512x1024, masked_matmul and its dx/dw on
block-pruned 512-cubes, flash_attention B1 H4 S512, ssd_scan B2 S512 H8).
On the card each time is a CUDA-event mean over calls after a warm-up; on
the CPU it is host wall time of the plain versions, never a device
number.  Rows: name, us_per_call, derived (a figure of merit: tile-skip
fraction, GFLOP, rel err against the sequential oracle), route (``cuda``:
the kernel ran; ``plain``: the plain version did).

``--smoke``: :func:`smoke_rows`, every op of ``kernels.registry`` on every
one of its examples.  On ``--device cuda`` (the default) each op's kernel
runs against its plain version on the same card tensors and the op's
compare decides; on ``--device cpu`` the plain version runs against the
op's independent oracle (the numpy oracles of ``ref.py``, a float64
product, the sequential SSD) where it has one, else against itself.  Ops
with a plain version only (``mask_unpack``, ``kv_unpack``) run that
against their oracle and are reported as route ``plain``.  A failing op
is listed on stderr and the process exits 1.  There is no fallback: a
kernel that does not build or launch fails its op.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.kernels import registry


def timer(device: torch.device):
    """``time(fn, iters) -> us per call``: CUDA events after a warm-up on
    the card, host wall time on the CPU."""

    def on_card(fn, iters: int = 10) -> float:
        fn()
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters * 1e3

    def on_host(fn, iters: int = 10) -> float:
        fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e6

    return on_card if device.type == "cuda" else on_host


def rows(device="cuda") -> list[tuple]:
    """The reference's timed rows at its shapes: (name, us_per_call,
    derived, route)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.masked_matmul.backward import masked_matmul_dw, masked_matmul_dx
    from repro_torch.kernels.masked_matmul.ops import masked_matmul, tile_skip_fraction
    from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_reference
    from repro_torch.kernels.stochastic_round.ops import stochastic_round

    device = torch.device(device)
    route = "cuda" if device.type == "cuda" else "plain"
    time_us = timer(device)
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(device)

    out = []
    x = randn(512, 1024)
    out.append(("kernel.stochastic_round.512x1024", time_us(lambda: stochastic_round(x, 1)),
                x.numel() / 1e6, route))

    # block-sparse fixed-point matmul: a quarter of the 128-tiles of each
    # operand pruned
    m = k = n = 512
    a = torch.round(randn(m, k) * 64) / 256
    w = torch.round(randn(k, n) * 64) / 256
    a[:256, :256] = 0.0
    w[256:, 256:] = 0.0
    out.append(("kernel.masked_matmul.512cube", time_us(lambda: masked_matmul(a, w, 3)),
                tile_skip_fraction(a, w), route))

    # the backward GEMMs of the same layer: a ReLU-masked cotangent (top
    # half zeroed); derived = the backward tile-skip fraction
    g = torch.round(randn(m, n) * 64) / 256
    g[:256, :] = 0.0
    out.append(("kernel.masked_matmul_dx.512cube", time_us(lambda: masked_matmul_dx(g, w)),
                tile_skip_fraction(g, w.T), route))
    out.append(("kernel.masked_matmul_dw.512cube", time_us(lambda: masked_matmul_dw(a, g)),
                tile_skip_fraction(a.T, g), route))

    q, kk, v = randn(1, 4, 512, 64), randn(1, 2, 512, 64), randn(1, 2, 512, 64)
    flops = 4 * 1 * 4 * 512 * 512 * 64 / 2  # causal half
    out.append(("kernel.flash_attention.b1h4s512",
                time_us(lambda: flash_attention(q, kk, v, causal=True)), flops / 1e9, route))

    xs = randn(2, 512, 8, 64)
    dt = torch.nn.functional.softplus(randn(2, 512, 8))
    aa = -torch.exp(randn(8) * 0.3)
    b, c = randn(2, 512, 2, 64) / 8, randn(2, 512, 2, 64) / 8
    us = time_us(lambda: ssd_scan(xs, dt, aa, b, c))
    ref = ssd_scan_reference(xs, dt, aa, b, c)
    got = ssd_scan(xs, dt, aa, b, c)
    rel = float((got - ref).abs().max() / (ref.abs().max() + 1e-9))
    out.append(("kernel.ssd_scan.b2s512h8", us, rel, route))
    return out


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to(t, device) for t in tree)
    return tree


def smoke_rows(device="cuda") -> tuple[list[tuple], list[str]]:
    """One row per op of the table, (name, us_per_case, worst deviation,
    route, cases), and the list of failures.  A failing op does not stop
    the sweep: it is listed and its row carries worst = nan."""
    device = torch.device(device)
    time_us = timer(device)
    out, failures = [], []
    for op in registry.ops():
        spec = registry.op_spec(op)
        cases = spec.examples() if spec.examples is not None else []
        on_card = device.type == "cuda" and spec.kernel is not None
        route = "cuda" if on_card else "plain"
        worst, us = 0.0, []
        try:
            for case in cases:
                args, kwargs = case[0], case[1]
                case_cmp = case[2] if len(case) > 2 else None
                dev_args = _to(args, device)
                fn = spec.kernel if spec.kernel is not None else spec.plain
                got = fn(*dev_args, **kwargs)
                if on_card:
                    want = spec.plain(*dev_args, **kwargs)
                elif spec.oracle is not None:
                    want = spec.oracle(*args, **kwargs)
                else:
                    want = spec.plain(*args, **kwargs)
                worst = max(worst, registry.compare_outputs(op, got, want, case_cmp))
                us.append(time_us(lambda: fn(*dev_args, **kwargs), iters=5))
        except Exception as e:  # a compare violation or a kernel that failed
            failures.append(f"{op}.{route}: {type(e).__name__}: {e}")
            worst = float("nan")
        out.append((f"kernel.parity.{op}.{route}", float(np.mean(us)) if us else 0.0, worst,
                    route, len(cases)))
    if not any(registry.op_spec(op).kernel is not None for op in registry.ops()):
        failures.append("the table lists no op with a kernel")
    return out, failures


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true", help="the kernel parity sweep")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    failures = []
    if args.smoke:
        print("name,us_per_case,worst,route,cases")
        smoke_out, failures = smoke_rows(args.device)
        for name, us, worst, route, n in smoke_out:
            print(f"{name},{us:.2f},{worst:.6g},{route},{n}")
    else:
        print("name,us_per_call,derived,route")
        for name, us, derived, route in rows(args.device):
            print(f"{name},{us:.2f},{derived:.6g},{route}")
    for f in failures:
        print(f"PARITY FAILURE: {f}", file=sys.stderr)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
