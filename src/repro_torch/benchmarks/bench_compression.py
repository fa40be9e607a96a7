"""Paper Fig. 5: binary-mask compression (port of
``benchmarks/bench_compression.py``).  Reproduces the worked example (16
elems, 6 nnz, 16-bit values -> 2.29x) exactly, then measures compression
ratio and ``mask_encode`` time across sparsity levels at the paper's
Q4.16 (21 bits incl. mask).

    python -m repro_torch.benchmarks.bench_compression [--device cuda|cpu]

Rows: us_per_call = mask_encode time (CUDA events after a warm-up on the
card, host wall time on the CPU); derived = compression ratio.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core.masking import compression_ratio, mask_encode


def fig5_example() -> float:
    """The paper's worked example: 16 elements, 6 non-zeros, 16-bit values."""
    example = torch.zeros(16)
    example[[1, 3, 6, 9, 12, 15]] = 1.0
    return float(compression_ratio(mask_encode(example), 16))


def rows(device="cuda") -> list[tuple[str, float, float]]:
    from repro_torch.benchmarks.bench_kernels import timer

    device = torch.device(device)
    time_us = timer(device)
    out = [("fig5_example_16elem_6nnz_16bit", 0.0, fig5_example())]
    gen = torch.Generator().manual_seed(0)
    for sparsity in (0.3, 0.5, 0.7, 0.9):
        x = torch.randn(1 << 20, generator=gen)
        x = (x * (torch.rand(x.shape, generator=gen) > sparsity)).to(device)
        mv = mask_encode(x)
        us = time_us(lambda: mask_encode(x), iters=20)
        out.append((f"fig5_ratio_s{int(sparsity * 100)}_q4.16", us,
                    float(compression_ratio(mv, 21))))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    for name, us, derived in rows(args.device):
        print(f"{name},{us:.2f},{derived:.6g}")


if __name__ == "__main__":
    main()
