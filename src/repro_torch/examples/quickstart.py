"""Quickstart: SPRING's three pillars in ~70 lines (twin of the reference's
``examples/quickstart.py``).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse

import torch

from repro_torch.core import (
    QUANT_SPARSE,
    SPRING_FORMAT,
    KeyGen,
    compression_ratio,
    mask_decode,
    mask_encode,
    quantize_stochastic,
    sparse_dot,
    spring_matmul,
)


def main(steps: int | None = None, argv: list | None = None) -> None:
    """CLI entry point; ``main(steps=1, argv=[...])`` is the smoke-test path
    (a programmatic call reads no process argv)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=25 if steps is None else steps)
    ap.add_argument("--device", default="cuda")
    if steps is not None and argv is None:
        argv = []
    args = ap.parse_args(argv)
    from repro_torch.serving.engine import resolve_device

    dev = resolve_device(args.device)

    def gen(i: int) -> torch.Generator:
        return torch.Generator(device=dev).manual_seed(i)

    # --- P1: binary-mask sparsity encoding (paper Fig. 5) -------------------
    x = torch.randn((1024,), generator=gen(0), device=dev)
    x = x * (torch.rand(x.shape, generator=gen(1), device=dev) > 0.5)
    mv = mask_encode(x)
    print(f"[P1] {int(mv.nnz)}/{x.numel()} non-zeros kept; "
          f"compression at Q4.16+mask: {float(compression_ratio(mv, 21)):.2f}x; "
          f"decode exact: {bool(torch.all(mask_decode(mv) == x))}")

    w = torch.randn((1024,), generator=gen(2), device=dev)
    w = w * (torch.rand(w.shape, generator=gen(3), device=dev) > 0.5)
    print(f"[P1] zero-free dot == dense dot: "
          f"{abs(float(sparse_dot(mv, mask_encode(w)) - torch.dot(x, w))) < 1e-4}")

    # --- P2: stochastic rounding (paper Eq. 4) ------------------------------
    v = torch.full((100_000,), 0.5 + 0.3 * SPRING_FORMAT.eps, device=dev)
    q = quantize_stochastic(torch.Generator().manual_seed(4), v)
    print(f"[P2] SR bias: {float(q.mean() - v[0]) / SPRING_FORMAT.eps:+.4f} eps "
          f"(unbiased => fixed-point training converges)")

    # --- P1+P2 together: the sparsity-aware quantized matmul ----------------
    a = torch.randn((64, 256), generator=gen(0), device=dev)
    b = torch.randn((256, 32), generator=gen(5), device=dev) / 256**0.5
    y_dense = a @ b
    y_spring = spring_matmul(a, b, QUANT_SPARSE, KeyGen(6))
    rel = float(torch.max(torch.abs(y_spring - y_dense)) / torch.max(torch.abs(y_dense)))
    print(f"[P1+P2] spring_matmul rel deviation vs fp32: {rel:.2e} "
          f"(quantization noise, gradient-safe via STE)")

    # --- sparsity in training: the backward pass is masked too --------------
    # backward_sparsity="auto" (the QUANT_SPARSE default) routes dL/dX and
    # dL/dW through the tile-skipping masked_matmul_dx/dw kernels.
    from repro_torch.kernels.masked_matmul.backward import sparsity_probe

    probe = sparsity_probe(density=0.5, size=256, device=dev)
    print(f"[train] tile-skip at 50% block density — fwd "
          f"{probe['forward_tile_skip']:.2f}, bwd dX "
          f"{probe['backward_tile_skip_dx']:.2f}, bwd dW "
          f"{probe['backward_tile_skip_dw']:.2f} "
          f"(sparsity pays in both directions)")

    # --- a taste of the training stack: one declarative RunSpec -------------
    # The whole run — arch, shape, numerics, sparsity, kernels, seeds — is
    # one frozen spec; its canonical JSON (embedded in every run artifact)
    # names the run.  See DESIGN.md §10.
    from repro_torch.api import TrainSession, build_spec

    spec = build_spec("train", sets=[
        "arch.id=llama3.2-1b", f"train.steps={args.steps}", "shape.batch=8",
        "shape.seq=64", "numerics.mode=quant",
        "numerics.fixed_point_weights=true", "train.log_every=100",
    ])
    print(f"[spec] canonical hash {spec.spec_hash()} "
          f"(numerics.mode={spec.numerics.mode!r} from "
          f"{spec.provenance['numerics.mode']})")
    res = TrainSession(spec, device=dev).run()
    print(f"[train] Q4.16+SR end-to-end: loss {res['first_loss']:.3f} -> "
          f"{res['last_loss']:.3f}")


if __name__ == "__main__":
    main()
