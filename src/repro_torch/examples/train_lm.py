"""End-to-end training driver (twin of the reference's
``examples/train_lm.py``): data pipeline -> SPRING train step ->
checkpoint/resume -> straggler watchdog — a thin adapter over RunSpec.

Presets:
  cpu-small (default) — a reduced llama-family model, a few hundred steps.
  pod-100m — a ~100M-param llama-family config; same code path, bigger
    dims (the port trains on one device).

Checkpoints go to ``repro_torch_train_lm`` under the temp directory
unless ``--ckpt-dir`` says otherwise.

  PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 300
  PYTHONPATH=src python -m repro_torch.examples.train_lm --preset pod-100m --steps 300
  PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \
      --spec examples/specs/train_quant_sparse.json
"""

import argparse
import dataclasses
import logging
import os
import tempfile

from repro_torch.api.cli import flag, legacy_overrides
from repro_torch.api.sessions import TrainSession
from repro_torch.api.spec import build_spec
from repro_torch.configs import get_arch
from repro_torch.models.attention import AttnSpec
from repro_torch.models.lm import LMConfig

FLAGS = (
    flag("--steps", "train.steps", type=int),
    flag("--mode", "numerics.mode",
         choices=["dense", "quant", "quant_sparse"]),
    flag("--backward-sparsity", "sparsity.backward",
         choices=["none", "auto", "ref", "jnp", "interpret", "pallas"]),
    flag("--ckpt-dir", "train.ckpt_dir"),
)


def config_100m() -> LMConfig:
    """~100M params: 12L, d768, 12 heads, d_ff 3072, 32k vocab."""
    return LMConfig(
        name="llama-100m", d_model=768, vocab=32768, n_layers=12,
        pattern_unit=(("attn", "swiglu"),), n_units=12,
        attn=AttnSpec(n_heads=12, n_kv_heads=4, head_dim=64),
        d_ff=3072, tie_embeddings=True,
    )


def main(steps: int | None = None, argv: list[str] | None = None):
    """CLI entry point.  ``main(steps=1)`` runs the cpu-small preset for
    one step with default flags (the smoke-test path)."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    ap = argparse.ArgumentParser()
    ap.add_argument("--spec", default=None, metavar="PATH",
                    help="RunSpec file (JSON or TOML)")
    ap.add_argument("--set", dest="sets", action="append", default=[],
                    metavar="KEY=VALUE", help="dotted RunSpec override")
    ap.add_argument("--preset", default="cpu-small",
                    choices=["cpu-small", "pod-100m"])
    ap.add_argument("--device", default="cuda")
    for f in FLAGS:
        f.add_to(ap)
    if steps is not None and argv is None:
        argv = []  # programmatic call: don't read the host process argv
    args = ap.parse_args(argv)

    if args.preset == "pod-100m":
        # register the 100M config under the llama arch machinery
        arch = get_arch("llama3.2-1b")
        cfg = config_100m()
        arch = dataclasses.replace(arch, config=cfg, reduced=lambda: cfg)
        import repro_torch.configs.registry as reg

        reg.ARCHS["llama-100m"] = arch
        base = {"arch": {"id": "llama-100m"},
                "shape": {"batch": 32, "seq": 512}}
    else:
        base = {"arch": {"id": "llama3.2-1b"},
                "shape": {"batch": 8, "seq": 128}}
    base["train"] = {"steps": 300,
                     "ckpt_dir": os.path.join(tempfile.gettempdir(), "repro_torch_train_lm"),
                     "ckpt_every": 100, "log_every": 20}

    over = legacy_overrides(args, FLAGS, warn=False)
    if steps is not None:
        over.append(("train.steps", steps, "call:steps"))
    spec = build_spec("train", data=base, data_label=f"preset:{args.preset}",
                      spec_file=args.spec, overrides=over, sets=args.sets)
    # SR fixed-point master weights whenever the mode is quantized (the
    # pre-RunSpec behavior of this example), unless the spec said otherwise
    if (spec.numerics.mode != "dense"
            and spec.provenance.get("numerics.fixed_point_weights") == "default"):
        spec = dataclasses.replace(
            spec, numerics=dataclasses.replace(
                spec.numerics, fixed_point_weights=True),
            provenance={**spec.provenance,
                        "numerics.fixed_point_weights": f"preset:{args.preset}"})
    res = TrainSession(spec, device=args.device).run()
    print(f"final: loss {res['first_loss']:.4f} -> {res['last_loss']:.4f} "
          f"over {spec.train.steps} steps; {res['slow_steps']} slow steps; "
          f"checkpoints in {spec.train.ckpt_dir} [spec {res['spec_hash']}]")
    return res


if __name__ == "__main__":
    main()
