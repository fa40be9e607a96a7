"""Measure per-layer stash traffic for the paper CNNs and an LM block
(port of ``repro/memstash/report.py``).

Runs model forwards under the stash-traffic recorder (ReLU gives the CNNs
their natural activation sparsity) and writes one JSON per model, in the
reference's layout, into ``results/memstash/``.  Weights and inputs are
random from ``seed`` (``torch.Generator`` draws: the numbers are the
port's own, the layout and the accounting the reference's).  Runs on the
card unless ``--device cpu`` asks for the CPU.

  PYTHONPATH=src python -m repro_torch.memstash.report --cnn mobilenet_v2 --hw 96
  PYTHONPATH=src python -m repro_torch.memstash.report --all-cnns --out results/memstash
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.memstash.config import MemstashConfig
from repro_torch.memstash.instrument import record_stash_traffic, summarize


def measure_cnn_stash(name: str = "mobilenet_v2", hw: int = 96, batch: int = 2,
                      scfg: MemstashConfig | None = None, seed: int = 0,
                      device="cuda") -> dict:
    """Per-layer stash accounting for one paper CNN."""
    from repro_torch.models.cnn import PAPER_CNNS, cnn_apply, cnn_init
    from repro_torch.models.layers import SpringContext
    from repro_torch.serving.engine import resolve_device

    if name not in PAPER_CNNS:
        raise SystemExit(f"unknown CNN {name!r}; choose from {sorted(PAPER_CNNS)}")
    device = resolve_device(device)
    cnn = PAPER_CNNS[name]
    if scfg is None:
        from repro_torch.configs.base import default_memstash

        scfg = default_memstash("cnn")
    params = cnn_init(seed, cnn, input_hw=hw, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.randn((batch, hw, hw, 3), generator=gen, device=device)
    ctx = SpringContext(memstash=scfg)
    with torch.no_grad(), record_stash_traffic() as rows:
        cnn_apply(params, cnn, x, ctx)
    return {"model": name, "kind": "cnn", "hw": hw, "batch": batch,
            "rows": rows, "summary": summarize(rows)}


def measure_lm_stash(arch_id: str = "llama3.2-1b", batch: int = 2, seq: int = 64,
                     scfg: MemstashConfig | None = None, seed: int = 0,
                     device="cuda") -> dict:
    """Stash accounting for one reduced-LM residual block.

    LM residual streams are dense, so this measures the stash format's
    graceful-degradation point: ~logical bytes + 1 mask bit/elem.
    """
    from repro_torch.configs import get_arch
    from repro_torch.memstash.stash import stash_apply
    from repro_torch.models import lm as lm_mod
    from repro_torch.models.layers import SpringContext, embed_apply
    from repro_torch.optim.optimizers import tree_leaves, tree_map
    from repro_torch.serving.engine import resolve_device

    device = resolve_device(device)
    cfg = get_arch(arch_id).reduced()
    scfg = scfg or MemstashConfig(policy="stash")
    params = lm_mod.lm_init(cfg, seed, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen, device=device)
    ctx = SpringContext(memstash=scfg)
    x = embed_apply(params["embed"], tokens, ctx)
    positions = torch.arange(seq, device=device).expand(batch, seq)
    # the first layer of the first unit (the reference's params["unit_0"][0])
    unit0 = params["layers"][len(cfg.prefix)]
    kind = cfg.pattern_unit[0]

    def block(h, leaves):
        leaves = iter(leaves)
        p = tree_map(lambda _: next(leaves), unit0)
        out, _, _ = lm_mod.block_apply(p, h, ctx, cfg, kind, positions)
        return out

    with torch.no_grad(), record_stash_traffic() as rows:
        stash_apply(block, scfg, f"{arch_id}/unit0", x, tuple(tree_leaves(unit0)))
    return {"model": arch_id, "kind": "lm_block", "batch": batch, "seq": seq,
            "rows": rows, "summary": summarize(rows)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cnn", action="append", default=[])
    ap.add_argument("--all-cnns", action="store_true")
    ap.add_argument("--lm", action="append", default=[])
    ap.add_argument("--hw", type=int, default=96)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--out", default="results/memstash")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    jobs = list(args.cnn)
    if args.all_cnns:
        from repro_torch.models.cnn import PAPER_CNNS

        jobs = sorted(PAPER_CNNS)
    if not jobs and not args.lm:
        jobs = ["mobilenet_v2"]

    os.makedirs(args.out, exist_ok=True)
    for name in jobs:
        hw = min(args.hw, 96)  # the reference's clamp (its eager CPU forwards)
        if hw != args.hw:
            print(f"note: --hw {args.hw} clamped to {hw} (eager CPU forwards; "
                  f"JSONs record the measured resolution)")
        res = measure_cnn_stash(name, hw=hw, batch=args.batch, device=args.device)
        path = os.path.join(args.out, f"{name}.json")
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        s = res["summary"]
        if not s.get("stash_points"):
            print(f"{name}: no stash points recorded (policy resolved everything to none)")
            continue
        print(f"{name}: {s['stash_points']} points, density {s['mean_density']:.3f}, "
              f"{s['dense_fp32_bytes']/1e6:.2f} MB fp32 -> {s['wire_bytes']/1e6:.2f} MB wire "
              f"({s['compression_vs_fp32']:.2f}x), wire/formula {s['wire_vs_formula']:.4f}")
    for arch_id in args.lm:
        res = measure_lm_stash(arch_id, batch=args.batch, device=args.device)
        path = os.path.join(args.out, f"{arch_id.replace('/', '_')}_block.json")
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
        s = res["summary"]
        if not s.get("stash_points"):
            print(f"{arch_id} block: no stash points recorded")
            continue
        print(f"{arch_id} block: density {s['mean_density']:.3f}, "
              f"{s['dense_fp32_bytes']/1e6:.2f} MB fp32 -> {s['wire_bytes']/1e6:.2f} MB wire")


if __name__ == "__main__":
    main()
