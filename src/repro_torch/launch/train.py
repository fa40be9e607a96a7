"""CNN training launcher (port of ``examples/sr_accuracy_parity.py`` and
of the CNN side of ``repro/launch/train.py``).

  python -m repro_torch.launch.train --cnn vgg19 --hw 224 --batch 32 \
      --steps 3 --mode quant_sparse --stash stash           # GPU, full width
  python -m repro_torch.launch.train --cnn tiny_cnn --hw 16 --device cpu
  python -m repro_torch.launch.train --arms --steps 100     # fp32 / SR / nearest

:func:`run_arm` trains one arm: SyntheticImageTask, SGD-momentum (lr 0.05,
momentum 0.9) with Q4.16 SR master weights in the quantized modes, as the
example does.  Weights are random, made from ``--seed``.  The default
device is ``cuda``; without a card it raises, and ``--device cpu`` runs the
plain versions.  The LM path of ``repro.launch.train`` comes with LM
training.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from typing import Optional

import torch

from repro_torch.core.fixedpoint import SPRING_FORMAT
from repro_torch.core.spring_ops import DENSE, MODES, QUANT, SpringConfig
from repro_torch.data.pipeline import DataConfig, SyntheticImageTask
from repro_torch.kernels.masked_matmul.ops import record_tile_skip
from repro_torch.memstash.config import STASH_POLICIES, MemstashConfig
from repro_torch.memstash.instrument import record_stash_traffic, summarize
from repro_torch.models.cnn import PAPER_CNNS, CNNDef, cnn_init, conv, fc, gap
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.runtime.train import StepConfig, init_train_state, make_cnn_train_step
from repro_torch.serving.engine import resolve_device


def tiny_cnn(store, ctx, x):
    """The example's model (``examples/sr_accuracy_parity.py``)."""
    x = conv(store, ctx, "c1", x, 16, k=3, stride=2)
    x = conv(store, ctx, "c2", x, 32, k=3, stride=2)
    x = conv(store, ctx, "c3", x, 32, k=3)
    return fc(store, ctx, "head", gap(x), 10)


#: model name -> its definition: the example's tiny_cnn and the paper's seven
MODELS = {"tiny_cnn": CNNDef("tiny_cnn", tiny_cnn, 16), **PAPER_CNNS}


def on_grid(params: dict, fmt=SPRING_FORMAT) -> bool:
    """Every parameter is a Q(il,fl) grid point inside the format's range."""
    for p in params.values():
        scaled = p * 2.0**fmt.fl
        if not (torch.equal(scaled, torch.round(scaled))
                and bool(((p >= fmt.min_value) & (p <= fmt.max_value)).all())):
            return False
    return True


def run_arm(name: str, cnn: str, spring: SpringConfig | str, stochastic: bool, steps: int,
            hw: int, batch: int, device="cuda", memstash: Optional[MemstashConfig] = None,
            seed: int = 0, probe_step: Optional[int] = None, verbose: bool = True) -> dict:
    """Train ``cnn`` for ``steps`` steps under ``spring`` (a SpringConfig or
    a mode name) with SR on or off; returns losses, per-step times, the
    on-grid check of the weights after every step (quantized modes), peak
    device memory and, at ``probe_step``, the measured activation density
    of the stash points and the tile-skip fractions of every product."""
    device = resolve_device(device)
    if device.type == "cuda":
        # Q4.16 values carry 21 significant bits; TF32 keeps 11
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(device)
    if isinstance(spring, str):
        spring = MODES[spring]
    spring = dataclasses.replace(spring, stochastic=stochastic)
    wf = SPRING_FORMAT if spring.is_quantized else None
    step_cfg = StepConfig(spring=spring, memstash=memstash or MemstashConfig(),
                          optimizer=OptimizerConfig(kind="sgdm", lr=0.05, momentum=0.9,
                                                    weight_format=wf))
    data = SyntheticImageTask(DataConfig(seed=seed, global_batch=batch), hw=hw, device=device)
    state = init_train_state(cnn_init(seed, MODELS[cnn], hw, device=device), step_cfg, seed)
    step = make_cnn_train_step(MODELS[cnn].fn, step_cfg)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    losses, step_s, grid, probe = [], [], [], None
    for i in range(steps):
        x, y = data.batch(i)
        sync()
        t0 = time.monotonic()
        if i == probe_step:
            with record_tile_skip() as skip, record_stash_traffic() as rows:
                state, m = step(state, x, y)
            probe = {"tile_skip": {op: 1.0 - v[0] / v[1] for op, v in skip.items() if v[1]},
                     "stash": summarize(rows)}
        else:
            state, m = step(state, x, y)
        sync()
        step_s.append(time.monotonic() - t0)
        losses.append(float(m["loss"]))
        if wf is not None:
            grid.append(on_grid(state.params, wf))
        if verbose:
            print(f"[{name}] step {i} loss {losses[-1]:.4f} {step_s[-1]:.3f}s", flush=True)
    timed = step_s[1:] or step_s  # the first step pays for builds and autotuning
    s_per_step = sum(timed) / len(timed)
    tail = losses[-min(10, steps):]
    return {
        "name": name, "cnn": cnn, "mode": spring.mode, "stochastic": stochastic,
        "hw": hw, "batch": batch, "steps": steps, "device": str(device),
        "losses": losses, "tail": sum(tail) / len(tail),
        "finite": all(math.isfinite(v) for v in losses),
        "on_grid": grid, "step_s": step_s, "s_per_step": s_per_step,
        "images_per_s": batch / s_per_step,
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None),
        "probe": probe, "params": state.params,
    }


def parity_arms(steps: int = 150, batch: int = 32, device="cuda", seed: int = 0) -> dict:
    """The example's three arms on tiny_cnn at 16x16 (fp32 baseline, Q4.16
    SR, Q4.16 nearest) and the tail-loss gaps of SR and nearest against
    fp32."""
    out = {}
    for name, spring, sr in (("fp32", DENSE, True), ("sr", QUANT, True),
                             ("nearest", QUANT, False)):
        r = run_arm(name, "tiny_cnn", spring, sr, steps, 16, batch, device, seed=seed,
                    verbose=False)
        out[name] = {k: r[k] for k in ("losses", "tail", "finite", "s_per_step")}
    out["sr_gap"] = out["sr"]["tail"] - out["fp32"]["tail"]
    out["nearest_gap"] = out["nearest"]["tail"] - out["fp32"]["tail"]
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cnn", default="vgg19", choices=sorted(MODELS))
    p.add_argument("--hw", type=int, default=None, help="input size (default: the CNN's)")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--mode", default="quant_sparse", choices=list(MODES))
    p.add_argument("--nearest", action="store_true", help="round to nearest instead of SR")
    p.add_argument("--stash", default="none", choices=STASH_POLICIES,
                   help="memstash policy of every conv/fc stash point")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--arms", action="store_true",
                   help="run the example's fp32 / SR / nearest arms (tiny_cnn at hw 16) "
                        "and print the gaps")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda by default; cpu runs the plain versions)")
    return p


def main(argv=None) -> dict:
    a = build_parser().parse_args(argv)
    if a.arms:
        out = parity_arms(a.steps, batch=a.batch, device=a.device, seed=a.seed)
        print(f"SR gap vs fp32:      {out['sr_gap']:+.4f}  (paper claim: ~0)")
        print(f"nearest gap vs fp32: {out['nearest_gap']:+.4f}")
        return out
    out = run_arm(a.cnn, a.cnn, a.mode, not a.nearest, a.steps,
                  a.hw or MODELS[a.cnn].input_hw, a.batch, a.device,
                  MemstashConfig(policy=a.stash), a.seed)
    out.pop("params")
    print(json.dumps(out, default=float))
    return out


if __name__ == "__main__":
    main()
