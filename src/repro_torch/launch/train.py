"""Training launcher (port of ``repro/launch/train.py``): a thin adapter
over the RunSpec API, plus the CNN runner of ``examples/sr_accuracy_parity.py``.

LM training from a spec, as in the reference:

  python -m repro_torch.launch.train --spec examples/specs/train_quant_sparse.json \
      --set train.ckpt_dir= --device cpu                   # CPU, reduced, plain versions
  python -m repro_torch.launch.train --spec examples/specs/train_quant_sparse.json \
      --set arch.reduced=false --set train.steps=6 --set train.ckpt_dir=   # GPU, full width
  python -m repro_torch.launch.train --set train.steps=300 --set shape.seq=128
  torchrun --nproc-per-node 2 -m repro_torch.launch.train --set shape.mesh.data=2 \
      --set train.ckpt_dir=                                 # one rank per process

The session is :class:`repro_torch.api.TrainSession`; the legacy flags
(``--arch``, ``--steps``, ``--stash``, ``--kernel-impl``, ...) shim to the
same RunSpec fields with a DeprecationWarning, ``--explain`` prints each
field with its layer, ``--json`` writes the result with the canonical
spec, and the last line is the reference's ``loss a -> b (N steps,
slow=k) [spec h]``.  ``--device`` (default ``cuda``) configures nothing
numerical: without a card it raises, ``--device cpu`` runs the plain
versions.  Weights are random, made from ``seeds.seed``; the tokens are
the reference's.  :func:`train_loop` keeps the reference's keyword
signature (plus ``device``).  With an explicit ``shape.mesh`` every rank
(one process each, under ``torchrun``) runs the session and rank 0 alone
prints the result.

The CNN runner, chosen by ``--cnn`` or ``--arms``:

  python -m repro_torch.launch.train --cnn vgg19 --hw 224 --batch 32 \
      --steps 3 --mode quant_sparse --stash stash           # GPU, full width
  python -m repro_torch.launch.train --cnn tiny_cnn --hw 16 --device cpu
  python -m repro_torch.launch.train --arms --steps 100     # fp32 / SR / nearest

:func:`run_arm` trains one arm: SyntheticImageTask, SGD-momentum (lr 0.05,
momentum 0.9) with Q4.16 SR master weights in the quantized modes, as the
example does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
import sys
import time
from typing import Optional

import torch

from repro_torch.api.cli import flag, make_parser, run_main
from repro_torch.api.sessions import TrainSession, train_spec
from repro_torch.api.spec import SpecError
from repro_torch.core.fixedpoint import SPRING_FORMAT
from repro_torch.core.spring_ops import DENSE, MODES, QUANT, SpringConfig
from repro_torch.data.pipeline import DataConfig, SyntheticImageTask
from repro_torch.dist.mesh import is_rank0
from repro_torch.kernels.masked_matmul.ops import record_tile_skip
from repro_torch.memstash.config import STASH_POLICIES, MemstashConfig
from repro_torch.memstash.instrument import record_stash_traffic, summarize
from repro_torch.models.cnn import PAPER_CNNS, CNNDef, cnn_init, conv, fc, gap
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.runtime.train import StepConfig, init_train_state, make_cnn_train_step
from repro_torch.serving.engine import resolve_device


#: Legacy flag spellings -> RunSpec fields (all warn with the --set form)
LEGACY_FLAGS = (
    flag("--arch", "arch.id"),
    flag("--reduced", "arch.reduced", const=True),
    flag("--steps", "train.steps", type=int),
    flag("--batch", "shape.batch", type=int),
    flag("--seq", "shape.seq", type=int),
    flag("--mode", "numerics.mode", choices=list(MODES)),
    flag("--lr", "optimizer.lr", type=float),
    flag("--fixed-point-weights", "numerics.fixed_point_weights", const=True),
    flag("--kernel-impl", "kernels.policy"),
    flag("--backward-sparsity", "sparsity.backward",
         choices=["none", "auto", "ref", "jnp", "interpret", "pallas"]),
    flag("--stash", "memstash.policy", choices=["none", "remat", "stash"]),
    flag("--ckpt-dir", "train.ckpt_dir"),
    flag("--ckpt-every", "train.ckpt_every", type=int),
)


def train_loop(
    arch_id: str = "llama3.2-1b",
    *,
    reduced: bool = True,
    steps: int = 100,
    batch: int = 8,
    seq: int = 128,
    mode: str = "dense",
    lr: float = 3e-3,
    fixed_point_weights: bool = False,
    kernel_impl: str | None = None,
    backward_sparsity: str = "auto",
    stash: str = "none",
    ckpt_dir: str | None = None,
    ckpt_every: int = 100,
    log_every: int = 10,
    mesh=None,
    seed: int = 0,
    device="cuda",
) -> dict:
    """The reference's keyword surface: builds the equivalent RunSpec and
    runs a :class:`repro_torch.api.TrainSession` on ``device``."""
    spec = train_spec(
        arch_id, reduced=reduced, steps=steps, batch=batch, seq=seq,
        mode=mode, lr=lr, fixed_point_weights=fixed_point_weights,
        kernel_impl=kernel_impl, backward_sparsity=backward_sparsity,
        stash=stash, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
        log_every=log_every, seed=seed)
    return TrainSession(spec, mesh=mesh, device=device).run()


def build_parser() -> argparse.ArgumentParser:
    """The spec surface: ``--spec`` / ``--set`` / ``--explain`` / ``--json``,
    the legacy flags, and ``--device``."""
    ap = make_parser(__doc__, LEGACY_FLAGS, json_out=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the CUDA kernels, the default) or "
                         "cpu (their plain versions); not a spec field")
    return ap


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


def build_cnn_parser() -> argparse.ArgumentParser:
    """The CNN runner's options (``--cnn`` / ``--arms``)."""
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
    argv = sys.argv[1:] if argv is None else list(argv)
    if any(a in ("--cnn", "--arms") or a.startswith("--cnn=") for a in argv):
        return cnn_main(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    args = build_parser().parse_args(argv)
    spec = run_main("train", args, LEGACY_FLAGS)
    try:
        session = TrainSession(spec, device=args.device)
    except SpecError as e:
        raise SystemExit(f"error: {e}") from None
    out = session.run()
    if not is_rank0():  # every rank of a mesh trains; rank 0 reports
        return out
    print(f"loss {out['first_loss']:.4f} -> {out['last_loss']:.4f} "
          f"({spec.train.steps} steps, slow={out['slow_steps']}) "
          f"[spec {out['spec_hash']}]")
    if args.json:
        payload = {k: v for k, v in out.items() if k != "state"}
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2, default=float)
    return out


def cnn_main(argv) -> dict:
    a = build_cnn_parser().parse_args(argv)
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
