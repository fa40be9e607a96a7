"""Serving launcher (port of ``repro/launch/serve.py``).

  python -m repro_torch.launch.serve --arch llama3.2-1b --mode quant_sparse \
      --slots 4 --queue 6 --prompt-len 32 --gen 16            # GPU, full width
  python -m repro_torch.launch.serve --arch llama3.2-1b --queue 4 \
      --prompt-len 4096 --gen 16                              # long prompts
  python -m repro_torch.launch.serve --arch mamba2-780m --queue 6 \
      --prompt-len 2000 --gen 16                              # Mamba-2
  python -m repro_torch.launch.serve --reduced --device cpu   # CPU, plain versions
  python -m repro_torch.launch.serve --snapshot-every 4 --snapshot-path s.npz
  python -m repro_torch.launch.serve --restore s.npz          # drain a snapshot
  python -m repro_torch.launch.serve --sample --telemetry --trace-path t.json

The pool's ``max_len`` follows ``--prompt-len`` + ``--gen``.

Each flag stands for the RunSpec field named in its help; the RunSpec API
itself is not ported yet.  Weights are random, made from ``--seed``, and
so are the prompts.  Serving numerics round to nearest (``serving_config``).
With ``--restore`` the engine restores the snapshot and drains its
in-flight work, taking no new requests, as the reference's session does.
``--telemetry`` serves inside a telemetry scope: the engine's spans go to
a Chrome trace (``--trace-path``, default ``spring_serve_trace.json``) and
the output gains a ``telemetry`` block with the metrics.  Prints the
engine summary as one JSON object.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
from typing import Optional

import torch

from repro_torch import telemetry
from repro_torch.configs import get_arch
from repro_torch.core.spring_ops import MODES, SpringConfig
from repro_torch.serving.engine import ServingEngine, resolve_device
from repro_torch.serving.scheduler import ShedPolicy

#: snapshot file when snapshots are on and no path is given (the reference's)
DEFAULT_SNAPSHOT_PATH = "spring_snapshot.npz"


def serving_config(mode: str) -> SpringConfig:
    """SpringConfig for serving: the chosen mode with nearest rounding — SR
    would couple a request's tokens to its batch co-tenants."""
    return dataclasses.replace(MODES[mode], stochastic=False)


def synthetic_prompts(n: int, prompt_len: int, vocab: int, seed: int) -> list:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (n, prompt_len), generator=gen).tolist()


def state_hash(**fields) -> str:
    """Stamp of what decides a served run's numerical state (the RunSpec's
    ``state_hash`` role): every field but the snapshot and restore paths,
    the telemetry switches and the device; a snapshot restores only under
    the same stamp."""
    compact = json.dumps(fields, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(compact.encode()).hexdigest()[:16]


def serve_session(arch: str = "llama3.2-1b", *, reduced: bool = False,
                  mode: str = "quant_sparse", slots: int = 4, queue: int = 4,
                  prompt_len: int = 32, gen: int = 16, seed: int = 0, greedy: bool = True,
                  snapshot_every: int = 0, snapshot_path: str = "", restore_path: str = "",
                  max_queue_depth: Optional[int] = None, deadline_ticks: Optional[int] = None,
                  telemetry_enabled: bool = False, trace_path: str = "",
                  device="cuda") -> dict:
    """Build an engine over random weights, submit ``queue`` synthetic
    requests (or restore ``restore_path`` and take none) and drain them;
    returns the engine summary."""
    if snapshot_every < 0:
        raise ValueError("snapshot_every must be >= 0")
    if max_queue_depth is not None and max_queue_depth < 1:
        raise ValueError("max_queue_depth must be >= 1 (or None)")
    if deadline_ticks is not None and deadline_ticks < 0:
        raise ValueError("deadline_ticks must be >= 0 (or None)")
    if snapshot_every:
        snapshot_path = snapshot_path or DEFAULT_SNAPSHOT_PATH
        if restore_path and snapshot_path == restore_path:
            # the snapshots would overwrite the artifact being drained
            raise ValueError("restore_path equals the snapshot output path; "
                             "give snapshot_path another file")
    device = resolve_device(device)
    cfg = get_arch(arch).resolve(reduced)
    stamp = state_hash(arch=arch, reduced=reduced, mode=mode, slots=slots, queue=queue,
                       prompt_len=prompt_len, gen=gen, seed=seed, greedy=greedy,
                       max_queue_depth=max_queue_depth, deadline_ticks=deadline_ticks)
    shed = (None if max_queue_depth is None and deadline_ticks is None
            else ShedPolicy(max_queue_depth=max_queue_depth, deadline_ticks=deadline_ticks))
    trace_path = (trace_path or "spring_serve_trace.json") if telemetry_enabled else ""
    scope = telemetry.TelemetryConfig(enabled=telemetry_enabled, trace_path=trace_path)
    with telemetry.scope(scope, metadata={"run": "serve", "spec_hash": stamp}):
        engine = ServingEngine(cfg, serving_config(mode), n_slots=slots,
                               max_len=prompt_len + gen + 1, greedy=greedy, seed=seed,
                               spec_hash=stamp, shed=shed, snapshot_every=snapshot_every,
                               snapshot_path=snapshot_path, device=device)
        if restore_path:
            engine.restore_file(restore_path)
        else:
            for i, p in enumerate(synthetic_prompts(queue, prompt_len, cfg.vocab, seed)):
                engine.submit_prompt(p, gen, seed=seed + i)
        out = engine.run()
        if telemetry_enabled:
            tr = telemetry.tracer()
            out["telemetry"] = {"metrics": telemetry.metrics().snapshot(),
                                "trace_path": trace_path, "sample_rate": scope.sample_rate,
                                "spans": len(tr)}
    out.update(arch=cfg.name, mode=mode, slots=engine.n_slots, spec_hash=stamp)
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", default="llama3.2-1b", help="RunSpec arch.id")
    p.add_argument("--reduced", action="store_true", help="RunSpec arch.reduced")
    p.add_argument("--mode", default="quant_sparse", choices=list(MODES),
                   help="RunSpec numerics.mode")
    p.add_argument("--slots", type=int, default=4, help="RunSpec serving.slots")
    p.add_argument("--queue", type=int, default=4, help="RunSpec serving.queue")
    p.add_argument("--prompt-len", type=int, default=32, help="RunSpec shape.prompt_len")
    p.add_argument("--gen", type=int, default=16, help="RunSpec shape.gen")
    p.add_argument("--seed", type=int, default=0, help="RunSpec seeds.seed")
    p.add_argument("--greedy", dest="greedy", action="store_true", default=True,
                   help="RunSpec serving.greedy=true (the default)")
    p.add_argument("--sample", dest="greedy", action="store_false",
                   help="RunSpec serving.greedy=false")
    p.add_argument("--snapshot-every", type=int, default=0,
                   help="RunSpec serving.snapshot_every")
    p.add_argument("--snapshot-path", default="", help="RunSpec serving.snapshot_path")
    p.add_argument("--restore", default="", help="RunSpec serving.restore_path")
    p.add_argument("--max-queue-depth", type=int, default=None,
                   help="RunSpec serving.max_queue_depth")
    p.add_argument("--deadline-ticks", type=int, default=None,
                   help="RunSpec serving.deadline_ticks")
    p.add_argument("--telemetry", action="store_true", help="RunSpec telemetry.enabled")
    p.add_argument("--trace-path", default="", help="RunSpec telemetry.trace_path")
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda by default; cpu runs the plain versions)")
    return p


def main(argv=None) -> dict:
    a = build_parser().parse_args(argv)
    out = serve_session(a.arch, reduced=a.reduced, mode=a.mode, slots=a.slots,
                        queue=a.queue, prompt_len=a.prompt_len, gen=a.gen, seed=a.seed,
                        greedy=a.greedy, snapshot_every=a.snapshot_every,
                        snapshot_path=a.snapshot_path, restore_path=a.restore,
                        max_queue_depth=a.max_queue_depth, deadline_ticks=a.deadline_ticks,
                        telemetry_enabled=a.telemetry, trace_path=a.trace_path,
                        device=a.device)
    print(json.dumps(out, default=float))
    return out


if __name__ == "__main__":
    main()
