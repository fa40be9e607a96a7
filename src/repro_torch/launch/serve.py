"""Serving launcher (port of ``repro/launch/serve.py``).

  python -m repro_torch.launch.serve --arch llama3.2-1b --mode quant_sparse \
      --slots 4 --queue 6 --prompt-len 32 --gen 16            # GPU, full width
  python -m repro_torch.launch.serve --arch llama3.2-1b --queue 4 \
      --prompt-len 4096 --gen 16                              # long prompts
  python -m repro_torch.launch.serve --arch mamba2-780m --queue 6 \
      --prompt-len 2000 --gen 16                              # Mamba-2
  python -m repro_torch.launch.serve --reduced --device cpu   # CPU, plain versions

The pool's ``max_len`` follows ``--prompt-len`` + ``--gen``.

Each flag stands for the RunSpec field named in its help; the RunSpec API
itself is not ported yet.  Weights are random, made from ``--seed``, and
so are the prompts.  Serving numerics round to nearest (``serving_config``).
Prints the engine summary as one JSON object.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch.configs import get_arch
from repro_torch.core.spring_ops import MODES, SpringConfig
from repro_torch.serving.engine import ServingEngine, resolve_device


def serving_config(mode: str) -> SpringConfig:
    """SpringConfig for serving: the chosen mode with nearest rounding — SR
    would couple a request's tokens to its batch co-tenants."""
    return dataclasses.replace(MODES[mode], stochastic=False)


def synthetic_prompts(n: int, prompt_len: int, vocab: int, seed: int) -> list:
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (n, prompt_len), generator=gen).tolist()


def serve_session(arch: str = "llama3.2-1b", *, reduced: bool = False,
                  mode: str = "quant_sparse", slots: int = 4, queue: int = 4,
                  prompt_len: int = 32, gen: int = 16, seed: int = 0,
                  device="cuda") -> dict:
    """Build an engine over random weights, submit ``queue`` synthetic
    requests and drain them; returns the engine summary."""
    device = resolve_device(device)
    cfg = get_arch(arch).resolve(reduced)
    engine = ServingEngine(cfg, serving_config(mode), n_slots=slots,
                           max_len=prompt_len + gen + 1, seed=seed, device=device)
    for i, p in enumerate(synthetic_prompts(queue, prompt_len, cfg.vocab, seed)):
        engine.submit_prompt(p, gen, seed=seed + i)
    out = engine.run()
    out.update(arch=cfg.name, mode=mode, slots=slots)
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
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda by default; cpu runs the plain versions)")
    return p


def main(argv=None) -> dict:
    a = build_parser().parse_args(argv)
    out = serve_session(a.arch, reduced=a.reduced, mode=a.mode, slots=a.slots,
                        queue=a.queue, prompt_len=a.prompt_len, gen=a.gen,
                        seed=a.seed, device=a.device)
    print(json.dumps(out, default=float))
    return out


if __name__ == "__main__":
    main()
