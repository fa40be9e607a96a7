"""Activation-sparsity measurement (port of ``repro/core/activation_stats.py``).

SPRING's training claim rests on ReLU-era CNNs keeping roughly 62%
activation sparsity throughout training (paper §1).  These helpers measure
it on the runnable CNNs.
"""

from __future__ import annotations

import torch


def relu_sparsity_probe(apply_fn, *args) -> dict:
    """Run ``apply_fn(probed_relu, *args)``, recording the zero fraction of
    every ``probed_relu`` output."""
    records: list[float] = []

    def probed_relu(x):
        y = torch.relu(x)
        records.append(float((y == 0.0).to(torch.float32).mean()))
        return y

    out = apply_fn(probed_relu, *args)
    if not records:
        return {"mean_sparsity": 0.0, "layers": 0}
    return {
        "mean_sparsity": sum(records) / len(records),
        "min_sparsity": min(records),
        "max_sparsity": max(records),
        "layers": len(records),
        "output": out,
    }


def tensor_sparsity(x: torch.Tensor) -> float:
    return float((x == 0.0).to(torch.float32).mean())
