"""Paper Figs. 11-16: SPRING vs GTX 1080 Ti across the seven CNNs —
performance (11/12), reciprocal power (13/14), energy efficiency (15/16)
for training and inference, from the analytical model (port of
``benchmarks/bench_paper_figs.py``; ``repro_torch.perfmodel``).

    python -m repro_torch.benchmarks.bench_paper_figs [--measured [--device cuda|cpu]]

Rows: name, us_per_call = modeled SPRING batch latency (us),
derived = the figure's ratio (speedup | power reduction | energy eff).
``--measured`` first runs ``sparsity_probe`` (one masked_matmul forward
and backward on block-pruned operands, on the card's kernels by default)
and passes the measured forward and backward tile-skip fractions to the
model in place of its analytic density product.
"""

from __future__ import annotations

import argparse
from typing import Optional

from repro_torch.models.cnn import PAPER_CNNS
from repro_torch.perfmodel.spring_model import evaluate_cnn, geomean

PAPER_GEOMEANS = {
    ("train", "speedup"): 15.6,
    ("train", "power_reduction"): 4.2,
    ("train", "energy_eff"): 66.0,
    ("inference", "speedup"): 15.5,
    ("inference", "power_reduction"): 4.5,
    ("inference", "energy_eff"): 69.1,
}

_FIG = {
    ("train", "speedup"): "fig11_perf_train",
    ("inference", "speedup"): "fig12_perf_infer",
    ("train", "power_reduction"): "fig13_power_train",
    ("inference", "power_reduction"): "fig14_power_infer",
    ("train", "energy_eff"): "fig15_energy_train",
    ("inference", "energy_eff"): "fig16_energy_infer",
}


def rows(compute_skip_fraction: Optional[float] = None,
         backward_skip_fraction: Optional[float] = None) -> list[tuple[str, float, float]]:
    """The figures' rows; with no skip fractions, the reference's rows."""
    out = []
    for training in (True, False):
        phase = "train" if training else "inference"
        results = [evaluate_cnn(d, training=training,
                                compute_skip_fraction=compute_skip_fraction,
                                backward_skip_fraction=backward_skip_fraction)
                   for d in PAPER_CNNS.values()]
        for metric in ("speedup", "power_reduction", "energy_eff"):
            fig = _FIG[(phase, metric)]
            for r in results:
                out.append((f"{fig}.{r['cnn']}", r["spring_time_s"] * 1e6, r[metric]))
            gm = geomean(r[metric] for r in results)
            out.append((f"{fig}.GEOMEAN", 0.0, gm))
            out.append((f"{fig}.PAPER_GEOMEAN", 0.0, PAPER_GEOMEANS[(phase, metric)]))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--measured", action="store_true",
                    help="ground the compute term in sparsity_probe's tile-skip fractions")
    ap.add_argument("--device", default="cuda", help="where sparsity_probe runs")
    args = ap.parse_args(argv)
    skips = {}
    if args.measured:
        from repro_torch.kernels.masked_matmul.backward import sparsity_probe

        probe = sparsity_probe(device=args.device)
        skips = {"compute_skip_fraction": probe["forward_tile_skip"],
                 "backward_skip_fraction": probe["backward_tile_skip"]}
        print(f"# sparsity_probe on {args.device}: {probe}")
    print("name,us_per_call,derived")
    for name, us, derived in rows(**skips):
        print(f"{name},{us},{derived:.6g}")


if __name__ == "__main__":
    main()
