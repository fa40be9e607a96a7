"""Continuous-batching serving demo (twin of the reference's
``examples/serve_batched.py``): submit a queue of prompts over a fixed
slot pool, decode with the sparsity-compressed KV cache, report
latency/throughput/compression.

The example is a thin adapter over the RunSpec API — the whole run is
one declarative spec:

  PYTHONPATH=src python -m repro_torch.examples.serve_batched \
      --spec examples/specs/serve_quant_sparse.json --device cpu
  PYTHONPATH=src python -m repro_torch.examples.serve_batched --arch llama3.2-1b \
      --batch 4 --slots 2 --queue 6 --gen 24 --mode quant_sparse --seed 7
"""

import argparse

from repro_torch.api.cli import flag, legacy_overrides
from repro_torch.api.sessions import ServeSession
from repro_torch.api.spec import build_spec

# The short flags are this example's convenience surface; each one is an
# alias for the --set spelling of the same RunSpec field (no deprecation
# here — the example documents both).
FLAGS = (
    flag("--arch", "arch.id"),
    flag("--batch", "shape.batch", type=int),
    flag("--prompt-len", "shape.prompt_len", type=int),
    flag("--gen", "shape.gen", type=int),
    flag("--mode", "numerics.mode",
         choices=["dense", "quant", "quant_sparse"]),
    flag("--kernel-impl", "kernels.policy"),
    flag("--slots", "serving.slots", type=int),
    flag("--queue", "serving.queue", type=int),
    flag("--greedy", "serving.greedy", const=True, dest="legacy_greedy"),
    flag("--sample", "serving.greedy", const=False, dest="legacy_greedy"),
    flag("--seed", "seeds.seed", type=int),
    flag("--pages", "serving.pages", const=True),
    flag("--page-tokens", "serving.page_tokens", type=int),
    flag("--prefix-cache", "serving.prefix_cache", type=lambda s: s.lower()
         not in ("0", "false", "no", "off")),
)


def main(argv: list | None = None):
    """CLI entry point; ``main(argv=[...])`` is the smoke-test path."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--spec", default=None, metavar="PATH",
                    help="RunSpec file (JSON or TOML)")
    ap.add_argument("--set", dest="sets", action="append", default=[],
                    metavar="KEY=VALUE", help="dotted RunSpec override")
    ap.add_argument("--device", default="cuda")
    for f in FLAGS:
        f.add_to(ap)
    args = ap.parse_args(argv)

    # base layer = this example's historical defaults (batch 4)
    spec = build_spec("serve", data={"shape": {"batch": 4}},
                      data_label="example-default",
                      spec_file=args.spec, sets=args.sets,
                      overrides=legacy_overrides(args, FLAGS, warn=False))
    out = ServeSession(spec, device=args.device).run()
    print(f"arch={spec.arch.id} mode={spec.numerics.mode} "
          f"slots={out.get('slots', spec.shape.batch)} "
          f"spec={out['spec_hash']}")
    print(f"  prefill: {out['prefill_s']*1e3:8.1f} ms")
    print(f"  decode:  {out['decode_s']*1e3:8.1f} ms  ({out['tokens_per_s']:.1f} tok/s)")
    if out.get("engine"):
        lat = sorted(r["latency_s"] for r in out["per_request"])
        print(f"  latency: p50 {lat[len(lat)//2]*1e3:.0f} ms  "
              f"p100 {lat[-1]*1e3:.0f} ms  occupancy {out['mean_occupancy']:.2f}")
        print(f"  kv:      {out['kv_mean_wire_bytes']/1e3:.1f} KB/step wire, "
              f"{out['kv_traffic_reduction_vs_fp32']:.2f}x less than dense fp32")
        if out.get("paging"):
            p = out["paging"]
            print(f"  pages:   {p['num_pages']} x {p['page_tokens']} tok "
                  f"(x{p['overcommit']:.1f} logical)  "
                  f"prefix hits {p['prefix_hits']}  cow {p['cow_copies']}  "
                  f"spills {p['spills']}")
        for r in out["per_request"]:
            print(f"  req {r['rid']:>3}: queue {r['queue_s']*1e3:6.1f} ms  "
                  f"ttft {r['ttft_s']*1e3:6.1f} ms  "
                  f"total {r['latency_s']*1e3:6.1f} ms  "
                  f"{r['n_tokens']} tok  ticks {r['enqueue_tick']}->"
                  f"{r['first_token_tick']}->{r['finish_tick']} "
                  f"({r['finished_by']})")
    print(f"  sample:  {out['generated'][0][:10].tolist()}")
    assert out["finite"]
    return out


if __name__ == "__main__":
    main()
