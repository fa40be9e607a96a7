"""Serving launcher: a thin adapter over the RunSpec API (port of
``repro/launch/serve.py``).

  python -m repro_torch.launch.serve --spec examples/specs/serve_quant_sparse.json \\
      --set arch.reduced=false --set kernels.policy=auto          # GPU, full width
  python -m repro_torch.launch.serve --spec examples/specs/serve_quant_sparse.json \\
      --device cpu                                                # CPU, plain versions
  python -m repro_torch.launch.serve --set arch.id=llama3.2-1b --set arch.reduced=false \\
      --set serving.slots=2 --set serving.queue=6 --set numerics.mode=quant_sparse
  python -m repro_torch.launch.serve --set serving.snapshot_every=4 \\
      --set serving.snapshot_path=s.npz
  python -m repro_torch.launch.serve --set serving.restore_path=s.npz   # drain it
  python -m repro_torch.launch.serve --set telemetry.enabled=true \\
      --set telemetry.trace_path=t.json
  torchrun --nproc-per-node 4 -m repro_torch.launch.serve --set shape.mesh.data=4 \\
      --set serving.static=true --device cpu      # request rows over 4 ranks

The session lives in :class:`repro_torch.api.ServeSession`; the static
batch loop survives behind ``serving.static=true``.  Legacy flag
spellings (``--slots``, ``--queue``, ``--pages``, ``--restore``, ...) shim
to the same RunSpec fields with a DeprecationWarning.  ``arch.reduced``
left null serves the reduced model, as in the reference: full width is
``--set arch.reduced=false``.  ``--device`` (default ``cuda``) is the one
option that configures nothing numerical; ``kernels.policy`` must name
what runs there (``auto`` or ``pallas`` on the card, ``auto``, ``ref`` or
``jnp`` on the CPU), else the run stops with the ``SpecError``.  Weights
are random, made from ``seeds.seed``, and the prompts are the
reference's.  Snapshots are stamped with ``RunSpec.state_hash()``, so a
snapshot written by either package's launcher restores in the other's
under the same spec.  With an explicit ``shape.mesh`` every rank (one
process each, under ``torchrun``) runs the session and rank 0 alone
prints the result.

Serving numerics: quantized modes round to nearest, so a request's tokens
are a function of the request alone, not of its batch co-tenants.

``serve_session`` / ``static_reference_session`` / ``serving_config``
keep the reference's signatures (plus ``device``) for programmatic
callers.
"""

from __future__ import annotations

import json

from repro_torch.api.cli import flag, make_parser, run_main
from repro_torch.api.sessions import ServeSession, serve_spec
from repro_torch.api.spec import NumericsSection, RunSpec, SpecError
from repro_torch.core.spring_ops import MODES, SpringConfig
from repro_torch.dist.mesh import is_rank0

LEGACY_FLAGS = (
    flag("--arch", "arch.id"),
    flag("--reduced", "arch.reduced", const=True),
    flag("--batch", "shape.batch", type=int),
    flag("--prompt-len", "shape.prompt_len", type=int),
    flag("--gen", "shape.gen", type=int),
    flag("--mode", "numerics.mode", choices=list(MODES)),
    flag("--kernel-impl", "kernels.policy"),
    flag("--slots", "serving.slots", type=int),
    flag("--queue", "serving.queue", type=int),
    flag("--greedy", "serving.greedy", const=True, dest="legacy_greedy"),
    flag("--sample", "serving.greedy", const=False, dest="legacy_greedy"),
    flag("--seed", "seeds.seed", type=int),
    flag("--static", "serving.static", const=True),
    flag("--pages", "serving.pages", const=True),
    flag("--page-tokens", "serving.page_tokens", type=int),
    flag("--prefix-cache", "serving.prefix_cache", type=lambda s: s.lower()
         not in ("0", "false", "no", "off")),
    # spring-survive: periodic snapshots, restore-and-drain, load shedding
    flag("--snapshot-every", "serving.snapshot_every", type=int),
    flag("--snapshot-path", "serving.snapshot_path"),
    flag("--restore", "serving.restore_path"),
    flag("--max-queue-depth", "serving.max_queue_depth", type=int),
    flag("--deadline-ticks", "serving.deadline_ticks", type=int),
)


def serving_config(mode: str) -> SpringConfig:
    """SpringConfig for serving: the chosen mode with nearest rounding (SR
    would couple a request's tokens to its batch co-tenants), resolved
    through the RunSpec so there is one place serving numerics are
    decided.  It carries no kernel policy: the port dispatches by device,
    and a session checks its spec's policy against the device."""
    return RunSpec(run="serve", numerics=NumericsSection(mode=mode)).resolve().spring


def static_reference_session(
    arch_id: str,
    *,
    reduced: bool = True,
    batch: int = 4,
    prompt_len: int = 32,
    gen: int = 16,
    mode: str = "dense",
    kernel_impl: str | None = None,
    greedy: bool = True,
    seed: int = 0,
    mesh=None,
    device="cuda",
) -> dict:
    """The pre-engine static path: one fixed batch, prefill once, decode
    ``gen`` steps, throw the cache away (the engine's parity oracle)."""
    spec = serve_spec(arch_id, reduced=reduced, batch=batch,
                      prompt_len=prompt_len, gen=gen, mode=mode,
                      kernel_impl=kernel_impl, greedy=greedy, seed=seed,
                      static=True)
    return ServeSession(spec, device=device, mesh=mesh).run()


def serve_session(
    arch_id: str,
    *,
    reduced: bool = True,
    batch: int = 4,
    prompt_len: int = 32,
    gen: int = 16,
    mode: str = "dense",
    kernel_impl: str | None = None,
    greedy: bool = True,
    seed: int = 0,
    slots: int | None = None,
    queue: int | None = None,
    pages: bool = False,
    page_tokens: int | None = None,
    num_pages: int | None = None,
    overcommit: float | None = None,
    prefix_cache: bool | None = None,
    mesh=None,
    device="cuda",
) -> dict:
    """One-shot engine session: submit ``queue`` synthetic requests
    (default ``batch``) over a pool of ``slots`` slots (default ``batch``)
    and drain.  ``pages=True`` serves on the paged COW pool.  Returns the
    engine summary plus the canonical resolved spec."""
    spec = serve_spec(arch_id, reduced=reduced, batch=batch,
                      prompt_len=prompt_len, gen=gen, mode=mode,
                      kernel_impl=kernel_impl, greedy=greedy, seed=seed,
                      slots=slots, queue=queue, pages=pages,
                      page_tokens=page_tokens, num_pages=num_pages,
                      overcommit=overcommit, prefix_cache=prefix_cache)
    return ServeSession(spec, device=device, mesh=mesh).run()


#: This adapter's historical defaults (the old argparse had --batch
#: default=4), layered *below* file/env/CLI; provenance labels them
#: launcher-default.
CLI_BASE = {"shape": {"batch": 4}}


def build_parser():
    ap = make_parser(__doc__, LEGACY_FLAGS, json_out=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (the CUDA kernels, the default) or "
                         "cpu (their plain versions); not a spec field")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    spec = run_main("serve", args, LEGACY_FLAGS, base=CLI_BASE)
    try:
        session = ServeSession(spec, device=args.device)
    except SpecError as e:
        raise SystemExit(f"error: {e}") from None
    out = session.run()
    if not is_rank0():  # every rank of a mesh serves; rank 0 reports
        return out
    print(f"prefill {out['prefill_s']*1e3:.1f}ms, decode {out['decode_s']*1e3:.1f}ms "
          f"({out['tokens_per_s']:.1f} tok/s), finite={out['finite']}")
    if out.get("engine"):
        lat = [r["latency_s"] for r in out["per_request"]]
        print(f"requests {len(lat)} over {out['slots']} slots: "
              f"occupancy {out['mean_occupancy']:.2f}, "
              f"p50 latency {sorted(lat)[len(lat)//2]*1e3:.0f}ms, "
              f"KV wire {out['kv_mean_wire_bytes']/1e6:.2f}MB/step "
              f"({out['kv_traffic_reduction_vs_fp32']:.2f}x less traffic "
              f"than a dense fp32 pool)")
        la = out["latency"]
        print(f"latency attribution: queue p50 {la['queue_s']['p50']*1e3:.0f}ms, "
              f"ttft p50 {la['ttft_s']['p50']*1e3:.0f}ms, "
              f"token p50/p95/p99 {la['token_s']['p50']*1e3:.1f}/"
              f"{la['token_s']['p95']*1e3:.1f}/{la['token_s']['p99']*1e3:.1f}ms, "
              f"tick utilization {la['tick_utilization']:.2f}")
        el = out.get("elastic") or {}
        if any(el.get(k) for k in ("n_rejected", "n_spills", "n_rescales",
                                   "n_snapshots", "n_restores")):
            print(f"elastic: shed {el['n_rejected']} ({el['rejected']}), "
                  f"spills {el['n_spills']}/{el['n_resumes']} resumed, "
                  f"rescales {el['n_rescales']}, "
                  f"snapshots {el['n_snapshots']}, "
                  f"restores {el['n_restores']}")
        if out.get("paging"):
            p = out["paging"]
            print(f"paging: {p['num_pages']} pages x {p['page_tokens']} tok "
                  f"(x{p['overcommit']:.1f} logical overcommit), "
                  f"peak {p['peak_active']} resident, "
                  f"prefix hits {p['prefix_hits']}, cow {p['cow_copies']}, "
                  f"spills {p['spills']}/{p['resumes']} resumed, "
                  f"peak budget utilization {p['peak_page_utilization']:.2f}")
    if "tensor_parallel" in out:  # rank 0's share of the weights and the pool
        tp = out["tensor_parallel"]
        print(f"tensor parallel: model={tp['model']}, rank 0 holds {tp['param_bytes']} "
              f"parameter bytes" + (f", kv heads {tp['kv_heads']} ({tp['pool_bytes']} pool "
                                    f"bytes)" if tp.get("kv_heads") is not None else "")
              + f", {tp['model_hops']} model hops")
    if "telemetry" in out:
        print(f"telemetry: {out['telemetry']['spans']} spans -> "
              f"{out['telemetry']['trace_path']} (load in Perfetto)")
    if len(out["generated"]):
        print("sample tokens:", [int(t) for t in out["generated"][0][:12]])
    print(f"spec {out['spec_hash']}")
    if args.json:
        payload = {k: v for k, v in out.items() if k != "generated"}
        payload["generated_first"] = ([int(t) for t in out["generated"][0]]
                                      if len(out["generated"]) else [])
        payload["generated"] = [[int(t) for t in row] for row in out["generated"]]
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2, default=float)
    return out


if __name__ == "__main__":
    main()
