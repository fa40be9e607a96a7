"""Render telemetry artifacts: human tables + Prometheus exposition (a copy
of ``repro/telemetry/report.py``).

Consumes the ``telemetry`` block embedded in run artifacts (the output of
``python -m repro_torch.launch.serve --set telemetry.enabled=true --json
run.json``) or a raw
``MetricsRegistry.snapshot()`` JSON, and validates exported Chrome
traces.

  PYTHONPATH=src python -m repro_torch.telemetry.report results/serving/run.json
  PYTHONPATH=src python -m repro_torch.telemetry.report run.json --prom
  PYTHONPATH=src python -m repro_torch.telemetry.report --validate-trace trace.json
"""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.telemetry.metrics import (
    prometheus_from_snapshot,
    render_snapshot_table,
)
from repro_torch.telemetry.spans import validate_chrome_trace


def extract_snapshot(artifact: dict) -> dict:
    """Metrics snapshot from a run artifact or a bare snapshot dump.

    Accepts: ``{"telemetry": {"metrics": {...}}}`` (session artifacts),
    ``{"metrics": {...}}``, or a raw ``snapshot()`` mapping.
    """
    if "telemetry" in artifact and isinstance(artifact["telemetry"], dict):
        inner = artifact["telemetry"]
        if "metrics" in inner:
            return inner["metrics"]
        return inner
    if "metrics" in artifact and isinstance(artifact["metrics"], dict):
        return artifact["metrics"]
    # bare snapshot: every value is a {"kind", "cells"} family
    if all(isinstance(v, dict) and "kind" in v and "cells" in v
           for v in artifact.values()):
        return artifact
    raise SystemExit(
        "error: no telemetry block found — run with "
        "--set telemetry.enabled=true to record one")


def latency_lines(artifact: dict) -> list[str]:
    """Per-request latency attribution lines from a serve artifact."""
    reqs = artifact.get("per_request")
    if not reqs or not isinstance(reqs, list):
        return []
    out = ["rid  queue_ms  ttft_ms  total_ms  tokens  ticks(enq->first->fin)"]
    for r in reqs:
        if "ttft_s" not in r:
            return []
        ticks = (f"{r.get('enqueue_tick', -1)}->"
                 f"{r.get('first_token_tick', -1)}->"
                 f"{r.get('finish_tick', -1)}")
        out.append(
            f"{r['rid']:>3}  {r.get('queue_s', 0.0)*1e3:8.1f}  "
            f"{r['ttft_s']*1e3:7.1f}  {r.get('latency_s', 0.0)*1e3:8.1f}  "
            f"{r.get('n_tokens', len(r.get('tokens', []))):>6}  {ticks}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("artifact", nargs="?", default=None,
                    help="run artifact or metrics snapshot JSON")
    ap.add_argument("--prom", action="store_true",
                    help="print the Prometheus text exposition instead of "
                         "the human table")
    ap.add_argument("--validate-trace", default=None, metavar="PATH",
                    help="validate a Chrome trace-event file and print its "
                         "span census, then exit")
    args = ap.parse_args(argv)

    if args.validate_trace:
        with open(args.validate_trace) as f:
            events = validate_chrome_trace(f.read())
        census: dict[str, int] = {}
        for ev in events:
            census[ev["name"]] = census.get(ev["name"], 0) + 1
        print(f"{args.validate_trace}: {len(events)} events OK")
        for name in sorted(census):
            print(f"  {name}: {census[name]}")
        if args.artifact is None:
            return

    if args.artifact is None:
        ap.error("an artifact path (or --validate-trace) is required")
    with open(args.artifact) as f:
        artifact = json.load(f)
    snap = extract_snapshot(artifact)
    if args.prom:
        sys.stdout.write(prometheus_from_snapshot(snap))
        return
    print(render_snapshot_table(snap))
    lat = latency_lines(artifact)
    if lat:
        print("\nper-request latency attribution")
        for line in lat:
            print(f"  {line}")


if __name__ == "__main__":
    main()
