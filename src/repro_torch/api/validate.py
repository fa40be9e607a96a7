"""Spec validation CLI (port of ``repro/api/validate.py``).

  # validate checked-in spec files (serve and train specs also resolve)
  PYTHONPATH=src python -m repro_torch.api.validate examples/specs/*.json

  # round-trip seal: every ported arch x {train, serve, dryrun}
  PYTHONPATH=src python -m repro_torch.api.validate --roundtrip-all

Each spec is built, round-tripped through its canonical JSON and hashed,
as in the reference.  Serve and train specs resolve in the port; a
dryrun file is reported ``ok`` with its hash (the dry run has no twin).  ``--lower-all``
lowers XLA programs in the reference and has no twin here: it exits
non-zero.

Exit code 0 only if everything passes.
"""

import argparse
import sys

from repro_torch.api.spec import RunSpec, SpecError, build_spec


def _resolve_note(spec: RunSpec) -> str:
    """Resolve a serve or train spec; the dry run has no twin."""
    if spec.run in ("serve", "train"):
        return f"memstash->{spec.resolve().memstash_policy}"
    return "run=dryrun has no twin (it lowers XLA programs)"


def validate_files(paths) -> int:
    failures = 0
    for path in paths:
        try:
            spec = RunSpec.from_file(path)
            note = _resolve_note(spec)
            roundtrip = RunSpec.from_json(spec.to_json())
            assert roundtrip == spec, "round trip changed the spec"
            assert roundtrip.spec_hash() == spec.spec_hash()
            print(f"ok {path}: run={spec.run} arch={spec.arch.id} "
                  f"hash={spec.spec_hash()} ({note})")
        except (SpecError, OSError, AssertionError) as e:
            failures += 1
            print(f"FAIL {path}: {e}", file=sys.stderr)
    return failures


def roundtrip_all() -> int:
    from repro_torch.configs import ARCHS

    failures = 0
    for arch_id in sorted(ARCHS):
        for run in ("train", "serve", "dryrun"):
            try:
                spec = build_spec(run, use_env=False, overrides=[
                    ("arch.id", arch_id, "sweep")])
                again = RunSpec.from_json(spec.to_json())
                assert again == spec
                if run == "serve":
                    r1, r2 = spec.resolve(), again.resolve()
                    assert (r1.spring, r1.config, r1.memstash, r1.kernel_policy) == \
                           (r2.spring, r2.config, r2.memstash, r2.kernel_policy), \
                        "resolve() diverged after round trip"
                print(f"ok {arch_id} x {run}: {spec.spec_hash()}")
            except (SpecError, AssertionError) as e:
                failures += 1
                print(f"FAIL {arch_id} x {run}: {e}", file=sys.stderr)
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("specs", nargs="*", help="spec files to validate")
    ap.add_argument("--roundtrip-all", action="store_true",
                    help="round-trip every ported arch x run mode (serve resolves)")
    ap.add_argument("--lower-all", action="store_true",
                    help="the reference's XLA lowering sweep: no twin in the port")
    args = ap.parse_args(argv)
    failures = 0
    if args.specs:
        failures += validate_files(args.specs)
    if args.roundtrip_all:
        failures += roundtrip_all()
    if args.lower_all:
        failures += 1
        print("FAIL --lower-all: no twin in the port (it lowers XLA programs; "
              "ROADMAP §1 item 5)", file=sys.stderr)
    if not (args.specs or args.roundtrip_all or args.lower_all):
        ap.error("nothing to do: pass spec files, --roundtrip-all, "
                 "or --lower-all")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
