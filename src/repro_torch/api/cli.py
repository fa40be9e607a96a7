"""Shared launcher CLI: ``--spec`` + ``--set`` plus legacy-flag shims
(port of ``repro/api/cli.py``).

The launcher builds its parser from :func:`make_parser`: the native
surface is ``--spec run.json`` and repeatable ``--set key=value`` dotted
overrides; each pre-redesign flag is a :class:`LegacyFlag` shim that
resolves to the same RunSpec field with a ``DeprecationWarning`` naming
the ``--set`` spelling.  The port's one extra option, ``--device``,
configures nothing numerical (the plain versions on ``cpu``, the CUDA
kernels on ``cuda``) and is operational.  The CLI-coverage test
(tests/test_torch_runspec.py) fails if the launcher grows an option that
is neither operational nor a declared shim.
"""

import argparse
import dataclasses
import warnings
from typing import Optional, Sequence

from repro_torch.api.spec import RunSpec, SpecError, build_spec, field_paths

#: Options every launcher may carry that do not configure the run
#: (output routing, help, and the port's device).  Everything else must
#: be --spec/--set or a declared LegacyFlag.
OPERATIONAL_OPTIONS = {"--spec", "--set", "--explain", "--json", "--out",
                       "--help", "--device"}

_SKIP = object()  # a LegacyFlag.transform may veto the override


@dataclasses.dataclass(frozen=True)
class LegacyFlag:
    """One deprecated flag spelling and the RunSpec field it shims to."""

    option: str  # e.g. "--stash"
    path: str  # e.g. "memstash.policy"
    kwargs: tuple = ()  # argparse add_argument kwargs (sorted items)
    #: for boolean flags: store this constant when the flag is present
    const: object = None
    #: optional value -> spec-value hook (return _SKIP to drop)
    transform: Optional[callable] = None
    #: argparse dest override: paired flags (--greedy/--sample) share one
    #: dest so "last flag on the command line wins", like the old parsers
    dest_override: Optional[str] = None

    def __post_init__(self):
        if self.path not in field_paths():
            raise ValueError(
                f"LegacyFlag {self.option}: {self.path!r} is not a RunSpec "
                "field — add the field to repro_torch.api.spec first")

    @property
    def dest(self) -> str:
        return self.dest_override or (
            "legacy_" + self.option.lstrip("-").replace("-", "_"))

    def add_to(self, ap: argparse.ArgumentParser) -> None:
        kw = dict(self.kwargs)
        kw.setdefault("help", argparse.SUPPRESS)
        # default=None detects "flag present" for value flags and
        # store_const booleans alike, so absence never overlays the spec
        if self.const is not None:
            ap.add_argument(self.option, dest=self.dest, action="store_const",
                            const=self.const, default=None, **kw)
        else:
            ap.add_argument(self.option, dest=self.dest, default=None, **kw)


def flag(option: str, path: str, *, const: object = None,
         transform: Optional[callable] = None, dest: Optional[str] = None,
         **kwargs) -> LegacyFlag:
    return LegacyFlag(option=option, path=path,
                      kwargs=tuple(sorted(kwargs.items())), const=const,
                      transform=transform, dest_override=dest)


def make_parser(description: str, legacy: Sequence[LegacyFlag],
                json_out: bool = False, out: bool = False,
                ) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=description,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--spec", default=None, metavar="PATH",
                    help="RunSpec file (JSON or TOML); layered as "
                         "defaults -> ArchDef -> file -> SPRING_* env -> CLI")
    ap.add_argument("--set", dest="sets", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="dotted RunSpec override, repeatable "
                         "(e.g. --set numerics.mode=quant_sparse)")
    ap.add_argument("--explain", action="store_true",
                    help="print every resolved field with its provenance "
                         "layer, then exit")
    if json_out:
        ap.add_argument("--json", default=None, metavar="PATH",
                        help="write the run result + canonical resolved "
                             "spec as JSON")
    if out:
        ap.add_argument("--out", default=None, metavar="PATH",
                        help="write the result JSON here")
    for lf in legacy:
        lf.add_to(ap)
    return ap


def legacy_overrides(args: argparse.Namespace,
                     legacy: Sequence[LegacyFlag],
                     warn: bool = True) -> list:
    """Collect (path, value, label) overrides from legacy flags that were
    actually passed, warning with the ``--set`` spelling for each."""
    overrides = []
    seen_dests = set()
    for lf in legacy:
        if lf.dest in seen_dests:  # paired flags sharing one dest
            continue
        value = getattr(args, lf.dest)
        if value is None:
            continue
        seen_dests.add(lf.dest)
        if lf.const is not None and value != lf.const:
            # shared dest: attribute the value to the flag that sets it
            lf = next((g for g in legacy
                       if g.dest == lf.dest and g.const == value), lf)
        if warn:
            shown = str(value).lower() if isinstance(value, bool) else value
            warnings.warn(
                f"{lf.option} is deprecated; use --set {lf.path}={shown}",
                DeprecationWarning, stacklevel=3)
        if lf.transform is not None:
            value = lf.transform(value)
            if value is _SKIP:
                continue
        overrides.append((lf.path, value, f"legacy:{lf.option}"))
    return overrides


def spec_from_args(run: str, args: argparse.Namespace,
                   legacy: Sequence[LegacyFlag] = (),
                   warn: bool = True, base: Optional[dict] = None,
                   base_label: str = "launcher-default") -> RunSpec:
    """base (adapter's historical defaults) -> file -> env -> legacy
    shims -> launcher run mode -> --set."""
    return build_spec(
        run,
        data=base, data_label=base_label,
        spec_file=args.spec,
        overrides=legacy_overrides(args, legacy, warn=warn),
        sets=args.sets,
    )


def run_main(run: str, args: argparse.Namespace,
             legacy: Sequence[LegacyFlag],
             base: Optional[dict] = None) -> RunSpec:
    """Shared main() prologue: build the spec (argparse-style errors on
    bad input) and honor ``--explain``."""
    try:
        spec = spec_from_args(run, args, legacy, base=base)
    except SpecError as e:
        raise SystemExit(f"error: {e}") from None
    if getattr(args, "explain", False):
        print(spec.describe())
        raise SystemExit(0)
    return spec
