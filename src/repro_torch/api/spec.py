"""RunSpec: one declarative, serializable configuration for every
execution mode (train / serve / dryrun) — port of ``repro/api/spec.py``.

Everything a spec *is* matches the reference's, text included: the
sections and their defaults, ``_CHOICES``, the ``shape.mesh`` alias, the
``SPRING_*`` environment layer and ``SPRING_SET``, the layered builder

    defaults -> ArchDef -> spec file (JSON/TOML) -> SPRING_* env -> CLI

with per-field provenance, ``to_json`` / ``spec_hash`` / ``state_hash``
/ ``payload`` / ``describe`` / ``validate`` and the did-you-mean errors.
So one spec file gives the same canonical JSON and the same hashes in
both packages, and a serving snapshot stamped with ``state_hash()`` by
one package's engine restores in the other's.

What differs is :meth:`RunSpec.resolve`: it hands back the port's
objects (``LMConfig``, ``SpringConfig``, ``StepConfig``, ``KernelPolicy``,
``MemstashConfig``) for ``run="serve"`` and ``run="train"``; dryrun specs
build, validate, hash and round-trip, and their ``resolve()`` raises a
:class:`SpecError` (the dry run has no twin).  A field the port cannot
honour raises a :class:`SpecError` naming the field; none is ignored.
``kernels.policy`` (and a train spec's ``sparsity.backward``) is checked
against the device by the sessions (the device is not a spec field).
"""

import dataclasses
import difflib
import hashlib
import json
import os
from typing import Mapping, Optional, Sequence

from repro_torch.core.spring_ops import MODES
from repro_torch.kernels.registry import KernelPolicy
from repro_torch.memstash.config import STASH_POLICIES, MemstashConfig

#: The reference's ``sparsity.backward`` choices (its kernel-backend names
#: included), kept so specs validate alike; the port's training backward
#: knows "none" and "auto" (``core/spring_ops.py``).
BACKWARD_SPARSITY_CHOICES = ("none", "auto", "ref", "jnp", "interpret", "pallas")

RUN_MODES = ("train", "serve", "dryrun")
MESH_KINDS = ("single", "multi", "debug", "debug_multi")
LAYOUTS = ("tp", "fsdp")

#: Compat spellings: the flat pre-mesh path ``shape.mesh=<kind>`` (old
#: JSON artifacts, ``--set shape.mesh=multi``, the dryrun ``--mesh``
#: shim) lands on the nested ``shape.mesh.kind`` leaf.  Aliases are
#: resolved in ``_Builder.set`` so every layer (file/env/CLI/kwargs)
#: gets them for free.
_ALIASES = {"shape.mesh": "shape.mesh.kind"}

#: Environment layer: SPRING_<NAME> -> dotted RunSpec field.  Applied
#: between the spec file and CLI overrides.  ``SPRING_SET`` additionally
#: accepts ';'-separated ``key=value`` dotted overrides.
ENV_FIELDS = {
    "SPRING_ARCH": "arch.id",
    "SPRING_MODE": "numerics.mode",
    "SPRING_KERNEL_IMPL": "kernels.policy",
    "SPRING_BACKWARD_SPARSITY": "sparsity.backward",
    "SPRING_STASH": "memstash.policy",
    "SPRING_SEED": "seeds.seed",
}
#: ``SPRING_SET="k=v;k=v"`` dotted overrides.  Entries are separated by
#: ";" (not ","), so comma-bearing values — the KernelPolicy grammar
#: ``kernels.policy=ref,ssd_scan=jnp`` — stay representable.
ENV_SET = "SPRING_SET"

class SpecError(ValueError):
    """A RunSpec could not be built or validated."""


# ---------------------------------------------------------------------------
# Sections.  Every field is JSON-primitive so the spec serializes without
# custom encoders; "auto" marks arch/mode-conditional resolution.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ArchSection:
    """Which architecture, at which size, with arch-config overrides."""

    id: str = "llama3.2-1b"
    # None = run-conditional default, resolved like memstash "auto":
    # train/serve use the reduced smoke config, dryrun analyzes the
    # published full config (its whole point).
    reduced: Optional[bool] = None
    remat_policy: str = ""  # "" = arch default; full | block_io | stash
    bf16_logits: bool = False


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Device-mesh topology (spring-mesh, DESIGN.md §14).

    Explicit axis extents take precedence: when ``pod*data*model > 1``,
    sessions build a ``("pod", "data", "model")`` mesh of exactly that
    shape from the available devices.  Otherwise ``kind`` picks one of
    the named launch meshes (``single`` = no mesh).  ``data`` must be a
    power of two when > 1: the packed-collective bit-exactness guarantee
    (tree-reduce of replicated gradients, then exact /2^k rescale) only
    holds for power-of-two world sizes.
    """

    kind: str = "single"  # named mesh when no explicit axes are set
    pod: int = 1
    data: int = 1
    model: int = 1

    @property
    def explicit(self) -> bool:
        return self.pod * self.data * self.model > 1

    def label(self) -> str:
        """Flat string for run artifacts (roofline rows key on it)."""
        if self.explicit:
            return f"pod{self.pod}.data{self.data}.model{self.model}"
        return self.kind


@dataclasses.dataclass(frozen=True)
class ShapeSection:
    """Problem shape: train batch/seq, serve prompt/gen, dryrun cell/mesh."""

    batch: int = 8
    seq: int = 128
    prompt_len: int = 32
    gen: int = 16
    cell: str = "train_4k"  # dryrun shape-cell name (configs.SHAPES)
    mesh: MeshSpec = MeshSpec()  # device topology (kind or explicit axes)
    microbatch: Optional[int] = None  # None = per-arch dryrun default
    layout: str = "tp"
    seq_parallel: bool = False


@dataclasses.dataclass(frozen=True)
class NumericsSection:
    """SPRING numerics: mode, rounding, fixed-point master weights."""

    mode: str = "dense"  # dense | quant | quant_sparse
    stochastic: str = "auto"  # auto (train: SR, serve: nearest) | on | off
    operand_rounding: str = "stochastic"  # stochastic | nearest
    weights_pre_quantized: bool = False
    fixed_point_weights: bool = False  # SR Q4.16 master weights


@dataclasses.dataclass(frozen=True)
class SparsitySection:
    """Backward-direction sparsity (the forward mask is numerics.mode)."""

    backward: str = "auto"  # none | auto | ref | jnp | interpret | pallas
    probe_density: float = 0.5  # dryrun sparsity/kv probe density


@dataclasses.dataclass(frozen=True)
class MemstashSection:
    """Compressed activation stash policy (DESIGN.md §4.3)."""

    policy: str = "auto"  # auto (family default) | none | remat | stash
    value_bits: int = 20
    capacity: float = 1.0
    min_elems: int = 1024


@dataclasses.dataclass(frozen=True)
class KernelsSection:
    """Kernel-dispatch policy string (KernelPolicy.parse grammar)."""

    policy: str = "auto"  # e.g. "ref" | "ssd_scan=jnp" | "ref,ssd_scan=jnp"


@dataclasses.dataclass(frozen=True)
class OptimizerSection:
    """Train/dryrun optimizer (serving uses no optimizer)."""

    kind: str = "adamw"  # adamw | sgdm
    lr: float = 3e-3
    warmup_steps: int = 10


@dataclasses.dataclass(frozen=True)
class TrainSection:
    """Training-session driver knobs."""

    steps: int = 100
    ckpt_dir: str = ""  # "" = no checkpointing
    ckpt_every: int = 100
    log_every: int = 10


@dataclasses.dataclass(frozen=True)
class ServingSection:
    """Continuous-batching engine shape + scheduler."""

    slots: Optional[int] = None  # None = shape.batch
    queue: Optional[int] = None  # None = shape.batch
    greedy: bool = True
    static: bool = False  # force the pre-engine static reference path
    int8_cache: bool = False
    # spring-pages (DESIGN.md §12): paged COW KV pool
    pages: bool = False  # serve on the paged pool instead of slot-monolithic
    page_tokens: int = 8  # cache rows per page frame
    num_pages: Optional[int] = None  # physical page budget; None = dense-equiv
    overcommit: float = 1.5  # logical frames / physical pages
    prefix_cache: bool = True  # chain-hash prefix sharing (COW)
    # spring-survive (DESIGN.md §13): elastic serving under failure/overload
    snapshot_every: int = 0  # save an engine snapshot every N ticks (0 = off)
    snapshot_path: str = ""  # "" = spring_snapshot.npz when snapshots are on
    restore_path: str = ""  # restore + drain a saved snapshot, skip new work
    max_queue_depth: Optional[int] = None  # shed "queue_full" past this depth
    deadline_ticks: Optional[int] = None  # shed "deadline" if queued longer
    deadline_aware: bool = False  # EDF admission instead of strict FCFS
    priority_aware: bool = False  # admit higher Request.priority first


@dataclasses.dataclass(frozen=True)
class DryrunSection:
    """Dry-run analysis options."""

    cost_unrolled: bool = True
    quant_opt: bool = False  # pre-quantized weights + nearest operands
    variant: str = "baseline"


@dataclasses.dataclass(frozen=True)
class SeedsSection:
    """One master seed: params, data stream, request keys derive from it."""

    seed: int = 0


@dataclasses.dataclass(frozen=True)
class TelemetrySection:
    """spring-trace: span tracing + metrics export (DESIGN.md §11).

    Off by default — the disabled path is a no-op and runs carry no
    telemetry payload.  Enabling must never change computed values, only
    add measurement (sealed by the parity test in test_telemetry.py).
    """

    enabled: bool = False
    #: Chrome trace-event JSON output ("" = derive from train.out_dir /
    #: the --json artifact stem; load in Perfetto / chrome://tracing)
    trace_path: str = ""
    #: fraction of root spans recorded, deterministic accumulator (no
    #: PRNG); nested spans inherit the root's decision
    sample_rate: float = 1.0


_SECTIONS = {
    "arch": ArchSection,
    "shape": ShapeSection,
    "numerics": NumericsSection,
    "sparsity": SparsitySection,
    "memstash": MemstashSection,
    "kernels": KernelsSection,
    "optimizer": OptimizerSection,
    "train": TrainSection,
    "serving": ServingSection,
    "dryrun": DryrunSection,
    "seeds": SeedsSection,
    "telemetry": TelemetrySection,
}

_CHOICES = {
    "run": RUN_MODES,
    "numerics.mode": tuple(MODES),
    "numerics.stochastic": ("auto", "on", "off"),
    "numerics.operand_rounding": ("stochastic", "nearest"),
    "sparsity.backward": BACKWARD_SPARSITY_CHOICES,
    "memstash.policy": ("auto",) + STASH_POLICIES,
    "arch.remat_policy": ("", "full", "block_io", "stash"),
    "shape.mesh.kind": MESH_KINDS,
    "shape.layout": LAYOUTS,
    "optimizer.kind": ("adamw", "sgdm"),
}


def field_paths() -> dict:
    """{dotted path: python type} for every RunSpec field.  Nested
    dataclass fields (``shape.mesh``) contribute their leaves plus the
    compat alias path (typed ``str``) so legacy flat spellings keep
    validating."""
    idx = {"run": str}
    for sec, cls in _SECTIONS.items():
        for f in dataclasses.fields(cls):
            if dataclasses.is_dataclass(f.type):
                for sf in dataclasses.fields(f.type):
                    idx[f"{sec}.{f.name}.{sf.name}"] = sf.type
            else:
                idx[f"{sec}.{f.name}"] = f.type
    for alias in _ALIASES:
        idx[alias] = str
    return idx


_FIELDS = None


def _fields() -> dict:
    global _FIELDS
    if _FIELDS is None:
        _FIELDS = field_paths()
    return _FIELDS


def _suggest(key: str, candidates) -> str:
    close = difflib.get_close_matches(str(key), [str(c) for c in candidates],
                                      n=3, cutoff=0.4)
    return f" — did you mean {', '.join(repr(m) for m in close)}?" if close else ""


def _coerce_str(path: str, raw: str):
    """Coerce a CLI/env string to the field's declared type."""
    typ = _fields()[path]
    s = raw.strip()
    low = s.lower()
    if typ in (Optional[int], Optional[bool]):
        if low in ("none", "null", ""):
            return None
        typ = int if typ == Optional[int] else bool
    if typ is bool:
        if low in ("true", "1", "yes", "on"):
            return True
        if low in ("false", "0", "no", "off"):
            return False
        raise SpecError(f"{path}: expected a boolean, got {raw!r}")
    try:
        if typ is int:
            return int(s)
        if typ is float:
            return float(s)
    except ValueError as e:
        raise SpecError(f"{path}: {e}") from None
    return s


def _check_typed(path: str, value):
    """Validate/normalize an already-typed value (JSON layer, kwargs)."""
    typ = _fields()[path]
    if typ in (Optional[int], Optional[bool]):
        if value is None:
            return None
        typ = int if typ == Optional[int] else bool
    if typ is bool:
        if not isinstance(value, bool):
            raise SpecError(f"{path}: expected a boolean, got {value!r}")
        return value
    if typ is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise SpecError(f"{path}: expected an integer, got {value!r}")
        return value
    if typ is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise SpecError(f"{path}: expected a number, got {value!r}")
        return float(value)
    if not isinstance(value, str):
        raise SpecError(f"{path}: expected a string, got {value!r}")
    return value


# ---------------------------------------------------------------------------
# RunSpec.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """The one declarative run configuration.  Frozen; equality ignores
    ``provenance`` (metadata about *where* each field came from, recorded
    by the layered builder and rendered into run artifacts)."""

    run: str = "train"
    arch: ArchSection = ArchSection()
    shape: ShapeSection = ShapeSection()
    numerics: NumericsSection = NumericsSection()
    sparsity: SparsitySection = SparsitySection()
    memstash: MemstashSection = MemstashSection()
    kernels: KernelsSection = KernelsSection()
    optimizer: OptimizerSection = OptimizerSection()
    train: TrainSection = TrainSection()
    serving: ServingSection = ServingSection()
    dryrun: DryrunSection = DryrunSection()
    seeds: SeedsSection = SeedsSection()
    telemetry: TelemetrySection = TelemetrySection()
    provenance: Mapping[str, str] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    # -- serialization ------------------------------------------------------

    def to_dict(self) -> dict:
        d = {"run": self.run}
        for name in _SECTIONS:
            d[name] = dataclasses.asdict(getattr(self, name))
        return d

    def to_json(self, indent: Optional[int] = 2) -> str:
        """Canonical JSON: sorted keys, stable across dict ordering."""
        return json.dumps(self.to_dict(), sort_keys=True, indent=indent) + "\n"

    def spec_hash(self) -> str:
        """Hash of the canonical compact JSON (ties artifacts to configs)."""
        compact = json.dumps(self.to_dict(), sort_keys=True,
                             separators=(",", ":"))
        return hashlib.sha256(compact.encode()).hexdigest()[:16]

    def state_hash(self) -> str:
        """``spec_hash`` with the restart-operational serving fields
        (snapshot cadence/paths) *and* the mesh topology neutralized —
        the stamp embedded in serving snapshots (DESIGN.md §13).  A run
        that merely *restores* an artifact necessarily differs from the
        run that wrote it in exactly these fields — and a snapshot taken
        on one device count must restore onto another (elastic rescale
        across topologies, DESIGN.md §14) — so they must not poison the
        compatibility check; anything numerics/shape/arch-shaped still
        rejects."""
        d = self.to_dict()
        for field in ("snapshot_every", "snapshot_path", "restore_path"):
            d["serving"][field] = ServingSection.__dataclass_fields__[
                field].default
        d["shape"]["mesh"] = dataclasses.asdict(MeshSpec())
        compact = json.dumps(d, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(compact.encode()).hexdigest()[:16]

    def payload(self) -> dict:
        """The reproducibility block every run artifact embeds."""
        return {
            "spec": self.to_dict(),
            "spec_hash": self.spec_hash(),
            "provenance": dict(self.provenance),
        }

    @classmethod
    def from_dict(cls, data: dict, label: str = "dict") -> "RunSpec":
        return build_spec(data=data, data_label=label, use_env=False)

    @classmethod
    def from_json(cls, text: str, label: str = "json") -> "RunSpec":
        try:
            data = json.loads(text)
        except json.JSONDecodeError as e:
            raise SpecError(f"invalid spec JSON: {e}") from None
        return cls.from_dict(data, label=label)

    @classmethod
    def from_file(cls, path: str) -> "RunSpec":
        return build_spec(spec_file=path, use_env=False)

    def _get(self, path: str):
        """Walk a dotted field path of any depth."""
        obj = self
        for part in path.split("."):
            obj = getattr(obj, part)
        return obj

    def describe(self) -> str:
        """Flat field = value  [provenance] rendering (debug/--explain)."""
        prov = dict(self.provenance)
        lines = []
        for path in sorted(_fields()):
            if path in _ALIASES:  # alias leaves are rendered, not the alias
                continue
            value = self._get(path)
            lines.append(f"{path} = {value!r}  [{prov.get(path, 'default')}]")
        return "\n".join(lines)

    # -- validation ---------------------------------------------------------

    def validate(self) -> "RunSpec":
        for path, choices in _CHOICES.items():
            value = self._get(path)
            if value not in choices:
                raise SpecError(
                    f"{path}: unknown value {value!r}; choose from "
                    f"{choices}{_suggest(str(value), choices)}")
        from repro_torch.configs import SHAPES
        if self.shape.cell not in SHAPES:
            raise SpecError(
                f"shape.cell: unknown shape {self.shape.cell!r}; choose "
                f"from {tuple(SHAPES)}"
                f"{_suggest(self.shape.cell, SHAPES)}")
        if not 0.0 <= self.sparsity.probe_density <= 1.0:
            raise SpecError("sparsity.probe_density must be in [0, 1]")
        for ax in ("pod", "data", "model"):
            if getattr(self.shape.mesh, ax) < 1:
                raise SpecError(f"shape.mesh.{ax} must be >= 1")
        if self.shape.mesh.data > 1 and \
                self.shape.mesh.data & (self.shape.mesh.data - 1):
            raise SpecError(
                "shape.mesh.data must be a power of two: the packed "
                "collective bit-exactness seal (pairwise tree-reduce + "
                "exact /2^k rescale) only holds for power-of-two worlds")
        if not 0.0 < self.telemetry.sample_rate <= 1.0:
            raise SpecError("telemetry.sample_rate must be in (0, 1]")
        if self.serving.page_tokens < 1:
            raise SpecError("serving.page_tokens must be >= 1")
        if self.serving.overcommit < 1.0:
            raise SpecError("serving.overcommit must be >= 1.0")
        if self.serving.num_pages is not None and self.serving.num_pages < 1:
            raise SpecError("serving.num_pages must be >= 1 (or null)")
        if self.serving.snapshot_every < 0:
            raise SpecError("serving.snapshot_every must be >= 0")
        if (self.serving.max_queue_depth is not None
                and self.serving.max_queue_depth < 1):
            raise SpecError("serving.max_queue_depth must be >= 1 (or null)")
        if (self.serving.deadline_ticks is not None
                and self.serving.deadline_ticks < 0):
            raise SpecError("serving.deadline_ticks must be >= 0 (or null)")
        if self.serving.restore_path and self.serving.snapshot_every:
            # one engine either resumes an artifact or produces them; both
            # at once would overwrite the artifact being drained
            if (self.serving.snapshot_path or "spring_snapshot.npz") == \
                    self.serving.restore_path:
                raise SpecError(
                    "serving.restore_path equals the snapshot output path; "
                    "set serving.snapshot_path to a different file")
        try:
            KernelPolicy.parse(self._kernel_spec())
        except ValueError as e:
            raise SpecError(f"kernels.policy: {e}") from None
        try:
            MemstashConfig(
                policy="none" if self.memstash.policy == "auto"
                else self.memstash.policy,
                value_bits=self.memstash.value_bits,
                capacity=self.memstash.capacity,
                min_elems=self.memstash.min_elems)
        except ValueError as e:
            raise SpecError(f"memstash: {e}") from None
        return self

    # -- resolution ---------------------------------------------------------

    def _kernel_spec(self) -> str:
        return "" if self.kernels.policy in ("", "auto") else self.kernels.policy

    def resolved_memstash_policy(self, family: str) -> str:
        """The ArchDef layer: ``"auto"`` dispatches on the workload family
        through :func:`repro_torch.configs.default_memstash` — the single
        source of truth for the per-family recommendation."""
        if self.memstash.policy != "auto":
            return self.memstash.policy
        from repro_torch.configs import default_memstash

        return default_memstash(family).policy

    def resolve(self) -> "ResolvedRun":
        """The port's config objects for a ``run="serve"`` or ``run="train"``
        spec.  Raises :class:`SpecError` for a dryrun spec (it has no twin),
        an unknown arch, and each field it cannot honour (:meth:`unsupported`)."""
        self.validate()
        if self.run == "dryrun":
            raise SpecError(_DRYRUN_NOT_PORTED)
        from repro_torch.configs import get_arch

        try:
            arch = get_arch(self.arch.id)
        except KeyError as e:
            raise SpecError(str(e)) from None
        problems = self.unsupported()
        if problems:
            raise SpecError("; ".join(problems))
        # reduced=None: train and serve run the reduced smoke config, as in
        # the reference (full width is arch.reduced=false)
        use_reduced = True if self.arch.reduced is None else self.arch.reduced
        cfg = dataclasses.replace(arch.reduced() if use_reduced else arch.config)
        if self.arch.remat_policy and hasattr(cfg, "remat_policy"):
            cfg = dataclasses.replace(cfg, remat_policy=self.arch.remat_policy)
        if self.arch.bf16_logits and hasattr(cfg, "bf16_logits"):
            cfg = dataclasses.replace(cfg, bf16_logits=True)
        ms_policy = self.resolved_memstash_policy(arch.family)
        memstash = MemstashConfig(
            policy=ms_policy, value_bits=self.memstash.value_bits,
            capacity=self.memstash.capacity, min_elems=self.memstash.min_elems)
        # an explicitly requested stash / remat policy re-routes the LM
        # residual checkpoints (train_loop's --stash); the family's "auto"
        # only configures the stash points the model already has
        if self.run == "train" and self.memstash.policy != "auto":
            if ms_policy == "stash":
                cfg = dataclasses.replace(cfg, remat_policy="stash")
            elif ms_policy == "remat":  # plain recompute even where the
                # reduced variant turned remat off
                cfg = dataclasses.replace(cfg, remat=True, remat_policy="full")
        kernel_policy = KernelPolicy.parse(self._kernel_spec())
        step = None
        if self.run == "serve":
            # serving: nearest rounding keeps a request's tokens a function
            # of the request alone ("on" is refused by unsupported())
            spring = dataclasses.replace(MODES[self.numerics.mode], stochastic=False)
        else:
            from repro_torch.core.fixedpoint import SPRING_FORMAT
            from repro_torch.optim.optimizers import OptimizerConfig
            from repro_torch.runtime.train import StepConfig

            spring = dataclasses.replace(MODES[self.numerics.mode],
                                         stochastic=self.numerics.stochastic != "off")
            if spring.is_quantized:
                spring = dataclasses.replace(
                    spring, weights_pre_quantized=self.numerics.weights_pre_quantized,
                    operand_rounding=self.numerics.operand_rounding)
            step = StepConfig(
                spring=spring, backward_sparsity=self.sparsity.backward,
                memstash=memstash, microbatch=self.shape.microbatch,
                optimizer=OptimizerConfig(
                    kind=self.optimizer.kind, lr=self.optimizer.lr,
                    warmup_steps=self.optimizer.warmup_steps,
                    weight_format=SPRING_FORMAT if self.numerics.fixed_point_weights
                    else None),
                attention="flash" if flash_pinned(kernel_policy) else "chunked")
        return ResolvedRun(
            spec=self, arch=arch, config=cfg, spring=spring,
            kernel_policy=kernel_policy, memstash=memstash,
            memstash_policy=ms_policy, view=arch.view(config=cfg), step=step)

    def unsupported(self) -> list:
        """One message per field of this serve or train spec that the port
        cannot honour, each naming the field."""
        out = []
        if self.run == "train":
            return out + self._train_unsupported()
        if self.numerics.weights_pre_quantized:
            out.append(
                "numerics.weights_pre_quantized=true is not honoured by the "
                "port yet: its quantized path rounds the weights at every "
                "call (ROADMAP §2 speed item 1)")
        if self.numerics.stochastic == "on" and self.numerics.mode != "dense":
            out.append(
                "numerics.stochastic='on': the port serves with nearest "
                "rounding only (stochastic rounding is a training device)")
        from repro_torch.configs import get_arch

        arch = get_arch(self.arch.id)
        if self.serving.int8_cache and not (self.serving.static or arch.is_encdec):
            out.append(
                "serving.int8_cache=true is served on the static path only "
                "(serving.static=true): the reference's engine cannot serve it (its pool "
                "is built from bf16 k/v leaves and the int8 prefill cache has none, "
                "KeyError 'k'; ROADMAP §3)")
        if self.serving.pages and arch.is_encdec:
            out.append(
                f"serving.pages=true: arch.id {self.arch.id!r} is an encoder-decoder, which "
                "the engine does not serve (the reference's engine asserts not is_encdec, "
                "serving/engine.py:102): it runs the static path")
        elif self.serving.pages and not any(
                kind[0] in ("attn", "mla") for _, _, kind in arch.config.layer_plan):
            out.append(
                f"serving.pages=true: arch.id {self.arch.id!r} has no pageable cache leaf "
                "(its window rings and recurrent state stay slot state), so it cannot be "
                "served paged, as in the reference (paging/store.py:141)")
        return out

    def _train_unsupported(self) -> list:
        from repro_torch.configs import get_arch

        out = []
        arch = get_arch(self.arch.id)
        if arch.is_encdec or arch.config.vlm_prefix_len:
            fault = ("KeyError 'frames': its _loss_for reads batch['frames'] "
                     "(src/repro/runtime/train.py:118)" if arch.is_encdec else
                     "AssertionError: its lm_hidden asserts img_embeds is not None "
                     "(src/repro/models/lm.py:239)")
            out.append(
                f"arch.id: {self.arch.id!r} ({arch.family}) is not trained by the session: "
                "the reference's TrainSession feeds its train step the tokens alone "
                f"(src/repro/api/sessions.py:148) and fails on it with {fault}; "
                "make_train_step trains it given "
                f"{'frames' if arch.is_encdec else 'img_embeds'} (ROADMAP §3)")
        if self.shape.microbatch is not None and (
                self.shape.microbatch < 1 or self.shape.batch % self.shape.microbatch):
            out.append(
                f"shape.microbatch={self.shape.microbatch} does not split "
                f"shape.batch={self.shape.batch} into equal parts")
        return out


#: the reference's registered implementations of flash_attention: a global
#: policy default among them pins the op (``SpringContext.kernel_pinned``)
FLASH_IMPLS = ("ref", "interpret", "pallas")


def flash_pinned(policy: KernelPolicy) -> bool:
    """True when ``policy`` pins flash_attention, so that the full-sequence
    attention of a train step takes the flash route, as the reference's
    ``gqa_apply`` does (``attention.py:163-176``): a per-op pin always, a
    global default only where the op registers that implementation."""
    name = policy.impl_for("flash_attention")
    if name == "auto":
        return False
    return "flash_attention" in dict(policy.overrides) or name in FLASH_IMPLS


#: resolve()'s refusal of the dry run
_DRYRUN_NOT_PORTED = ("run='dryrun' has no twin in the port: the dry run lowers "
                      "XLA programs (ROADMAP §1 item 5)")


@dataclasses.dataclass(frozen=True)
class ResolvedRun:
    """What ``RunSpec.resolve()`` hands the sessions: the port's objects
    for the reference's ``view`` / ``config`` / ``spring`` / ``step`` /
    ``kernel_policy`` / ``memstash`` (``step`` is None when serving, which
    builds no optimizer)."""

    spec: RunSpec
    arch: object  # configs.base.ArchDef
    config: object  # the LMConfig picked (full or reduced)
    spring: object  # SpringConfig
    kernel_policy: KernelPolicy
    memstash: MemstashConfig
    memstash_policy: str  # family-dispatched policy actually in force
    view: object = None  # configs.base.ResolvedArch of ``config``
    step: object = None  # runtime.train.StepConfig (train)


# ---------------------------------------------------------------------------
# Layered builder.
# ---------------------------------------------------------------------------


class _Builder:
    def __init__(self):
        self._values: dict = {}
        self._prov: dict = {}

    def set(self, path: str, value, label: str, from_str: bool = False):
        path = _ALIASES.get(path, path)
        if path not in _fields():
            raise SpecError(
                f"unknown RunSpec field {path!r} (from {label})"
                f"{_suggest(path, _fields())}")
        self._values[path] = (_coerce_str(path, value) if from_str
                              else _check_typed(path, value))
        self._prov[path] = label

    def overlay_nested(self, data: dict, label: str):
        if not isinstance(data, dict):
            raise SpecError(f"spec root must be an object (from {label})")
        for key, value in data.items():
            if key == "run":
                self.set("run", value, label)
                continue
            if key not in _SECTIONS:
                raise SpecError(
                    f"unknown RunSpec section {key!r} (from {label})"
                    f"{_suggest(key, list(_SECTIONS) + ['run'])}")
            if not isinstance(value, dict):
                raise SpecError(
                    f"section {key!r} must be an object (from {label})")
            for leaf, v in value.items():
                if isinstance(v, dict):  # nested subsection (shape.mesh)
                    for subleaf, sv in v.items():
                        self.set(f"{key}.{leaf}.{subleaf}", sv, label)
                else:
                    self.set(f"{key}.{leaf}", v, label)

    def overlay_env(self, environ: Mapping[str, str]):
        for var, path in ENV_FIELDS.items():
            if var in environ and environ[var] != "":
                self.set(path, environ[var], f"env:{var}", from_str=True)
        for token in (t for t in environ.get(ENV_SET, "").split(";") if t.strip()):
            path, eq, value = token.partition("=")
            if not eq:
                raise SpecError(
                    f"{ENV_SET} entries must be ';'-separated key=value "
                    f"pairs, got {token!r}")
            self.set(path.strip(), value, f"env:{ENV_SET}", from_str=True)

    def overlay_sets(self, sets: Sequence[str], label: str = "set"):
        for item in sets:
            path, eq, value = item.partition("=")
            if not eq:
                raise SpecError(f"--set expects key=value, got {item!r}")
            self.set(path.strip(), value, f"{label}:{path.strip()}",
                     from_str=True)

    def build(self) -> RunSpec:
        sections = {}
        for name, cls in _SECTIONS.items():
            kw = {}
            for f in dataclasses.fields(cls):
                path = f"{name}.{f.name}"
                if dataclasses.is_dataclass(f.type):
                    sub = {sf.name: self._values[f"{path}.{sf.name}"]
                           for sf in dataclasses.fields(f.type)
                           if f"{path}.{sf.name}" in self._values}
                    if sub:
                        kw[f.name] = f.type(**sub)
                elif path in self._values:
                    kw[f.name] = self._values[path]
            try:
                sections[name] = cls(**kw)
            except ValueError as e:
                raise SpecError(f"{name}: {e}") from None
        prov = {p: "default" for p in _fields()}
        prov.update(self._prov)
        spec = RunSpec(run=self._values.get("run", "train"),
                       provenance=prov, **sections)
        return spec.validate()


def load_spec_data(path: str) -> dict:
    """Read a spec file; format from extension (.json, .toml)."""
    if path.endswith(".toml"):
        try:
            import tomllib  # py3.11+
        except ModuleNotFoundError:
            try:
                import tomli as tomllib  # type: ignore[no-redef]
            except ModuleNotFoundError:
                raise SpecError(
                    f"cannot read {path}: TOML support needs python >= 3.11 "
                    "(tomllib) or the 'tomli' package; use JSON instead"
                ) from None
        with open(path, "rb") as f:
            try:
                return tomllib.load(f)
            except tomllib.TOMLDecodeError as e:
                raise SpecError(f"invalid TOML in {path}: {e}") from None
    with open(path) as f:
        try:
            return json.load(f)
        except json.JSONDecodeError as e:
            raise SpecError(f"invalid JSON in {path}: {e}") from None


def build_spec(
    run: Optional[str] = None,
    *,
    spec_file: Optional[str] = None,
    data: Optional[dict] = None,
    data_label: str = "data",
    overrides: Sequence[tuple] = (),  # (path, typed value, label)
    sets: Sequence[str] = (),  # "key=value" strings (CLI --set)
    use_env: bool = True,
    environ: Optional[Mapping[str, str]] = None,
) -> RunSpec:
    """Assemble a RunSpec through the documented layer order:

      defaults -> data (caller base layer, e.g. an example preset)
               -> [ArchDef at resolve()] -> spec file -> SPRING_* env
               -> overrides (legacy flags / call kwargs) -> launcher run
               -> --set

    ``overrides`` carry their own labels (``legacy:--stash``,
    ``call:stash``) so provenance distinguishes shimmed spellings from
    native ones.
    """
    b = _Builder()
    if data is not None:
        b.overlay_nested(data, data_label)
    if spec_file is not None:
        b.overlay_nested(load_spec_data(spec_file), f"file:{spec_file}")
    if use_env:
        b.overlay_env(os.environ if environ is None else environ)
    for path, value, label in overrides:
        b.set(path, value, label)
    if run is not None:
        b.set("run", run, "launcher")
    b.overlay_sets(sets)
    return b.build()
