"""repro_torch.api — the declarative RunSpec configuration API (port of
``repro.api``).

One frozen, serializable :class:`RunSpec` describes any run (train /
serve / dryrun) with the reference's fields, canonical JSON and hashes;
:class:`ServeSession` executes a serve spec on the port's engines,
:class:`TrainSession` a train spec through the LM train step, and
``build_spec`` implements the layered resolution (defaults -> ArchDef ->
spec file -> SPRING_* env -> CLI) with per-field provenance.
"""

from repro_torch.api.spec import (
    ENV_FIELDS,
    MESH_KINDS,
    RUN_MODES,
    ResolvedRun,
    RunSpec,
    SpecError,
    build_spec,
    field_paths,
    load_spec_data,
)
from repro_torch.api.sessions import (
    DryrunSession,
    ServeSession,
    Session,
    TrainSession,
    dryrun_spec,
    serve_spec,
    session_for,
    train_spec,
)

__all__ = [
    "ENV_FIELDS", "MESH_KINDS", "RUN_MODES", "ResolvedRun", "RunSpec",
    "SpecError", "build_spec", "field_paths", "load_spec_data",
    "DryrunSession", "ServeSession", "Session", "TrainSession",
    "dryrun_spec", "serve_spec", "session_for", "train_spec",
]
