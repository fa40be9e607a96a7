"""The reference's partitioned runs for ``test_torch_tensor_parallel.py``,
run as its own process (``python tests/_torch_tp_reference.py``) with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``: jax takes the
device count once, at its first import, so the test process cannot.

The reference's sessions build Explicit-typed mesh axes, and under jax
0.9 its ``with_sharding_constraint`` refuses them
(``src/repro/runtime/sharding.py:154``, a reference-side condition); the
sessions' own ``mesh=`` argument takes the Auto-typed ``(1, 1, m)`` mesh
made here instead, so GSPMD partitions the annotated layers over
``model``.  Prints one JSON object: the losses of ``TRAIN_SETS`` (quant_sparse
and dense) and the static tokens of ``SERVE_SETS`` (dense and quant) at
model 1 (no mesh), 2 and 4.
"""

from __future__ import annotations

import json
import os
import sys

EXTENTS = (1, 2, 4)
TRAIN_MODES = ("quant_sparse", "dense")


def main() -> None:
    if "--xla_force_host_platform_device_count=4" not in os.environ.get("XLA_FLAGS", ""):
        raise SystemExit("run with XLA_FLAGS=--xla_force_host_platform_device_count=4")
    sys.path.insert(0, os.path.dirname(__file__))
    import jax
    import numpy as np
    from jax.sharding import AxisType

    import _torch_mesh_ranks as R
    from repro.api.sessions import ServeSession, TrainSession
    from repro.api.spec import build_spec

    out: dict = {"train": {}, "serve": {}}
    for m in EXTENTS:
        mesh = (None if m == 1 else jax.make_mesh((1, 1, m), ("pod", "data", "model"),
                                                   axis_types=(AxisType.Auto,) * 3))
        extra = [] if m == 1 else [f"shape.mesh.model={m}"]
        out["train"][m] = {
            mode: [float(v) for v in TrainSession(build_spec(
                "train", sets=R.TRAIN_SETS + extra + [f"numerics.mode={mode}"],
                use_env=False), mesh=mesh).run()["losses"]]
            for mode in TRAIN_MODES}
        out["serve"][m] = {
            mode: np.asarray(ServeSession(build_spec(
                "serve", sets=R.SERVE_SETS + extra + [f"numerics.mode={mode}"],
                use_env=False), mesh=mesh).run()["generated"]).tolist()
            for mode in R.SERVE_MODES}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
