"""The reference's partitioned engine runs for ``test_torch_tp_engine.py``,
run as its own process (``python tests/_torch_tp_engine_reference.py``)
with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``_torch_tp_reference.py`` is: its sessions and engines take the
Auto-typed ``(1, 1, m)`` mesh made here, so GSPMD partitions the
annotated layers and the cache over ``model``.  Prints one JSON object,
at model 1 (no mesh), 2 and 4: the engine session's tokens on
``ENGINE_SETS``, monolithic and paged, and the paged engine's on the
shared prompts (``PARITY``, prefix sharing on: tokens and its paging
summary)."""

from __future__ import annotations

import json
import os
import sys

EXTENTS = (1, 2, 4)


def main() -> None:
    if "--xla_force_host_platform_device_count=4" not in os.environ.get("XLA_FLAGS", ""):
        raise SystemExit("run with XLA_FLAGS=--xla_force_host_platform_device_count=4")
    sys.path.insert(0, os.path.dirname(__file__))
    import jax
    import numpy as np
    from jax.sharding import AxisType

    import _torch_tp_engine_ranks as E
    from repro.api.sessions import ServeSession
    from repro.api.spec import build_spec
    from repro.configs import get_arch
    from repro.launch.serve import serving_config
    from repro.models import lm as jlm
    from repro.optim.optimizers import OptimizerConfig
    from repro.runtime.train import StepConfig
    from repro.serving.paging import PagedServingEngine

    view = get_arch("llama3.2-1b").view(reduced=True)
    params = jlm.lm_init(jax.random.PRNGKey(0), view.config)
    step_cfg = StepConfig(spring=serving_config(E.MODE), optimizer=OptimizerConfig())
    prompts = E.shared_prompts(view.config.vocab)
    out: dict = {"session": {}, "shared": {}}
    for m in EXTENTS:
        mesh = (None if m == 1 else jax.make_mesh((1, 1, m), ("pod", "data", "model"),
                                                   axis_types=(AxisType.Auto,) * 3))
        extra = [] if m == 1 else [f"shape.mesh.model={m}"]
        out["session"][m] = {
            str(paged): np.asarray(ServeSession(build_spec(
                "serve", sets=E.ENGINE_SETS + extra + [f"serving.pages={paged}"],
                use_env=False), mesh=mesh).run()["generated"]).tolist()
            for paged in (False, True)}
        eng = PagedServingEngine(view, step_cfg, params=params, mesh=mesh, **E.PARITY)
        for i, p in enumerate(prompts):
            eng.submit_prompt(p, E.GEN, seed=100 + i)
        run = eng.run()
        out["shared"][m] = {"tokens": [r["tokens"] for r in run["per_request"]],
                            "paging": run["paging"]}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
