"""The reference's partitioned runs for ``test_torch_expert_parallel.py``,
run as its own process (``python tests/_torch_ep_reference.py``) with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``_torch_tp_reference.py`` is: its sessions take the Auto-typed ``(1, 1,
4)`` mesh made here, so GSPMD partitions the experts, the heads and the
vocabulary over ``model``.  Prints one JSON object: for reduced
olmoe-1b-7b and deepseek-v2-lite-16b at model 4, the training losses, the
static tokens and the engine session's tokens, monolithic and paged
(``_torch_ep_ranks``' sets)."""

from __future__ import annotations

import concurrent.futures
import json
import os
import sys

WORLD = 4


def main() -> None:
    if "--xla_force_host_platform_device_count=4" not in os.environ.get("XLA_FLAGS", ""):
        raise SystemExit("run with XLA_FLAGS=--xla_force_host_platform_device_count=4")
    sys.path.insert(0, os.path.dirname(__file__))
    import jax
    import numpy as np
    from jax.sharding import AxisType

    import _torch_ep_ranks as P
    from repro.api.sessions import ServeSession, TrainSession
    from repro.api.spec import build_spec

    mesh = jax.make_mesh((1, 1, WORLD), ("pod", "data", "model"),
                         axis_types=(AxisType.Auto,) * 3)

    def spec(run, arch, sets):
        return build_spec(run, sets=[f"arch.id={arch}"] + sets
                          + [f"shape.mesh.model={WORLD}"], use_env=False)

    def train(arch):
        return {"losses": [float(v) for v in TrainSession(
            spec("train", arch, P.TRAIN_SETS), mesh=mesh).run()["losses"]]}

    def serve(arch):
        got = {"static": np.asarray(ServeSession(
            spec("serve", arch, P.STATIC_SETS), mesh=mesh).run()["generated"]).tolist()}
        for paged in (False, True):
            got[f"engine_{paged}"] = np.asarray(ServeSession(
                spec("serve", arch, P.ENGINE_SETS + [f"serving.pages={paged}"]),
                mesh=mesh).run()["generated"]).tolist()
        return got

    # each arch's training and serving on threads of their own: most of the
    # time is XLA's compiles
    with concurrent.futures.ThreadPoolExecutor(2 * len(P.ARCHS)) as pool:
        jobs = {(arch, fn): pool.submit(fn, arch) for arch in P.ARCHS for fn in (train, serve)}
        out = {arch: {**jobs[arch, train].result(), **jobs[arch, serve].result()}
               for arch in P.ARCHS}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
