"""The reference's partitioned runs for ``test_torch_ssm_parallel.py``, run
as its own process (``python tests/_torch_ssm_tp_reference.py``) with
``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
``_torch_ep_reference.py`` is: its sessions take an Auto-typed ``(1, 1,
m)`` mesh made here, so GSPMD partitions the SSM's heads, the RG-LRU's
channels, the local attention's heads and the vocabulary over ``model``.
Prints one JSON object: for each ``(arch, m)`` of ``_torch_ssm_tp_ranks.RUNS``
(reduced mamba2-780m at model 2 and 4, reduced recurrentgemma-9b at
model 4), the training losses, the static tokens and the monolithic
engine session's tokens (``_torch_ep_ranks``' sets)."""

from __future__ import annotations

import concurrent.futures
import json
import os
import sys


def main() -> None:
    if "--xla_force_host_platform_device_count=4" not in os.environ.get("XLA_FLAGS", ""):
        raise SystemExit("run with XLA_FLAGS=--xla_force_host_platform_device_count=4")
    sys.path.insert(0, os.path.dirname(__file__))
    import jax
    import numpy as np
    from jax.sharding import AxisType

    import _torch_ep_ranks as EP
    import _torch_ssm_tp_ranks as P
    from repro.api.sessions import ServeSession, TrainSession
    from repro.api.spec import build_spec

    def mesh(m):
        return jax.make_mesh((1, 1, m), ("pod", "data", "model"),
                             axis_types=(AxisType.Auto,) * 3, devices=jax.devices()[:m])

    def spec(run, arch, m, sets):
        return build_spec(run, sets=[f"arch.id={arch}"] + sets + [f"shape.mesh.model={m}"],
                          use_env=False)

    def train(arch, m):
        return {"losses": [float(v) for v in TrainSession(
            spec("train", arch, m, EP.TRAIN_SETS), mesh=mesh(m)).run()["losses"]]}

    def serve(arch, m):
        return {name: np.asarray(ServeSession(spec("serve", arch, m, sets),
                                              mesh=mesh(m)).run()["generated"]).tolist()
                for name, sets in (("static", EP.STATIC_SETS), ("engine", EP.ENGINE_SETS))}

    # each run on a thread of its own: most of the time is XLA's compiles
    with concurrent.futures.ThreadPoolExecutor(2 * len(P.RUNS)) as pool:
        jobs = {(run, fn): pool.submit(fn, *run) for run in P.RUNS for fn in (train, serve)}
        out = {f"{arch}@{m}": {**jobs[(arch, m), train].result(),
                               **jobs[(arch, m), serve].result()} for arch, m in P.RUNS}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
