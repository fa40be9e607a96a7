"""Rank bodies of ``test_torch_mesh_ranks.py``: each runs in a gloo CPU
rank spawned by ``repro_torch.dist.launch.run`` and hands back plain
values.  This module imports no jax, so a rank starts with torch and the
port alone; the reference's parameters arrive as numpy trees."""

from __future__ import annotations

import torch

#: the reference's TRAIN_SETS (tests/test_mesh.py) with the numerics the
#: port's session is held to the reference's at (test_torch_lm_train.py's
#: PARITY_SETS: quant_sparse, nearest rounding)
TRAIN_SETS = ["arch.id=llama3.2-1b", "train.steps=2", "shape.batch=4", "shape.seq=16",
              "train.ckpt_dir=", "numerics.mode=quant_sparse", "numerics.stochastic=off"]
SERVE_SETS = ["arch.id=llama3.2-1b", "shape.batch=4", "shape.prompt_len=8", "shape.gen=3",
              "serving.static=true"]
FALLBACK_SETS = ["arch.id=llama3.2-1b", "shape.batch=3", "shape.prompt_len=8", "shape.gen=2",
                 "serving.static=true", "shape.mesh.data=4"]
#: the engine path (a queue of 3 over 2 slots) for the snapshot case
SNAPSHOT_SETS = ["arch.id=llama3.2-1b", "shape.batch=2", "shape.prompt_len=6", "shape.gen=4",
                 "serving.queue=3", "numerics.mode=quant_sparse"]
SERVE_MODES = ("dense", "quant")
#: the pipeline case: the reference's test_pipeline_parallelism_matches_sequential
PIPE = dict(stages=4, micro=6, mb=8, d=32)


def pipeline_inputs():
    """(per-stage params, microbatches), from a numpy seed."""
    import numpy as np

    rng = np.random.default_rng(0)
    d = PIPE["d"]
    params = [{"w": torch.from_numpy((rng.standard_normal((d, d)) / d**0.5).astype(np.float32))}
              for _ in range(PIPE["stages"])]
    xs = torch.from_numpy(rng.standard_normal((PIPE["micro"], PIPE["mb"], d)).astype(np.float32))
    return params, xs


def stage_fn(x, p):
    return torch.tanh(x @ p["w"])


def _spec(run: str, sets: list):
    from repro_torch.api.spec import build_spec

    return build_spec(run, sets=sets, use_env=False)


def fail_on_rank_one(rank: int, world: int) -> int:
    """A rank body that raises on rank 1 and returns at once elsewhere."""
    if rank == 1:
        raise ValueError("rank one fails on purpose")
    return rank


def four_ranks(rank: int, world: int, train_params: dict, serve_params: dict) -> dict:
    """At ``data = world``: the collectives in both modes, the sharded
    TrainSession and static ServeSession (dense and quant), the
    indivisible batch, and (over ``pod``) the pipeline."""
    torch.set_num_threads(1)
    from repro_torch.api.sessions import ServeSession, TrainSession
    from repro_torch.configs import get_arch
    from repro_torch.convert import params_from_jax
    from repro_torch.dist import collectives as C
    from repro_torch.dist.mesh import Mesh, make_explicit_mesh
    from repro_torch.runtime.pipeline import pipeline_apply, stack_stage_params
    from repro_torch.runtime.sharding import mesh_fallback_counts, sharding_context
    from repro_torch.telemetry.metrics import default_registry

    out: dict = {}
    mesh = make_explicit_mesh(1, world, 1)
    x = C._shard_block(6, world, 512, 0.4)
    xb = C._shard_block(1, world, 512, 0.5, torch.bfloat16)
    with sharding_context(mesh):
        out["collectives"] = {
            "all_gather": torch.equal(C.packed_all_gather(x[rank], axis_name="data"),
                                      C.packed_all_gather(x)),
            "all_gather_bf16": torch.equal(C.packed_all_gather(xb[rank], axis_name="data"),
                                           C.packed_all_gather(xb)),
            "reduce_scatter": torch.equal(C.packed_reduce_scatter(x[rank], axis_name="data"),
                                          C.packed_reduce_scatter(x)[rank]),
            "dense_reduce_scatter": torch.equal(
                C.dense_reduce_scatter(x[rank], axis_name="data"), C.dense_reduce_scatter(x)[rank]),
        }

    cfg = get_arch("llama3.2-1b").resolve(reduced=True)
    tr = TrainSession(_spec("train", TRAIN_SETS + [f"shape.mesh.data={world}"]), device="cpu",
                      params=params_from_jax(train_params, cfg)).run()
    out["train"] = {"losses": tr["losses"], "mesh": tr["mesh"], "probe": tr["collective_probe"]}
    out["serve"] = {}
    for mode in SERVE_MODES:
        sv = ServeSession(_spec("serve", SERVE_SETS + [f"shape.mesh.data={world}",
                                                       f"numerics.mode={mode}"]),
                          device="cpu", params=params_from_jax(serve_params, cfg)).run()
        out["serve"][mode] = {"generated": sv["generated"].tolist(),
                              "exact": sv["collective_probe"]["exact"]}

    default_registry().reset()
    fb = ServeSession(_spec("serve", FALLBACK_SETS), device="cpu",
                      params=params_from_jax(serve_params, cfg)).run()
    out["fallback"] = {"finite": fb["finite"], "probe": "collective_probe" in fb,
                       "counts": mesh_fallback_counts(), "generated": fb["generated"].tolist()}

    per_stage, xs = pipeline_inputs()
    pipe_mesh = Mesh(world, 1, 1)
    out["pipeline"] = pipeline_apply(stage_fn, stack_stage_params(per_stage), xs,
                                     mesh=pipe_mesh, axis="pod")
    return out


def two_pods(rank: int, world: int, snapshot_path: str) -> dict:
    """At ``pod = 2``: the int8 + EF exchange on per-pod gradients, and
    make_train_step's compress_pod_grads on the reduced llama3.2-1b; then,
    at ``data = 2``, the replicated engine writing a snapshot every tick
    to ``snapshot_path``."""
    torch.set_num_threads(1)
    from repro_torch.api.sessions import ServeSession
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
    from repro_torch.dist.mesh import make_explicit_mesh
    from repro_torch.kernels.prng import fold_in
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.runtime import compression
    from repro_torch.runtime.sharding import sharding_context
    from repro_torch.runtime.train import StepConfig, init_train_state, make_train_step

    mesh = make_explicit_mesh(world, 1, 1)
    gen = torch.Generator().manual_seed(100 + rank)
    grads = {"w": torch.randn(64, 48, generator=gen), "b": torch.randn(300, generator=gen) * 1e-3}
    ef = {"w": torch.randn(64, 48, generator=gen) * 1e-2, "b": torch.zeros(300)}
    with sharding_context(mesh):
        out_tree, ef_tree = compression.compressed_allreduce_tree(grads, "pod", 7, ef)
    leaves = {}
    for i, k in enumerate(grads):
        local = grads[k] + ef[k]
        q, scale = compression.sr_quantize_int8(local, fold_in(7, i))
        leaves[k] = {"local": local, "q": q, "scale": scale, "out": out_tree[k],
                     "ef": ef_tree[k]}

    view = get_arch("llama3.2-1b").view(reduced=True)
    step_cfg = StepConfig(compress_pod_grads=True)
    state = init_train_state(view, step_cfg, 0, reduced=True, device="cpu")
    step = make_train_step(view, step_cfg, mesh=mesh)
    stream = SyntheticLMStream(DataConfig(seed=0, vocab=view.config.vocab, seq_len=16,
                                          global_batch=4), device="cpu")
    losses = []
    for i in range(2):
        state, metrics = step(state, {"tokens": stream.batch(i)})
        losses.append(float(metrics["loss"]))
    served = ServeSession(_spec("serve", SNAPSHOT_SETS + [
        f"shape.mesh.data={world}", "serving.snapshot_every=1",
        f"serving.snapshot_path={snapshot_path}"]), device="cpu").run()
    return {"leaves": leaves, "losses": losses,
            "params": torch.cat([p.reshape(-1) for p in tree_leaves(state.params)]),
            "ef_leaves": len(tree_leaves(state.ef)),
            "served": {"tokens": [r["tokens"] for r in served["per_request"]],
                       "n_snapshots": served["elastic"]["n_snapshots"]}}


def card_train(rank: int, world: int) -> dict:
    """The card test's rank: the reduced llama3.2-1b's TrainSession at
    ``shape.mesh.data=world`` on the card the ranks share (gloo, staged
    hops), with the kernels' launch counts."""
    from repro_torch import kernels
    from repro_torch.api.sessions import TrainSession
    from repro_torch.dist.mesh import make_explicit_mesh
    from repro_torch.optim.optimizers import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_explicit_mesh(1, world, 1, device="cuda")
    kernels.reset_launch_counts()
    out = TrainSession(_spec("train", TRAIN_SETS + [f"shape.mesh.data={world}"]),
                       device=mesh.device, mesh=mesh).run()
    return {"losses": out["losses"], "launches": kernels.launch_counts(),
            "staged_hops": mesh.staged_hops, "backend": mesh.backend,
            "params": torch.cat([p.reshape(-1) for p in tree_leaves(out["state"].params)]).cpu()}
