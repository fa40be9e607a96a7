"""Rank bodies for ``test_torch_ssm_parallel.py``: reduced mamba2-780m and
recurrentgemma-9b with their SSM heads, RG-LRU channels, local attention
heads and vocabulary split over ``model``, in gloo CPU ranks spawned by
``repro_torch.dist.launch.run`` (and the same runs unsharded, in the test
process, through :func:`runs` with world 1).  This module imports no jax:
the reference's parameters arrive as numpy trees."""

from __future__ import annotations

import torch

from _torch_ep_ranks import ENGINE_SETS, STATIC_SETS, TRAIN_SETS, spec

#: (arch, model extent) of every partitioned run
RUNS = (("mamba2-780m", 4), ("recurrentgemma-9b", 4), ("mamba2-780m", 2))
ARCHS = ("mamba2-780m", "recurrentgemma-9b")
#: the engine session writing its snapshot: every 2 ticks, the last kept
SNAPSHOT_EVERY = 2
#: the whole leaves a rank reads slices of, besides the norm scales
WHOLE_LEAVES = ("conv_w", "conv_b", "a_log", "dt_bias", "d_skip", "lam")


def archs_at(world: int) -> tuple:
    return ARCHS if world == 1 else tuple(a for a, m in RUNS if m == world)


def replicated_leaves(params: dict) -> torch.Tensor:
    """Every leaf that stays whole on every rank (the norm scales, the conv
    weights and biases, the SSM's a_log / dt_bias / d_skip, the RG-LRU's
    lam), flattened and concatenated."""
    from repro_torch.runtime.tree_sharding import map_with_path

    out: list = []
    map_with_path(lambda path, leaf: out.append(leaf.detach().reshape(-1))
                  if path[-1] == "scale" or path[-1] in WHOLE_LEAVES else None, params)
    return torch.cat(out)


def pool_shapes(eng) -> dict:
    """{"key/leaf": dense shape} of an engine's pool."""
    return {f"{key}/{name}": tuple(leaf.shape) for key, sub in eng.pool.items()
            if key != "pos" for name, leaf in sub.items()}


def _tokens(out: dict) -> list:
    return [[int(t) for t in row] for row in out["generated"]]


def runs(np_params: dict, world: int, dirs: dict) -> dict:
    """At ``shape.mesh.model = world`` (1: unsharded, no mesh), for each
    arch run at that extent, from the reference's parameters:
    TrainSession's losses, its report and replicated leaves after the
    steps, the static tokens, the engine session's tokens and its pool's
    shapes, the engine session writing its snapshot to ``dirs["snap"]``
    (``<snap>-<arch>.npz``) and, where ``dirs["restore"]`` names an
    unsharded one, restoring it;
    TrainSession writing its checkpoint to ``dirs["ckpt"]`` (3 steps at
    world 1: the uninterrupted run; 2 at model n) and resuming
    ``dirs["resume"]`` where given."""
    from repro_torch.api.sessions import ServeSession, TrainSession, build_mesh
    from repro_torch.configs import get_arch
    from repro_torch.convert import params_from_jax
    from repro_torch.serving.engine import ServingEngine

    out: dict = {}
    for arch in archs_at(world):
        cfg = get_arch(arch).resolve(reduced=True)

        def params():
            return params_from_jax(np_params[arch], cfg)

        def path(kind):
            return f"{dirs[kind]}/{arch}"

        tr = TrainSession(spec("train", arch, TRAIN_SETS, world), device="cpu",
                          params=params()).run()
        one = {"losses": tr["losses"], "report": tr.get("tensor_parallel"),
               "replicated": replicated_leaves(tr["state"].params)}
        sv = ServeSession(spec("serve", arch, STATIC_SETS, world), device="cpu",
                          params=params()).run()
        one["static"], one["static_report"] = _tokens(sv), sv.get("tensor_parallel")
        ev = ServeSession(spec("serve", arch, ENGINE_SETS, world), device="cpu",
                          params=params()).run()
        one["engine"], one["engine_report"] = _tokens(ev), ev.get("tensor_parallel")
        eng_spec = spec("serve", arch, ENGINE_SETS, world)
        eng = ServingEngine.from_spec(eng_spec, params=params(), device="cpu",
                                      mesh=build_mesh(eng_spec.shape.mesh))
        one["pool"], one["pool_bytes"] = pool_shapes(eng), eng.pool_bytes()
        one["snapshot"] = _tokens(ServeSession(spec("serve", arch, ENGINE_SETS + [
            f"serving.snapshot_every={SNAPSHOT_EVERY}",
            f"serving.snapshot_path={dirs['snap']}-{arch}.npz"], world), device="cpu",
            params=params()).run())
        if dirs.get("restore"):
            one["restored"] = _tokens(ServeSession(spec("serve", arch, ENGINE_SETS + [
                f"serving.restore_path={dirs['restore']}-{arch}.npz"], world), device="cpu",
                params=params()).run())

        steps = 3 if world == 1 else 2
        base = [s for s in TRAIN_SETS if not s.startswith("train.")]
        one["ckpt_losses"] = TrainSession(spec("train", arch, base + [
            f"train.steps={steps}", f"train.ckpt_dir={path('ckpt')}", "train.ckpt_every=1"],
            world), device="cpu", params=params()).run()["losses"]
        if dirs.get("resume"):
            one["resumed_losses"] = TrainSession(spec("train", arch, base + [
                "train.steps=2", f"train.ckpt_dir={dirs['resume']}/{arch}"], world),
                device="cpu").run()["losses"]
        out[arch] = one
    return out


def ssm_ranks(rank: int, world: int, np_params: dict, dirs: dict) -> dict:
    """:func:`runs` at ``model = world``, one thread a rank."""
    torch.set_num_threads(1)
    return runs(np_params, world, dirs)


def card_ssm_serve(rank: int, world: int, params: dict) -> dict:
    """The card test's rank: reduced mamba2-780m and recurrentgemma-9b at
    ``shape.mesh.model = world`` on the card the ranks share (gloo, staged
    hops), from the whole CPU ``params`` ({arch: tree}) moved to the card:
    the static path's and the engine's tokens (quant_sparse), with the
    kernels' launch counts."""
    from repro_torch import kernels
    from repro_torch.api.sessions import ServeSession
    from repro_torch.dist.mesh import make_explicit_mesh
    from repro_torch.optim.optimizers import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_explicit_mesh(1, 1, world, device="cuda")
    kernels.reset_launch_counts()
    out: dict = {}
    for arch in ARCHS:
        for name, sets in (("static", STATIC_SETS), ("engine", ENGINE_SETS)):
            sv = ServeSession(spec("serve", arch, sets + ["numerics.mode=quant_sparse"], world),
                              device=mesh.device, mesh=mesh,
                              params=tree_map(lambda p: p.to(mesh.device), params[arch])).run()
            out[f"{arch}/{name}"] = _tokens(sv)
            out[f"{arch}/report"] = sv["tensor_parallel"]
    return {**out, "launches": kernels.launch_counts(), "backend": mesh.backend}
