"""Rank bodies for ``test_torch_expert_parallel.py``: reduced olmoe-1b-7b
and deepseek-v2-lite-16b with their experts, heads and vocabulary split
over ``model``, in gloo CPU ranks spawned by
``repro_torch.dist.launch.run`` (and the same runs unsharded, in the test
process, through :func:`runs` with world 1).  This module imports no jax:
the reference's parameters arrive as numpy trees."""

from __future__ import annotations

import torch

ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite-16b")
#: training at quant_sparse, nearest rounding (the reference parity's numerics)
TRAIN_SETS = ["train.steps=2", "shape.batch=4", "shape.seq=16", "train.ckpt_dir=",
              "numerics.mode=quant_sparse", "numerics.stochastic=off"]
STATIC_SETS = ["shape.batch=4", "shape.prompt_len=8", "shape.gen=3", "serving.static=true",
               "numerics.mode=quant"]
#: the engine path: a queue of 3 over 2 slots
ENGINE_SETS = ["shape.batch=2", "serving.queue=3", "shape.prompt_len=8", "shape.gen=3",
               "numerics.mode=quant"]
#: the arch the checkpoints and the seeded (no params) runs use
CKPT_ARCH = "olmoe-1b-7b"


def spec(run: str, arch: str, sets: list, world: int = 1):
    from repro_torch.api.spec import build_spec

    mesh = [] if world == 1 else [f"shape.mesh.model={world}"]
    return build_spec(run, sets=[f"arch.id={arch}"] + sets + mesh, use_env=False)


def replicated_leaves(params: dict) -> torch.Tensor:
    """Every leaf that stays whole on every rank (the norm scales, the
    routers, MLA's ``wdkv`` / ``wkr``), flattened and concatenated."""
    from repro_torch.runtime.tree_sharding import map_with_path

    out: list = []

    def pick(path, leaf):
        if path[-1] == "scale" or (path[-1] == "kernel"
                                   and path[-2] in ("router", "wdkv", "wkr")):
            out.append(leaf.detach().reshape(-1))

    map_with_path(pick, params)
    return torch.cat(out)


def _tokens(out: dict) -> list:
    return out["generated"].tolist() if hasattr(out["generated"], "tolist") \
        else [list(t) for t in out["generated"]]


def runs(np_params: dict, world: int, ckpt: dict) -> dict:
    """At ``shape.mesh.model = world`` (1: unsharded, no mesh): for each
    arch, from the reference's parameters, TrainSession's losses, its
    report and replicated leaves after the steps, the static tokens and
    the engine session's tokens monolithic and paged.  For CKPT_ARCH,
    TrainSession writing its checkpoint to ``ckpt["write"]`` (3 steps at
    world 1: the uninterrupted run), resuming ``ckpt["resume"]`` where
    given, and the seeded runs given no parameters: training, the static
    and engine paths; ``shard_inits`` counts the leaf-by-leaf inits."""
    from repro_torch.api.sessions import ServeSession, TrainSession
    from repro_torch.configs import get_arch
    from repro_torch.convert import params_from_jax
    from repro_torch.models import lm as lm_mod
    from repro_torch.optim.optimizers import tree_leaves

    out: dict = {}
    for arch in ARCHS:
        cfg = get_arch(arch).resolve(reduced=True)

        def params():
            return params_from_jax(np_params[arch], cfg)

        tr = TrainSession(spec("train", arch, TRAIN_SETS, world), device="cpu",
                          params=params()).run()
        one = {"losses": tr["losses"], "report": tr.get("tensor_parallel"),
               "replicated": replicated_leaves(tr["state"].params),
               "shapes": [tuple(p.shape) for p in tree_leaves(tr["state"].params)]}
        sv = ServeSession(spec("serve", arch, STATIC_SETS, world), device="cpu",
                          params=params()).run()
        one["static"] = _tokens(sv)
        for paged in (False, True):
            ev = ServeSession(spec("serve", arch, ENGINE_SETS + [f"serving.pages={paged}"],
                                   world), device="cpu", params=params()).run()
            one[f"engine_{paged}"] = _tokens(ev)
            one[f"engine_report_{paged}"] = ev.get("tensor_parallel")
        out[arch] = one

    arch = CKPT_ARCH
    steps = 3 if world == 1 else 2
    base = [s for s in TRAIN_SETS if not s.startswith("train.")] + [f"train.steps={steps}"]
    out["ckpt_losses"] = TrainSession(
        spec("train", arch, base + [f"train.ckpt_dir={ckpt['write']}", "train.ckpt_every=1"],
             world), device="cpu", params=params_from_jax(np_params[arch],
                                                        get_arch(arch).resolve(reduced=True))
    ).run()["losses"]
    if ckpt.get("resume"):
        out["resumed_losses"] = TrainSession(
            spec("train", arch, base[:-1] + ["train.steps=2", f"train.ckpt_dir={ckpt['resume']}"],
                 world), device="cpu").run()["losses"]

    # the seeded runs: under tp each rank draws its shards leaf by leaf
    inits = []
    real = lm_mod._init_shards

    def counted(*args):
        inits.append(args[2])
        return real(*args)

    lm_mod._init_shards = counted
    try:
        tr = TrainSession(spec("train", arch, TRAIN_SETS, world), device="cpu").run()
        leaves = tree_leaves(tr["state"].params)
        out["seeded"] = {
            "losses": tr["losses"],
            "static": _tokens(ServeSession(spec("serve", arch, STATIC_SETS, world),
                                           device="cpu").run()),
            "engine": _tokens(ServeSession(spec("serve", arch, ENGINE_SETS, world),
                                           device="cpu").run()),
            # a shard is a copy: no leaf keeps the whole leaf's storage alive
            "compact": all(p.untyped_storage().nbytes() == p.numel() * p.element_size()
                           for p in leaves)}
    finally:
        lm_mod._init_shards = real
    out["shard_inits"] = len(inits)
    return out


def ep_ranks(rank: int, world: int, np_params: dict, ckpt: dict) -> dict:
    """:func:`runs` at ``model = world``, one thread a rank."""
    torch.set_num_threads(1)
    return runs(np_params, world, ckpt)


def card_ep_serve(rank: int, world: int, params) -> dict:
    """The card test's rank: reduced olmoe-1b-7b at ``shape.mesh.model =
    world`` on the card the ranks share (gloo, staged hops), from the
    whole CPU ``params`` moved to the card: the static path's and the
    engine's tokens (quant_sparse), with the kernels' launch counts."""
    from repro_torch import kernels
    from repro_torch.api.sessions import ServeSession
    from repro_torch.dist.mesh import make_explicit_mesh
    from repro_torch.optim.optimizers import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_explicit_mesh(1, 1, world, device="cuda")
    kernels.reset_launch_counts()
    out = {}
    for name, sets in (("static", STATIC_SETS), ("engine", ENGINE_SETS)):
        sv = ServeSession(spec("serve", CKPT_ARCH, sets + ["numerics.mode=quant_sparse"], world),
                          device=mesh.device, mesh=mesh,
                          params=tree_map(lambda p: p.to(mesh.device), params)).run()
        out[name] = _tokens(sv)
        out["report"] = sv["tensor_parallel"]
    return {**out, "launches": kernels.launch_counts(), "backend": mesh.backend}
