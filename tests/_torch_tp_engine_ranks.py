"""Rank bodies for ``test_torch_tp_engine.py``: the serving engines under
tensor parallelism over ``model``, in gloo CPU ranks spawned by
``repro_torch.dist.launch.run`` (and the same runs unsharded, in the test
process, through :func:`engine_runs` with no mesh).  This module imports
no jax: the reference's parameters arrive as numpy trees."""

from __future__ import annotations

import os

import numpy as np
import torch

from _torch_mesh_ranks import SERVE_SETS

#: the engine session's spec: SERVE_SETS on the engine path, quant
ENGINE_SETS = [s for s in SERVE_SETS if s != "serving.static=true"] + ["numerics.mode=quant"]
MODE = "quant"
#: the paged geometry of test_torch_paging.py's parity case: pool length 38,
#: 4 tokens a page, 8 physical pages at overcommit 2 (a request spills)
PARITY = dict(n_slots=4, max_len=38, page_tokens=4, num_pages=8, overcommit=2.0)
GEN = 5
#: the monolithic pool the snapshot cases cross with (2 slots, length 38)
MONO = dict(n_slots=2, max_len=38)
SPEC_HASH = "feedbeefcafe0123"
PRUNE = 0.5
#: reduced minitron-4b at model 3: 6 q heads split two a rank, its 2 kv
#: heads do not divide (rank 1 holds both)
UNEVEN_ARCH, UNEVEN_WORLD = "minitron-4b", 3


def shared_prompts(vocab: int) -> list:
    """Five prompts from ``default_rng(3)`` (test_torch_paging.py's shared
    set): two equal ones, one sharing their first two pages, two others."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, vocab, 8 + i).tolist() for i in range(4)]
    p = prompts[3]
    return [p, list(p), p[:8] + [5, 9], prompts[0], prompts[1]]


def _spec(run: str, sets: list):
    from repro_torch.api.spec import build_spec

    return build_spec(run, sets=sets, use_env=False)


def _tokens(out: dict) -> list:
    return [r["tokens"] for r in out["per_request"]]


def _submit(eng, prompts, gen=GEN):
    for i, p in enumerate(prompts):
        eng.submit_prompt(p, gen, seed=100 + i)
    return eng


def _log_decisions(eng) -> list:
    """Record each admission, spill and resume as (kind, tick, rid)."""
    log: list = []

    def wrap(kind, fn, rid_of):
        def run(*args):
            log.append((kind, eng.tick, rid_of(*args)))
            return fn(*args)
        return run

    eng._admit_one = wrap("admit", eng._admit_one, lambda t: t.req.rid)
    eng._resume_one = wrap("resume", eng._resume_one, lambda t, s: t.req.rid)
    eng._spill_slot = wrap("spill", eng._spill_slot, lambda s: eng.sched.active[s].req.rid)
    return log


def _wire(out: dict) -> dict:
    return {k: out[k] for k in ("kv_mean_wire_bytes", "kv_mean_density", "peak_kv_wire_bytes",
                                "kv_nnz", "kv_elems")}


def _cfg(arch: str = "llama3.2-1b"):
    from repro_torch.configs import get_arch

    return get_arch(arch).resolve(reduced=True)


def make_engine(cfg, params, mesh, paged: bool, prune: float = 0.0, **kw):
    from repro_torch.launch.serve import serving_config
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.paging import PagedServingEngine

    kw = dict(params=params, device="cpu", mesh=mesh, spec_hash=SPEC_HASH, prune_ratio=prune,
              **kw)
    if paged:
        return PagedServingEngine(cfg, serving_config(MODE), **{**PARITY, **kw})
    return ServingEngine(cfg, serving_config(MODE), **{**MONO, **kw})


def _snapshot_run(cfg, params, mesh, paged: bool, path: str) -> list:
    """Two ticks, a rescale to one slot (the actives spill), one tick, a
    snapshot written to ``path`` (rank 0); then the run to its end."""
    from repro_torch.dist.mesh import is_rank0
    from repro_torch.serving import elastic

    eng = _submit(make_engine(cfg, params, mesh, paged), shared_prompts(cfg.vocab))
    for _ in range(2):
        eng.step()
    eng.rescale(1)
    eng.step()
    snap = eng.snapshot()
    if is_rank0():
        elastic.save_snapshot(snap, path)
    return _tokens(eng.run())


def _restored(cfg, params, mesh, paged: bool, path: str) -> list:
    eng = make_engine(cfg, params, mesh, paged)
    eng.restore_file(path)
    return _tokens(eng.run())


CHAOS = [("snapshot", 1, None), ("rescale", 2, 1), ("roundtrip", 3, None),
         ("rewind", 4, None), ("rescale", 5, 3), ("kill", 6, None)]


def _chaos(cfg, params, mesh, paged: bool, tmp: str) -> dict:
    from repro_torch.serving import elastic

    eng = _submit(make_engine(cfg, params, mesh, paged), shared_prompts(cfg.vocab))
    events = [elastic.ChaosEvent(at, kind, slots=slots) for kind, at, slots in CHAOS]
    harness = elastic.ChaosHarness(eng, events, tmp_dir=tmp,
                                   make_engine=lambda: make_engine(cfg, params, mesh, paged))
    out = harness.run()
    return {"tokens": _tokens(out), "spills": out["elastic"]["n_spills"]}


def pruned_step(np_params: dict, mesh) -> dict:
    """One pruned forward and backward of TRAIN_SETS' model (quant_sparse,
    nearest, prune 0.5): the loss and every gradient, whole (gathered over
    ``model`` under a mesh); then two make_train_step steps' losses."""
    from repro_torch.configs import get_arch
    from repro_torch.convert import params_from_jax
    from repro_torch.core.spring_ops import MODES
    from repro_torch.models.layers import SpringContext
    from repro_torch.models.lm import lm_loss
    from repro_torch.optim.optimizers import OptimizerConfig, tree_leaves, tree_map
    from repro_torch.runtime.sharding import sharding_context
    from repro_torch.runtime.train import StepConfig, init_train_state, make_train_step
    from repro_torch.runtime.tree_sharding import gather_tree, param_splits, shard_tree

    view = get_arch("llama3.2-1b").view(reduced=True)
    cfg = view.config
    params = params_from_jax(np_params, cfg)
    if mesh is not None:
        with sharding_context(mesh):
            params = shard_tree(params, mesh)
            splits = param_splits(cfg, mesh)
    tokens = (torch.arange(64).reshape(4, 16) * 37 + 5) % cfg.vocab
    ctx = SpringContext(cfg=MODES["quant_sparse"], prune_ratio=PRUNE, attention="chunked")
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    with sharding_context(mesh):
        loss, _ = lm_loss(p, cfg, tokens, ctx)
        grads = torch.autograd.grad(loss, tree_leaves(p))
    it = iter(grads)
    grads = tree_map(lambda _: next(it), params)
    if mesh is not None:
        grads = gather_tree(grads, mesh, splits)
    step_cfg = StepConfig(spring=MODES["quant_sparse"], prune_ratio=PRUNE,
                          optimizer=OptimizerConfig(lr=3e-3, warmup_steps=2))
    state = init_train_state(params, step_cfg, 0, device="cpu")
    step = make_train_step(view, step_cfg, mesh=mesh)
    losses = []
    for i in range(2):
        state, metrics = step(state, {"tokens": (tokens + i) % cfg.vocab})
        losses.append(float(metrics["loss"]))
    return {"loss": float(loss.detach()), "grads": [g.detach() for g in tree_leaves(grads)],
            "losses": losses}


def engine_runs(np_params: dict, mesh, world: int, files: dict, tmp: str) -> dict:
    """Every engine run of the file at ``shape.mesh.model = world`` on
    ``mesh`` (None and world 1: unsharded).  ``files`` names the snapshot
    files: ``write`` (this run's, by rank 0), ``ref`` (the reference
    engine's) and ``unsharded`` / ``unsharded_paged`` (the port's at model
    1) to restore, where given."""
    from repro_torch.api.sessions import ServeSession
    from repro_torch.convert import params_from_jax

    cfg = _cfg()
    params = params_from_jax(np_params, cfg)
    mesh_sets = [] if world == 1 else [f"shape.mesh.model={world}"]
    out: dict = {"session": {}}
    for paged in (False, True):
        sv = ServeSession(_spec("serve", ENGINE_SETS + mesh_sets + [f"serving.pages={paged}"]),
                          device="cpu", params=params_from_jax(np_params, cfg)).run()
        out["session"][paged] = {"tokens": sv["generated"].tolist(),
                                 "report": sv.get("tensor_parallel"), "ticks": sv["ticks"]}
    prompts = shared_prompts(cfg.vocab)
    for paged in (False, True):
        eng = _submit(make_engine(cfg, params, mesh, paged, **(dict(n_slots=4) if not paged
                                                              else {})), prompts)
        log = _log_decisions(eng)
        run = eng.run()
        out[("paged" if paged else "mono")] = {
            "tokens": _tokens(run), "wire": _wire(run), "decisions": log,
            "paging": run.get("paging"), "pool_bytes": eng.pool_bytes()}
    out["pruned"] = _tokens(_submit(make_engine(cfg, params, mesh, False, prune=PRUNE),
                                    prompts).run())
    out["snapshot"] = {paged: _snapshot_run(cfg, params, mesh, paged,
                                            files[f"write_{int(paged)}"])
                       for paged in (False, True)}
    out["restored"] = {}
    for name, paged in (("ref", False), ("unsharded", False), ("unsharded_paged", True)):
        if files.get(name):
            out["restored"][name] = _restored(cfg, params, mesh, paged, files[name])
    if world == 2 or mesh is None:
        out["chaos"] = {paged: _chaos(cfg, params, mesh, paged, tmp) for paged in (False, True)}
        out["train"] = pruned_step(np_params, mesh)
    return out


def uneven_runs(mesh) -> dict:
    """Reduced minitron-4b from its seeded init, both engines on the shared
    prompts: tokens, and each rank's kv heads (``mesh``: a thread rank's
    ``ThreadMesh``, or None)."""
    from repro_torch.models.lm import lm_init

    cfg = _cfg(UNEVEN_ARCH)
    params = lm_init(cfg, 0, device="cpu")
    out = {}
    for paged in (False, True):
        eng = _submit(make_engine(cfg, params, mesh, paged), shared_prompts(cfg.vocab))
        out[paged] = _tokens(eng.run())
        out["heads"] = None if eng.heads is None else eng.heads.mine
    return out


def engine_ranks(rank: int, world: int, np_params: dict, files: dict, tmp: str) -> dict:
    """:func:`engine_runs` at ``model = world``, one thread a rank."""
    torch.set_num_threads(1)
    from repro_torch.dist.mesh import make_explicit_mesh

    mesh = make_explicit_mesh(1, 1, world)
    tmp = os.path.join(tmp, f"rank{rank}")
    os.makedirs(tmp, exist_ok=True)
    out = engine_runs(np_params, mesh, world, files, tmp)
    out["hops"] = dict(mesh.hops)
    return out
