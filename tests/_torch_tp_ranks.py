"""Rank bodies and a thread-simulated mesh for
``test_torch_tensor_parallel.py``.  The rank bodies run in gloo CPU ranks
spawned by ``repro_torch.dist.launch.run`` and hand back plain values;
this module imports no jax, so a rank starts with torch and the port
alone (the reference's parameters arrive as numpy trees).

:class:`ThreadMesh` runs the ranks of one ``model`` axis as threads of
the test process: the sharding context is per thread, and
``all_gather`` meets the other threads at a barrier, so a layer's
collectives run in-process, with :class:`repro_torch.dist.mesh.Mesh`'s own
``all_reduce`` (a sum in rank order) on top.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.dist.mesh import Mesh

from _torch_mesh_ranks import SERVE_MODES, SERVE_SETS, TRAIN_SETS

TRAIN_MODES = ("quant_sparse", "dense")


class ThreadMesh:
    """Rank ``rank`` of a ``model`` axis of ``board.n`` threads."""

    all_reduce = Mesh.all_reduce

    def __init__(self, board: "Board", rank: int):
        self.shape = {"pod": 1, "data": 1, "model": board.n}
        self.board, self.rank = board, rank
        self.hops: dict = {}
        self.staged_hops = 0
        self.device = torch.device("cpu")

    def axis_index(self, axis: str) -> int:
        return self.rank if axis == "model" else 0

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        b = self.board
        self.hops[axis] = self.hops.get(axis, 0) + 1
        b.barrier.wait()
        b.slots[self.rank] = x.detach().clone()
        b.barrier.wait()
        out = torch.stack(b.slots)
        b.barrier.wait()
        return out


class Board:
    def __init__(self, n: int):
        self.n = n
        self.barrier = threading.Barrier(n, timeout=60)
        self.slots: list = [None] * n


def on_threads(n: int, fn) -> list:
    """``[fn(mesh_0), ..., fn(mesh_{n-1})]``, each on its own thread inside
    ``sharding_context(mesh_r)``; a thread's error is raised here."""
    from repro_torch.runtime.sharding import sharding_context

    board, out, errs = Board(n), [None] * n, []

    def run(r):
        try:
            mesh = ThreadMesh(board, r)
            with sharding_context(mesh):
                out[r] = fn(mesh)
        except BaseException as e:  # handed to the caller
            board.barrier.abort()
            errs.append(e)

    threads = [threading.Thread(target=run, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]
    return out


def _spec(run: str, sets: list):
    from repro_torch.api.spec import build_spec

    return build_spec(run, sets=sets, use_env=False)


def tp_ranks(rank: int, world: int, params: dict, ckpt_dir: str, ref_ckpt: str) -> dict:
    """At ``shape.mesh.model = world``: TrainSession in both TRAIN_MODES
    and the static ServeSession in both SERVE_MODES from the reference's
    parameters; the hidden states and loss of one forward; a run writing
    its checkpoint (rank 0) to ``ckpt_dir``; a run resuming the
    reference's checkpoint in ``ref_ckpt``; at four ranks, the data=2 x
    model=2 runs, which keep model replicated."""
    torch.set_num_threads(1)
    from repro_torch.api.sessions import ServeSession, TrainSession
    from repro_torch.configs import get_arch
    from repro_torch.convert import params_from_jax
    from repro_torch.core.spring_ops import MODES
    from repro_torch.dist.mesh import make_explicit_mesh
    from repro_torch.models.layers import SpringContext
    from repro_torch.models.lm import lm_loss
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.runtime.sharding import sharding_context
    from repro_torch.runtime.tree_sharding import shard_tree

    cfg = get_arch("llama3.2-1b").resolve(reduced=True)
    mesh_sets = [f"shape.mesh.model={world}"]
    out: dict = {"train": {}, "serve": {}}
    for mode in TRAIN_MODES:
        tr = TrainSession(_spec("train", TRAIN_SETS + mesh_sets + [f"numerics.mode={mode}"]),
                          device="cpu", params=params_from_jax(params, cfg)).run()
        leaves = tree_leaves(tr["state"].params)
        out["train"][mode] = {"losses": tr["losses"], "mesh": tr["mesh"],
                              "report": tr["tensor_parallel"],
                              "shapes": [tuple(p.shape) for p in leaves],
                              "norms": torch.cat([p.reshape(-1) for p in leaves if p.ndim == 1])}
    for mode in SERVE_MODES:
        sv = ServeSession(_spec("serve", SERVE_SETS + mesh_sets + [f"numerics.mode={mode}"]),
                          device="cpu", params=params_from_jax(params, cfg)).run()
        out["serve"][mode] = {"generated": sv["generated"].tolist(),
                              "report": sv["tensor_parallel"]}

    # one forward: the replicated activations, bit for bit on every rank
    mesh = make_explicit_mesh(1, 1, world)
    with sharding_context(mesh):
        shard = shard_tree(params_from_jax(params, cfg), mesh)
    tokens = torch.arange(32).reshape(2, 16) * 7 % cfg.vocab
    ctx = SpringContext(cfg=MODES["quant_sparse"])
    with sharding_context(mesh):
        from repro_torch.models.lm import lm_hidden

        hidden, _ = lm_hidden(shard, cfg, tokens, ctx)
        loss, _ = lm_loss(shard, cfg, tokens, ctx)
    out["forward"] = {"hidden": hidden.detach(), "loss": loss.detach(),
                      "shard": [p.clone() for p in tree_leaves(shard)]}

    ck = TrainSession(_spec("train", [s for s in TRAIN_SETS if not s.startswith("train.ckpt")]
                            + mesh_sets + [f"train.ckpt_dir={ckpt_dir}", "train.ckpt_every=1"]),
                      device="cpu", params=params_from_jax(params, cfg)).run()
    out["ckpt_losses"] = ck["losses"]
    resumed = TrainSession(_spec("train", [s for s in TRAIN_SETS if not s.startswith("train.")]
                                 + mesh_sets + ["train.steps=2", f"train.ckpt_dir={ref_ckpt}"]),
                           device="cpu").run()
    out["resumed_losses"] = resumed["losses"]

    if world == 4:
        both = ["shape.mesh.data=2", "shape.mesh.model=2"]
        tr = TrainSession(_spec("train", TRAIN_SETS + both), device="cpu",
                          params=params_from_jax(params, cfg)).run()
        sv = ServeSession(_spec("serve", SERVE_SETS + both), device="cpu",
                          params=params_from_jax(params, cfg)).run()
        out["data_and_model"] = {"losses": tr["losses"], "generated": sv["generated"].tolist(),
                                 "tp": "tensor_parallel" in tr or "tensor_parallel" in sv}
    return out


#: reduced minitron-4b at model 3: its 96 q columns split, its 32 kv
#: columns, 256 MLP columns and 512 vocabulary rows do not (replicated)
UNEVEN_SETS = ["arch.id=minitron-4b", "train.steps=2", "shape.batch=4", "shape.seq=16",
               "train.ckpt_dir=", "numerics.mode=quant_sparse", "numerics.stochastic=off"]


def uneven_ranks(rank: int, world: int) -> dict:
    """UNEVEN_SETS at ``shape.mesh.model = world`` from the session's own
    seeded init: the losses, the report, and after training each layer's
    ``wk`` / ``wv`` kernels (whole on every rank, each rank reading its kv
    heads' columns) and the norm scales."""
    torch.set_num_threads(1)
    from repro_torch.api.sessions import TrainSession

    tr = TrainSession(_spec("train", UNEVEN_SETS + [f"shape.mesh.model={world}"]),
                      device="cpu").run()
    return {"losses": tr["losses"], "report": tr["tensor_parallel"],
            **replicated_leaves(tr["state"].params)}


def replicated_leaves(params: dict) -> dict:
    """Every layer's ``wk`` / ``wv`` kernel and every norm scale of a
    minitron parameter tree."""
    layers = params["layers"]
    return {"wk": torch.stack([p["mixer"]["wk"]["kernel"] for p in layers]),
            "wv": torch.stack([p["mixer"]["wv"]["kernel"] for p in layers]),
            "norms": torch.stack([params["final_norm"]["scale"]]
                                 + [p[n]["scale"] for p in layers for n in ("norm1", "norm2")])}


def card_tp_serve(rank: int, world: int, params) -> dict:
    """The card test's rank: the reduced llama3.2-1b's static ServeSession
    at ``shape.mesh.model=world`` on the card the ranks share (gloo,
    staged hops), from the whole CPU ``params`` moved to the card (None:
    the session's own seeded init on the card), with the kernels' launch
    counts."""
    from repro_torch import kernels
    from repro_torch.api.sessions import ServeSession
    from repro_torch.dist.mesh import make_explicit_mesh
    from repro_torch.optim.optimizers import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_explicit_mesh(1, 1, world, device="cuda")
    kernels.reset_launch_counts()
    out = ServeSession(_spec("serve", SERVE_SETS + [f"shape.mesh.model={world}",
                                                    "numerics.mode=quant_sparse"]),
                       device=mesh.device, mesh=mesh,
                       params=None if params is None
                       else tree_map(lambda p: p.to(mesh.device), params)).run()
    return {"generated": out["generated"].tolist(), "launches": kernels.launch_counts(),
            "report": out["tensor_parallel"], "backend": mesh.backend}
