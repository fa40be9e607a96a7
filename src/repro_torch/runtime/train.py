"""The train steps (port of ``repro/runtime/train.py`` ``make_train_step``,
and of ``examples/sr_accuracy_parity.py``'s CNN ``step``).

One step, in the reference's order:

  key = fold_in(seed, step)
  loss and grads under SpringContext(keys=KeyGen(key))   [LM: summed over
      ``microbatch`` splits, split i under fold_in(key, i)]
  -> clip -> SGDm / AdamW -> [SR fixed-point weights, fold_in(key, 0x5eed)]

PyTorch runs eagerly, so there is no jit: a step is a plain function on a
:class:`TrainState` of tensors.  The LM step updates its state's tensors
in place, as the reference's donated state is; the CNN step is
functional.  The seeds are the
port's 32-bit integers, folded by :func:`repro_torch.kernels.prng.fold_in`
(the reference's threefry keys are not reproduced; its SR draws are held
statistically).

On a mesh (:mod:`repro_torch.dist.mesh`) every rank runs the step:
``grad_sync`` (grads tree -> grads tree) runs between the backward pass
and the optimizer, the seam where ``dist.train`` splices its packed
gradient exchange; ``compress_pod_grads`` gives each pod its
``batch / pod`` rows and averages the pods' gradients over the ``pod``
axis as int8 with error feedback (``state.ef``).  Where the run splits
weights over ``model`` (tensor parallelism, ``models.lm.tensor_parallel``:
a ``model`` extent > 1 at ``data`` 1, the dense family) the state holds
each rank's shards (``runtime.tree_sharding.shard_tree``): the layers
place their collectives, and the optimizer sums the gradient norm over
``model`` and rounds each shard with the whole leaf's SR counters.  Every
other run keeps ``model`` replicated (``DATA_ONLY_RULES``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core.spring_ops import DENSE, KeyGen, SpringConfig
from repro_torch.kernels.prng import fold_in
from repro_torch.memstash.config import MemstashConfig
from repro_torch.models import encdec as ed_mod
from repro_torch.models import lm as lm_mod
from repro_torch.models.cnn import ParamStore
from repro_torch.models.layers import SpringContext
from repro_torch.optim.optimizers import (OptimizerConfig, OptState, make_optimizer,
                                          tree_leaves, tree_map, update_in_place)
from repro_torch.runtime.compression import compressed_allreduce_tree
from repro_torch.runtime.sharding import DATA_ONLY_RULES, sharding_context

#: the optimizer's seed is folded from the step key with this constant
OPT_SEED_FOLD = 0x5EED
#: and the compressed pod exchange's with this one
POD_SEED_FOLD = 0xC0DE


@dataclasses.dataclass(frozen=True)
class StepConfig:
    spring: SpringConfig = DENSE
    # None inherits spring.backward_sparsity; "none" | "auto" override it
    backward_sparsity: Optional[str] = None
    # magnitude pruning of every dense projection's weight as it is used
    # (SpringContext.maybe_prune); CNN convs and fcs are not pruned
    prune_ratio: float = 0.0
    optimizer: OptimizerConfig = OptimizerConfig()
    # int8 + error-feedback gradient reduction across the 'pod' mesh axis
    compress_pod_grads: bool = False
    microbatch: Optional[int] = None  # gradient accumulation splits
    memstash: MemstashConfig = MemstashConfig()
    # the LM's full-sequence attention: "chunked" (the reference's default)
    # or "flash" (flash_attention pinned in kernels.policy)
    attention: str = "chunked"


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: OptState
    step: int
    seed: int
    #: error-feedback buffers of the compressed pod exchange (fp32, shaped
    #: like ``params``), or None
    ef: Optional[dict] = None


#: the reference's backward impl names: a pin of one is "auto" here (the
#: device picks the kernel or its plain version; the train session checks
#: that the device runs what the pin names)
BACKWARD_IMPLS = ("ref", "jnp", "interpret", "pallas")


def _spring_for(step_cfg: StepConfig) -> SpringConfig:
    """The SpringConfig with the step-level backward_sparsity override."""
    bwd = step_cfg.backward_sparsity
    bwd = "auto" if bwd in BACKWARD_IMPLS else bwd
    if bwd in (None, step_cfg.spring.backward_sparsity):
        return step_cfg.spring
    return dataclasses.replace(step_cfg.spring, backward_sparsity=bwd)


def init_train_state(model, step_cfg: StepConfig, seed: int = 0, *, reduced: bool = False,
                     device="cuda") -> TrainState:
    """A fresh state: ``model`` is a parameter tree (kept as given, so the
    LM step trains its tensors in place: a CNN's dict, or an LM's), or an
    arch (``ArchDef`` / ``ResolvedArch``) whose config, reduced with
    ``reduced``, gets ``lm_init(cfg, seed)`` (an encoder-decoder
    ``encdec_init``) parameters on ``device``."""
    if isinstance(model, dict):
        params = model
    else:
        init = ed_mod.encdec_init if model.is_encdec else lm_mod.lm_init
        params = init(model.reduced() if reduced else model.config, seed, device=device)
    opt_init, _ = make_optimizer(step_cfg.optimizer)
    ef = (tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
          if step_cfg.compress_pod_grads else None)
    return TrainState(params, opt_init(params), 0, int(seed), ef)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy (the example's ``loss_fn``)."""
    lf = logits.to(torch.float32)
    gold = torch.gather(lf, 1, labels[:, None])[:, 0]
    return (torch.logsumexp(lf, -1) - gold).mean()


def _with_grad(params):
    return tree_map(lambda p: p.detach().requires_grad_(True), params)


def _loss_for(arch, cfg, params, batch: dict, ctx: SpringContext):
    """The reference's ``_loss_for``: an encoder-decoder's loss reads
    ``batch["frames"]``, an LM's a VLM's ``batch.get("img_embeds")``."""
    if arch.is_encdec:
        return ed_mod.encdec_loss(params, cfg, batch["frames"], batch["tokens"], ctx)
    return lm_mod.lm_loss(params, cfg, batch["tokens"], ctx, batch.get("img_embeds"))


def make_train_step(arch, step_cfg: StepConfig, mesh=None, reduced: bool = False,
                    grad_sync=None):
    """``step(state, batch) -> (state, metrics)`` for an arch (``ArchDef``
    / ``ResolvedArch``): ``batch`` holds ``"tokens"`` (B, S), with an
    encoder-decoder's ``"frames"`` (B, S_enc, d) or a VLM's
    ``"img_embeds"`` (B, P, d).  Metrics: loss, ce (and an LM's aux),
    grad_norm, lr.  The step donates ``state``, as the reference's jitted
    step does: the optimizer writes the new parameters and moments into its
    tensors (``optim.update_in_place``), so the returned state holds them
    and a full-width model's update needs no second copy of its state.

    ``grad_sync`` runs between the backward pass and the optimizer.  With
    ``step_cfg.compress_pod_grads`` the ``mesh`` must have a ``pod`` axis:
    pod rank r takes rows ``[r*B/P, (r+1)*B/P)`` of every batch leaf, and
    the pods' gradients are averaged over ``pod`` as int8 with error
    feedback under seed ``fold_in(key, 0xC0DE)``, the new buffers returned
    in the state's ``ef``.  Where ``models.lm.tensor_parallel(cfg, mesh)``
    holds, the state must hold this rank's shards."""
    if step_cfg.compress_pod_grads:
        assert mesh is not None and "pod" in mesh.shape, "pod axis required for compressed grads"
    cfg = arch.reduced() if reduced else arch.config
    spring = _spring_for(step_cfg)
    # the default rules split the weights over model; the others keep it replicated
    rules = None if lm_mod.tensor_parallel(cfg, mesh) else DATA_ONLY_RULES
    split_tree = None
    if rules is None:
        from repro_torch.runtime.tree_sharding import param_splits

        with sharding_context(mesh):
            split_tree = param_splits(cfg, mesh)

    def ctx_for(key: int) -> SpringContext:
        return SpringContext(cfg=spring, keys=KeyGen(key) if spring.is_quantized else None,
                             prune_ratio=step_cfg.prune_ratio, memstash=step_cfg.memstash,
                             attention=step_cfg.attention)

    def loss_and_grads(params, batch, key):
        p = _with_grad(params)
        loss, metrics = _loss_for(arch, cfg, p, batch, ctx_for(key))
        grads = iter(torch.autograd.grad(loss, tree_leaves(p)))
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_map(lambda _: next(grads), params))

    def grads_and_loss(params, batch, key):
        nm = step_cfg.microbatch
        if nm is None:
            return loss_and_grads(params, batch, key)
        # gradient accumulation over contiguous row splits of every leaf
        splits = {k: v.reshape(nm, v.shape[0] // nm, *v.shape[1:]) for k, v in batch.items()}
        loss = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
        grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        for i in range(nm):
            loss_i, metrics, grads_i = loss_and_grads(
                params, {k: v[i] for k, v in splits.items()}, fold_in(key, i))
            loss = loss + loss_i / nm
            grads = tree_map(lambda a, g: a + g / nm, grads, grads_i)
            del grads_i
        return loss, metrics, grads

    def step(state: TrainState, batch: dict):
        key = fold_in(state.seed, state.step)
        ef = state.ef
        with sharding_context(mesh, rules):
            if step_cfg.compress_pod_grads:
                # this pod's rows: per-pod gradients differ, and the int8 + EF
                # exchange averages them across pods
                pods, r = mesh.shape["pod"], mesh.axis_index("pod")
                batch = {k: v[r * (v.shape[0] // pods):(r + 1) * (v.shape[0] // pods)]
                         for k, v in batch.items()}
            loss, metrics, grads = grads_and_loss(state.params, batch, key)
            if grad_sync is not None:
                grads = grad_sync(grads)
            if step_cfg.compress_pod_grads:
                grads, ef = compressed_allreduce_tree(grads, "pod", fold_in(key, POD_SEED_FOLD),
                                                      state.ef)
            splits = None
            if split_tree is not None:  # in the state's leaf order, which its key order sets
                from repro_torch.runtime.tree_sharding import leaf_splits

                splits = leaf_splits(split_tree, state.params)
            new_p, new_opt, om = update_in_place(step_cfg.optimizer, grads, state.opt_state,
                                                 state.params, fold_in(key, OPT_SEED_FOLD),
                                                 splits, mesh)
        return (TrainState(new_p, new_opt, state.step + 1, state.seed, ef),
                dict(metrics, loss=loss, **om))

    return step


def make_cnn_train_step(model_fn: Callable, step_cfg: StepConfig):
    """``step(state, x, y) -> (state, metrics)`` for ``model_fn(store, ctx,
    x) -> logits`` (a :mod:`repro_torch.models.cnn` model)."""
    spring = _spring_for(step_cfg)
    _, opt_update = make_optimizer(step_cfg.optimizer)

    def step(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        key = fold_in(state.seed, state.step)
        ctx = SpringContext(cfg=spring, keys=KeyGen(key) if spring.is_quantized else None,
                            prune_ratio=step_cfg.prune_ratio, memstash=step_cfg.memstash)
        params = _with_grad(state.params)
        loss = cross_entropy(model_fn(ParamStore(key, params), ctx, x), y)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        new_p, new_opt, om = opt_update(grads, state.opt_state, state.params,
                                        fold_in(key, OPT_SEED_FOLD))
        metrics = dict(om, loss=loss.detach())
        return TrainState(new_p, new_opt, state.step + 1, state.seed), metrics

    return step
