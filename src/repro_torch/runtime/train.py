"""The CNN train step (port of the CNN path of ``repro/runtime/train.py``
``make_train_step`` and of ``examples/sr_accuracy_parity.py``'s ``step``).

One step, in the reference's order:

  key = fold_in(seed, step)
  loss and grads of the model under SpringContext(keys=KeyGen(key))
  -> clip -> SGDm / AdamW -> [SR fixed-point weights, fold_in(key, 0x5eed)]

PyTorch runs eagerly, so there is no jit and no donated state: the step
is a plain function on a :class:`TrainState` of tensors.  The LM branch of
``make_train_step`` comes with LM training.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core.spring_ops import DENSE, KeyGen, SpringConfig
from repro_torch.kernels.prng import fold_in
from repro_torch.memstash.config import MemstashConfig
from repro_torch.models.cnn import ParamStore
from repro_torch.models.layers import SpringContext
from repro_torch.optim.optimizers import OptimizerConfig, OptState, make_optimizer

#: the optimizer's seed is folded from the step key with this constant
OPT_SEED_FOLD = 0x5EED


@dataclasses.dataclass(frozen=True)
class StepConfig:
    spring: SpringConfig = DENSE
    optimizer: OptimizerConfig = OptimizerConfig()
    memstash: MemstashConfig = MemstashConfig()


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: OptState
    step: int
    seed: int


def init_train_state(params: dict, step_cfg: StepConfig, seed: int = 0) -> TrainState:
    opt_init, _ = make_optimizer(step_cfg.optimizer)
    return TrainState(params, opt_init(params), 0, int(seed))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy (the example's ``loss_fn``)."""
    lf = logits.to(torch.float32)
    gold = torch.gather(lf, 1, labels[:, None])[:, 0]
    return (torch.logsumexp(lf, -1) - gold).mean()


def make_cnn_train_step(model_fn: Callable, step_cfg: StepConfig):
    """``step(state, x, y) -> (state, metrics)`` for ``model_fn(store, ctx,
    x) -> logits`` (a :mod:`repro_torch.models.cnn` model)."""
    spring = step_cfg.spring
    _, opt_update = make_optimizer(step_cfg.optimizer)

    def step(state: TrainState, x: torch.Tensor, y: torch.Tensor):
        key = fold_in(state.seed, state.step)
        ctx = SpringContext(cfg=spring, keys=KeyGen(key) if spring.is_quantized else None,
                            memstash=step_cfg.memstash)
        params = {k: p.detach().requires_grad_(True) for k, p in state.params.items()}
        loss = cross_entropy(model_fn(ParamStore(key, params), ctx, x), y)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        new_p, new_opt, om = opt_update(grads, state.opt_state, state.params,
                                        fold_in(key, OPT_SEED_FOLD))
        metrics = dict(om, loss=loss.detach())
        return TrainState(new_p, new_opt, state.step + 1, state.seed), metrics

    return step
