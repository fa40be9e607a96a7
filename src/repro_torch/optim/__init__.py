"""Optimizers with SPRING reduced-precision weight updates (port of ``repro/optim``)."""

from repro_torch.optim.optimizers import (
    OptimizerConfig,
    OptState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    make_optimizer,
    sgdm_init,
    sgdm_update,
)

__all__ = ["OptState", "OptimizerConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "make_optimizer", "sgdm_init", "sgdm_update"]
