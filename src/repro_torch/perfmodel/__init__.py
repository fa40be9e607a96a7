"""Analytical performance/energy model of SPRING vs GTX 1080 Ti (port of
``repro/perfmodel``)."""

from repro_torch.perfmodel.spring_model import (
    GPU_1080TI,
    SPRING_DESIGN,
    AcceleratorResult,
    evaluate_cnn,
    gpu_eval,
    spring_eval,
)

__all__ = [
    "GPU_1080TI",
    "SPRING_DESIGN",
    "AcceleratorResult",
    "evaluate_cnn",
    "gpu_eval",
    "spring_eval",
]
